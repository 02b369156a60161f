"""PointNet++ set abstraction and feature propagation.

Counterpart of ``open3d_ml_tpu/models/pointnet2.py``: ``SharedMLP2d``,
``PointnetSAModuleMSG`` (multi-scale grouping, and group-all),
``PointnetSAModule`` and ``PointnetFPModule``, and the ``Pointnet2MSG``
backbone. The JAX modules take one sample and are vmapped by their
callers; these take the whole batch [B, ...] at once: one ``fps`` launch
a set abstraction, one ``knn_exact`` launch a scale's ball query
(``ops/neighbors.py`` ``ball_query``: the nearest k, masked to the
radius) and one a feature propagation's 3-NN. Module and parameter names
follow the flax scopes (``sa{i}``, ``mlp{i}``, ``fp{j}``, ``conv{i}``,
``bn{i}``), so ``utils/convert_jax.py`` maps the JAX variables one to
one. BatchNorm is flax's (``common.BatchNorm``, eps 1e-5, flax momentum
0.9), over every row of the batch.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolation import (inverse_distance_weights,
                                 three_interpolate, three_nn)
from ..ops.neighbors import ball_query
from ..ops.sampling import furthest_point_sampling
from ..utils.registry import MODEL
from .common import BatchNorm


def gather_rows(data, idx):
    """data [B, N, C], idx [B, ...] -> [B, ..., C]: data[b, idx[b, ...]]."""
    b = data.shape[0]
    flat = idx.reshape(b, -1).long()
    out = torch.gather(data, 1, flat[..., None].expand(-1, -1,
                                                       data.shape[-1]))
    return out.reshape(*idx.shape, data.shape[-1])


class SharedMLP2d(nn.Module):
    """Linear (``conv{i}``, biased only without BatchNorm), BatchNorm
    (``bn{i}``) and ReLU over the channels of [..., C] tensors, each
    layer followed by dropout where ``dropout`` > 0 (PointRCNN's
    heads)."""

    def __init__(self, in_channels, channels, bn=True, dropout=0.0):
        super().__init__()
        self.bn = bn
        self.depth = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"conv{i}", nn.Linear(in_channels, c,
                                                  bias=not bn))
            if bn:
                self.add_module(f"bn{i}", BatchNorm(c, eps=1e-5,
                                                    momentum=0.1))
            in_channels = c
        self.out_channels = in_channels
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
            if self.bn:
                x = getattr(self, f"bn{i}")(x)
            x = F.relu(x)
            if self.dropout is not None:
                x = self.dropout(x)
        return x


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction over a batch.

    ``npoint`` None or -1 groups all points around the origin (a global
    feature); else ``npoint`` centres by furthest point sampling, and for
    each scale the ball query's ``nsample`` neighbours within its radius,
    their offsets to the centre (and features) through the scale's MLP
    (``mlp{i}``), the rows outside the radius at -1e9, and the max over
    the neighbours. ``mlps``: each scale's output channels;
    ``in_channels``: the features' width (0 for none).
    """

    def __init__(self, npoint, radii, nsamples, mlps, in_channels=0,
                 use_xyz=True):
        super().__init__()
        self.npoint = npoint
        self.group_all = npoint is None or npoint == -1
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        width = in_channels + (3 if use_xyz else 0)
        for i, spec in enumerate(mlps):
            self.add_module(f"mlp{i}", SharedMLP2d(width, tuple(spec)))
        self.out_channels = sum(spec[-1] for spec in mlps)

    def forward(self, xyz, features=None):
        """xyz [B, N, 3], features [B, N, C] or None -> (new_xyz [B, M, 3],
        new_features [B, M, sum of the scales' widths])."""
        b = xyz.shape[0]
        if self.group_all:
            new_xyz = xyz.new_zeros((b, 1, 3))
        else:
            idx = furthest_point_sampling(xyz, self.npoint)
            new_xyz = gather_rows(xyz, idx)
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radii,
                                                  self.nsamples)):
            if self.group_all:
                grouped_xyz = xyz[:, None] - new_xyz[:, :, None]
                grouped_feat = (None if features is None else
                                features[:, None])
                mask = None
            else:
                nidx, mask = ball_query(xyz, new_xyz, radius, nsample)
                # one gather of coordinates and features together
                if features is not None:
                    g = gather_rows(torch.cat([xyz, features], dim=-1),
                                    nidx)
                    grouped_xyz = g[..., :3] - new_xyz[:, :, None]
                    grouped_feat = g[..., 3:]
                else:
                    grouped_xyz = gather_rows(xyz, nidx) - \
                        new_xyz[:, :, None]
                    grouped_feat = None
            if not self.use_xyz:
                feats = grouped_feat
            elif grouped_feat is None:
                feats = grouped_xyz
            else:
                feats = torch.cat([grouped_xyz, grouped_feat], dim=-1)
            feats = getattr(self, f"mlp{i}")(feats)
            if mask is not None:
                feats = torch.where(mask[..., None], feats, -1e9)
            outs.append(feats.max(dim=2).values)
        return new_xyz, torch.cat(outs, dim=-1)


class PointnetSAModule(PointnetSAModuleMSG):
    """Single-scale set abstraction."""

    def __init__(self, mlp, npoint=None, radius=None, nsample=None,
                 in_channels=0, use_xyz=True):
        super().__init__(npoint=npoint, radii=(radius,), nsamples=(nsample,),
                         mlps=(tuple(mlp),), in_channels=in_channels,
                         use_xyz=use_xyz)


class PointnetFPModule(nn.Module):
    """Feature propagation: the inverse-distance-weighted features of the
    3 nearest known points, the unknown points' own features after them,
    through the MLP (``mlp``)."""

    def __init__(self, mlp, in_channels):
        super().__init__()
        self.mlp = SharedMLP2d(in_channels, tuple(mlp))

    def forward(self, unknown, known, unknown_feats, known_feats):
        """unknown [B, n, 3], known [B, m, 3] or None, unknown_feats
        [B, n, C1] or None, known_feats [B, m, C2] -> [B, n, mlp[-1]]."""
        if known is not None:
            dist, idx = three_nn(unknown, known)
            interp = three_interpolate(known_feats, idx,
                                       inverse_distance_weights(dist))
        else:
            interp = known_feats.expand(-1, unknown.shape[1], -1)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


@MODEL.register_module()
class Pointnet2MSG(nn.Module):
    """PointNet++ MSG backbone: set abstraction levels, then feature
    propagation back to the input points."""

    def __init__(self, in_channels=6, use_xyz=True, sa_npoints=(128, 32, -1),
                 sa_radii=((0.2,), (0.4,), (100,)),
                 sa_nsamples=((64,), (64,), (64,)),
                 sa_mlps=(((128, 128, 128),), ((128, 128, 256),),
                          ((256, 256, 512),)),
                 fp_mlps=()):
        super().__init__()
        self.in_channels = in_channels
        self.levels = len(sa_npoints)
        widths = [in_channels]
        for i in range(self.levels):
            sa = PointnetSAModuleMSG(
                npoint=sa_npoints[i], radii=tuple(sa_radii[i]),
                nsamples=tuple(sa_nsamples[i]), mlps=tuple(sa_mlps[i]),
                in_channels=widths[-1], use_xyz=use_xyz)
            self.add_module(f"sa{i}", sa)
            widths.append(sa.out_channels)
        # FP module j propagates level j + 1 to level j, the deepest first
        self.fp_levels = len(fp_mlps)
        above = widths[-1]
        for j in reversed(range(self.fp_levels)):
            self.add_module(f"fp{j}", PointnetFPModule(
                fp_mlps[j], above + widths[j + self.levels - self.fp_levels]))
            above = fp_mlps[j][-1]

    def forward(self, pointcloud):
        """pointcloud [B, N, 3 + C] -> (xyz [B, N, 3], features [B, N,
        C_out])."""
        xyz = pointcloud[..., 0:3].contiguous()
        features = (pointcloud[..., 3:].contiguous()
                    if pointcloud.shape[-1] > 3 else None)
        l_xyz, l_features = [xyz], [features]
        for i in range(self.levels):
            li_xyz, li_feat = getattr(self, f"sa{i}")(l_xyz[-1],
                                                      l_features[-1])
            l_xyz.append(li_xyz)
            l_features.append(li_feat)
        for j in reversed(range(self.fp_levels)):
            lvl = j + 1 + self.levels - self.fp_levels
            l_features[lvl - 1] = getattr(self, f"fp{j}")(
                l_xyz[lvl - 1], l_xyz[lvl], l_features[lvl - 1],
                l_features[lvl])
        return l_xyz[0], l_features[0]
