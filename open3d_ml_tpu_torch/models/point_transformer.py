"""Point Transformer for semantic segmentation: the exact path and the
fused path.

Counterpart of ``open3d_ml_tpu/models/point_transformer.py``: five encoder
stages of a TransitionDown (at stride 4: a quarter of the points, a k-NN
grouping and a max over the neighbours) and Bottleneck blocks around
vector self-attention over each point's k nearest neighbours, then a
decoder of TransitionUp stages (3-NN inverse-distance interpolation and a
skip) and the head. The widths are the JAX net's: planes [32, 64, 128,
256, 512], strides [1, 4, 4, 4, 4], nsample [8, 16, 16, 16, 16],
share_planes 8. Two neighbour paths share one ``state_dict``:

* ``knn_method="exact"`` (the shipped ``pointtransformer_s3dis.yml``'s and
  ``get_eval_net``'s): furthest point sampling, and every Transformer runs
  its own self-search, as in JAX. The JAX net runs one sample at a time
  under ``nn.vmap``; here the net takes the [B, N, .] batch at once, with
  batched searches (one ``knn_exact`` or ``fps`` launch a call for the
  whole batch) and batched gathers. A forward searches once per stage
  past the first (the grouping), once per Bottleneck and once per skip
  TransitionUp (k = 3) (at the shipped blocks [2, 3, 4, 6, 3], 26
  ``knn_exact`` launches, 2 at k = 8, 20 at 16 and 4 at 3, and 4 ``fps``).
* ``knn_method="fused"`` (the JAX package's training path): the batch runs
  in Hilbert order, each level the stride-4 slice of the one above (no
  FPS); one pyramid of bucket tables a forward (``ops/bucket.py``
  ``build_pt_pyramid``: 13 ``bucket_knn`` searches) serves the encoder
  and the decoder, and every neighbour read is a bucket gather
  (``ops/cuda/bucket.py`` ``BucketGather``: 26 a forward at the shipped
  blocks, 18 for attention, 4 groupings, 4 upsamples); the logits come
  back in the caller's order. With ``compute_dtype="bfloat16"`` every
  Linear but ``cls1`` computes in bfloat16, the gathers round the values
  they read to bfloat16 and return float32, as the TPU kernel did, and
  the casts between are the JAX net's.

Each BatchNorm (flax's semantics, ``models/common.py``) reads float32 and
reduces over every axis but the channels, the whole batch on both paths.
The parameter names follow the JAX variable tree (``enc{i}_down``,
``enc{i}_block{b}``, ``dec{i}_up``, ``dec{i}_block1``, ``cls0``,
``cls_bn``, ``cls1``), so ``utils/convert_jax.py`` maps one onto the
other. The "approx" and "window" searches are not ported and raise.
"""

import functools
import logging

import numpy as np
import torch
import torch.nn.functional as F
from scipy.spatial import cKDTree
from torch import nn

from ..datasets.augment import SemsegAugmentation
from ..datasets.utils import DataProcessing
from ..modules.losses import filter_valid_label
from ..modules.schedulers import piecewise_lr
from ..ops.bucket import build_pt_pyramid, pad_seg
from ..ops.cuda.bucket import BucketGather
from ..ops.interpolation import (inverse_distance_weights, three_interpolate,
                                 three_nn)
from ..ops.neighbors import knn_search
from ..ops.sampling import furthest_point_sampling
from ..utils.registry import MODEL
from .base_model import BaseModel
from .common import BatchNorm, dense

log = logging.getLogger(__name__)

PLANES = (32, 64, 128, 256, 512)
STRIDE = (1, 4, 4, 4, 4)
NSAMPLE = (8, 16, 16, 16, 16)
SHARE_PLANES = 8
UP_K = 3  # the fused upsample's neighbours
BN_MOMENTUM = 0.1  # torch's; flax's 0.9
KNN_METHODS = ("exact", "fused")


def _bn(dim):
    return BatchNorm(dim, eps=1e-5, momentum=BN_MOMENTUM)


def _gather(values, idx):
    """values [B, N, C], idx [B, Q, K] -> [B, Q, K, C]."""
    rows = torch.arange(values.shape[0], device=values.device)[:, None, None]
    return values[rows, idx.long()]


def neighbour_max(x):
    """[..., K, C] -> [..., C]: the max over the neighbours."""
    return x.max(dim=-2).values


def queryandgroup(nsample, points, queries, feat, use_xyz=True,
                  method="exact"):
    """The ``nsample`` nearest points of each query, their coordinates
    relative to the query and their features, gathered together.

    points [B, N, 3], queries [B, Q, 3], feat [B, N, C]. Returns
    ([B, Q, nsample, 3 + C], or [B, Q, nsample, C] without ``use_xyz``;
    idx [B, Q, nsample]); nsample is cut to N. Only the exact search is
    ported."""
    if method != "exact":
        raise NotImplementedError(
            f"queryandgroup method={method!r} is not ported; the port runs "
            "'exact'")
    idx, _ = knn_search(points, queries, nsample)
    gathered = _gather(torch.cat([points, feat], -1), idx)
    if use_xyz:
        rel = gathered[..., :3] - queries[..., None, :]
        return torch.cat([rel, gathered[..., 3:]], -1), idx
    return gathered[..., 3:], idx


class _PTLevels:
    """The fused path's neighbour reads over one ``build_pt_pyramid``
    result: ``attn(i, v)`` reads each level-i point's attention
    neighbours, ``down(i, v)`` each level-(i + 1) point's grouping
    neighbours in level i, ``up(i, v)`` each level-i point's ``UP_K``
    nearest level-(i + 1) points, each a bucket gather of the rows of
    ``v`` [B, N, C]: [B, Q, K, C], float32 (float64 for float64 values,
    a CPU reference), rounded to bfloat16 with ``round_bf16``. ``coords``
    are the levels' points in ``dtype``."""

    def __init__(self, pyr, seg, round_bf16, dtype):
        self.pyr = pyr
        self.seg = seg
        self.round_bf16 = round_bf16
        self.coords = [c.to(dtype) for c in pyr["coords"]]

    def _gather(self, name, i, v):
        values = v if v.dtype == torch.float64 else v.float()
        p = self.pyr
        return BucketGather.apply(
            pad_seg(values, self.seg).contiguous(), p[f"{name}_seg_ids"][i],
            p[f"{name}_rel"][i], self.seg, p[f"{name}_qblock"][i],
            self.round_bf16)

    def attn(self, i, v):
        return self._gather("nbr", i, v)

    def down(self, i, v):
        return self._gather("pool", i, v)

    def up(self, i, v):
        return self._gather("up", i, v)


class Transformer(nn.Module):
    """Vector self-attention over each point's ``nsample`` nearest
    neighbours: positional MLP (Linear 3 -> 3, BN, ReLU, Linear 3 -> C),
    weight MLP (BN, ReLU, Linear C -> C / s, BN, ReLU, Linear), softmax
    over the neighbours, and the sum over them of (v + position) times
    the weights shared by s planes. Its Linears compute in ``dtype``
    (None: float32)."""

    def __init__(self, planes, share_planes=SHARE_PLANES, nsample=16,
                 dtype=None):
        super().__init__()
        c, cs = planes, planes // share_planes
        self.share_planes = share_planes
        self.nsample = nsample
        self.dtype = dtype
        self.linear_q = nn.Linear(c, c)
        self.linear_k = nn.Linear(c, c)
        self.linear_v = nn.Linear(c, c)
        self.linear_p0 = nn.Linear(3, 3)
        self.linear_p_bn = _bn(3)
        self.linear_p1 = nn.Linear(3, c)
        self.linear_w_bn0 = _bn(c)
        self.linear_w0 = nn.Linear(c, cs)
        self.linear_w_bn1 = _bn(cs)
        self.linear_w1 = nn.Linear(cs, cs)

    def forward(self, point, feat, gather=None):
        """``gather`` (the fused path): [B, N, C] -> [B, N, K, C] rows of
        each point's neighbours, read from the pyramid; without it the
        neighbours are searched."""
        c, s, dt = feat.shape[-1], self.share_planes, self.dtype
        feat_q = dense(self.linear_q, feat, dt)
        kv = torch.cat([dense(self.linear_k, feat, dt),
                        dense(self.linear_v, feat, dt)], -1)
        if gather is not None:
            # the coordinates in kv's type, read together with k and v
            g = gather(torch.cat([point.to(kv.dtype), kv], -1))
            point_r = (g[..., :3].float() - point[..., None, :]).to(kv.dtype)
        else:
            g, _ = queryandgroup(self.nsample, point, point, kv)
            point_r = g[..., :3]
        feat_k, feat_v = g[..., 3:3 + c], g[..., 3 + c:]

        point_r = dense(self.linear_p1, F.relu(self.linear_p_bn(
            dense(self.linear_p0, point_r, dt))), dt)
        w = feat_k - feat_q[..., None, :] + point_r
        w = dense(self.linear_w0, F.relu(self.linear_w_bn0(w)), dt)
        w = dense(self.linear_w1, F.relu(self.linear_w_bn1(w)), dt)
        w = torch.softmax(w, dim=-2)  # over the neighbours
        x = (feat_v + point_r).unflatten(-1, (s, c // s))
        out = (x * w[..., None, :]).sum(-3)
        return out.flatten(-2)


class TransitionDown(nn.Module):
    """Stride 1: Linear (no bias), BN, ReLU. Stride > 1: N // stride
    points (FPS, or on the fused path the pyramid's next level), their
    ``nsample`` nearest points grouped (relative coordinates and
    features), Linear (no bias), BN, ReLU, and the max over the
    neighbours."""

    def __init__(self, in_planes, out_planes, stride=1, nsample=16,
                 dtype=None):
        super().__init__()
        self.stride, self.nsample, self.dtype = stride, nsample, dtype
        self.linear = nn.Linear(in_planes + (3 if stride != 1 else 0),
                                out_planes, bias=False)
        self.bn = _bn(out_planes)

    def forward(self, point, feat, down=None, sub_coords=None):
        """``down`` and ``sub_coords`` (the fused path): the grouping
        read, [B, N, C] -> [B, M, K, C], and the M points it groups
        around."""
        if self.stride == 1:
            return point, F.relu(self.bn(dense(self.linear, feat,
                                               self.dtype)))
        if down is not None:
            new_point = sub_coords
            g = down(torch.cat([point.to(feat.dtype), feat], -1))
            rel = (g[..., :3].float() -
                   new_point[..., None, :]).to(feat.dtype)
            grouped = torch.cat([rel, g[..., 3:]], -1)
        else:
            m = point.shape[1] // self.stride
            idx = furthest_point_sampling(point, m)
            new_point = _gather(point, idx[..., None])[..., 0, :]
            grouped, _ = queryandgroup(self.nsample, point, new_point, feat)
        x = F.relu(self.bn(dense(self.linear, grouped, self.dtype)))
        return new_point, neighbour_max(x)


class TransitionUp(nn.Module):
    """The head form (``out_planes`` None): the cloud's mean feature through
    Linear and ReLU, concatenated to every point's, Linear, BN, ReLU. The
    skip form: the fine level's features through Linear, BN, ReLU, plus
    the coarse level's (Linear, BN, ReLU) interpolated from each fine
    point's 3 nearest coarse points by inverse distance."""

    def __init__(self, in_planes, out_planes=None, dtype=None):
        super().__init__()
        self.head = out_planes is None
        self.dtype = dtype
        if self.head:
            self.linear2 = nn.Linear(in_planes, in_planes)
            self.linear1 = nn.Linear(2 * in_planes, in_planes)
            self.bn1 = _bn(in_planes)
        else:
            self.linear1 = nn.Linear(out_planes, out_planes)
            self.bn1 = _bn(out_planes)
            self.linear2 = nn.Linear(in_planes, out_planes)
            self.bn2 = _bn(out_planes)

    def forward(self, pxo1, pxo2=None, up=None):
        """``up`` (the fused path): [B, N2, C] -> [B, N1, 3, C] rows of
        each fine point's 3 nearest coarse points, read from the pyramid;
        the weights come from the distances to the coordinates read with
        them."""
        dt = self.dtype
        if self.head:
            _, feat = pxo1
            g = F.relu(dense(self.linear2, feat.mean(dim=-2, keepdim=True),
                             dt))
            feat = torch.cat([feat, g.expand(*feat.shape[:-1], g.shape[-1])],
                             -1)
            return F.relu(self.bn1(dense(self.linear1, feat, dt)))
        point_1, feat_1 = pxo1
        point_2, feat_2 = pxo2
        x1 = F.relu(self.bn1(dense(self.linear1, feat_1, dt)))
        x2 = F.relu(self.bn2(dense(self.linear2, feat_2, dt)))
        if up is not None:
            g = up(torch.cat([point_2.to(x2.dtype), x2], -1))
            d = torch.sqrt(((g[..., :3].float() - point_1[..., None, :]) ** 2)
                           .sum(-1) + 1e-12)
            w = inverse_distance_weights(d)
            return x1 + (g[..., 3:] * w[..., None].to(x2.dtype)).sum(-2)
        dist, idx = three_nn(point_1, point_2)
        return x1 + three_interpolate(x2, idx, inverse_distance_weights(dist))


class Bottleneck(nn.Module):
    """Linear (no bias), BN, ReLU, Transformer, BN, ReLU, Linear (no bias),
    BN, and ReLU of the sum with the input."""

    def __init__(self, planes, share_planes=SHARE_PLANES, nsample=16,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.linear1 = nn.Linear(planes, planes, bias=False)
        self.bn1 = _bn(planes)
        self.transformer2 = Transformer(planes, share_planes, nsample, dtype)
        self.bn2 = _bn(planes)
        self.linear3 = nn.Linear(planes, planes, bias=False)
        self.bn3 = _bn(planes)

    def forward(self, point, feat, gather=None):
        dt = self.dtype
        x = F.relu(self.bn1(dense(self.linear1, feat, dt)))
        x = F.relu(self.bn2(self.transformer2(point, x, gather=gather)))
        x = self.bn3(dense(self.linear3, x, dt))
        return F.relu(x + feat)


class PointTransformerNet(nn.Module):
    """The network: ``forward({"point": [B, N, 3], "feat": [B, N,
    in_channels - 3]})`` -> logits [B, N, num_classes] (with
    ``in_channels`` 3 the features are the coordinates). ``seg``,
    ``block``, ``num_segs``, ``gather_segs`` and ``compute_dtype`` shape
    the fused path (``build_pt_pyramid``'s seg, qblock, num_segs and
    gather_segs)."""

    def __init__(self, blocks, in_channels, num_classes, knn_method="exact",
                 seg=64, block=128, num_segs=64, gather_segs=32,
                 compute_dtype="bfloat16"):
        super().__init__()
        if knn_method not in KNN_METHODS:
            raise NotImplementedError(
                f"PointTransformer knn_method={knn_method!r} is not ported; "
                f"the port runs {KNN_METHODS}")
        self.knn_method = knn_method
        self.blocks = tuple(blocks)
        self.in_channels = in_channels
        self.seg, self.block = seg, block
        self.num_segs, self.gather_segs = num_segs, gather_segs
        fused = knn_method == "fused"
        self.cdt = (torch.bfloat16 if fused and compute_dtype == "bfloat16"
                    else None)
        dt = self.cdt
        width = in_channels
        for i in range(5):
            self.add_module(f"enc{i}_down", TransitionDown(
                width, PLANES[i], STRIDE[i], NSAMPLE[i], dt))
            for b in range(1, self.blocks[i]):
                self.add_module(f"enc{i}_block{b}", Bottleneck(
                    PLANES[i], SHARE_PLANES, NSAMPLE[i], dt))
            width = PLANES[i]
        for i in range(4, -1, -1):
            up = (TransitionUp(PLANES[i], dtype=dt) if i == 4 else
                  TransitionUp(PLANES[i + 1], PLANES[i], dt))
            self.add_module(f"dec{i}_up", up)
            self.add_module(f"dec{i}_block1", Bottleneck(
                PLANES[i], SHARE_PLANES, NSAMPLE[i], dt))
        self.cls0 = nn.Linear(PLANES[0], PLANES[0])
        self.cls_bn = _bn(PLANES[0])
        self.cls1 = nn.Linear(PLANES[0], num_classes)

    def forward(self, inputs):
        point, feat = inputs["point"], inputs.get("feat")
        lv = perm = None
        if self.knn_method == "fused":
            pyr = build_pt_pyramid(
                point.float(), NSAMPLE, STRIDE[1:], seg=self.seg,
                qblock=self.block, num_segs=self.num_segs,
                gather_segs=self.gather_segs, up_k=UP_K)
            lv = _PTLevels(pyr, self.seg, self.cdt == torch.bfloat16,
                           point.dtype)
            perm = pyr["perm"].long()
            # the batch in Hilbert order; the logits go back at the end
            point = lv.coords[0]
            if self.in_channels != 3:
                feat = torch.gather(feat, 1, perm[..., None].expand(
                    -1, -1, feat.shape[-1]))
        feat = point if self.in_channels == 3 else torch.cat([point, feat],
                                                             -1)
        points, feats = [point], [feat]
        for i in range(5):
            kw = ({} if lv is None or STRIDE[i] == 1 else
                  {"down": functools.partial(lv.down, i - 1),
                   "sub_coords": lv.coords[i]})
            p, f = getattr(self, f"enc{i}_down")(points[-1], feats[-1], **kw)
            gk = {} if lv is None else {"gather": functools.partial(lv.attn,
                                                                    i)}
            for b in range(1, self.blocks[i]):
                f = getattr(self, f"enc{i}_block{b}")(p, f, **gk)
            points.append(p)
            feats.append(f)
        for i in range(4, -1, -1):
            if i == 4:
                f = self.dec4_up((points[5], feats[5]))
            else:
                uk = {} if lv is None else {"up": functools.partial(lv.up,
                                                                    i)}
                f = getattr(self, f"dec{i}_up")((points[i + 1], feats[i + 1]),
                                                (points[i + 2], feats[i + 2]),
                                                **uk)
            gk = {} if lv is None else {"gather": functools.partial(lv.attn,
                                                                    i)}
            feats[i + 1] = getattr(self, f"dec{i}_block1")(points[i + 1], f,
                                                          **gk)
        x = F.relu(self.cls_bn(dense(self.cls0, feats[1], self.cdt)))
        scores = self.cls1(x)
        if perm is not None:
            # back to the caller's order: the inverse permutation, a
            # scatter of positions
            inv = torch.empty_like(perm).scatter_(
                1, perm, torch.arange(perm.shape[1], device=perm.device)
                .expand_as(perm).contiguous())
            scores = torch.gather(scores, 1, inv[..., None].expand(
                -1, -1, scores.shape[-1]))
        return scores


@MODEL.register_module()
class PointTransformer(BaseModel):
    """PointTransformer model: configuration, the network and the host
    side (``preprocess``, ``transform``, ``get_loss``, ``get_optimizer``,
    ``update_probs``).

    The defaults are the JAX class's; ``pointtransformer_s3dis.yml`` sets
    blocks [2, 3, 4, 6, 3] and max_voxels 50,000 and names no
    ``knn_method`` (so "exact"); ``knn_method: fused`` takes the fused
    path, shaped by ``seg``, ``block``, ``num_segs``, ``gather_segs`` and
    ``compute_dtype``.
    """

    # ``transform`` crops the cloud itself and never advances the sampler's
    # possibility map, so the pipeline's test and inference loop would
    # never end (in the JAX package too)
    draws_patches = False
    patch_loop_queue = "ROADMAP queue 1 item 4, PointTransformer"

    def __init__(self,
                 name="PointTransformer",
                 blocks=[2, 2, 2, 2, 2],
                 in_channels=6,
                 num_classes=13,
                 voxel_size=0.04,
                 max_voxels=80000,
                 num_points=16384,
                 ignored_label_inds=[],
                 batcher="DefaultBatcher",
                 augment=None,
                 knn_method="exact",
                 seg=64,
                 block=128,
                 num_segs=64,
                 gather_segs=32,
                 compute_dtype="bfloat16",
                 **kwargs):
        super().__init__(name=name, blocks=blocks, in_channels=in_channels,
                         num_classes=num_classes, voxel_size=voxel_size,
                         max_voxels=max_voxels, num_points=num_points,
                         ignored_label_inds=ignored_label_inds,
                         batcher=batcher, augment=augment,
                         knn_method=knn_method, seg=seg, block=block,
                         num_segs=num_segs, gather_segs=gather_segs,
                         compute_dtype=compute_dtype, **kwargs)
        self.augmenter = SemsegAugmentation(self.cfg.augment, seed=self.rng)

    def get_net(self, knn_method=None):
        """The network (``PointTransformerNet``); ``knn_method`` overrides
        the configuration's."""
        cfg = self.cfg
        return PointTransformerNet(
            blocks=tuple(cfg.blocks), in_channels=cfg.in_channels,
            num_classes=cfg.num_classes,
            knn_method=knn_method or cfg.get("knn_method", "exact"),
            seg=cfg.get("seg", 64), block=cfg.get("block", 128),
            num_segs=cfg.get("num_segs", 64),
            gather_segs=cfg.get("gather_segs", 32),
            compute_dtype=cfg.get("compute_dtype", "bfloat16"))

    def get_eval_net(self):
        """The exact-path net unless ``eval_knn_method`` names another
        ("fused", with a warning; any other is not ported and raises); the
        same ``state_dict`` as ``get_net``."""
        method = self.cfg.get("eval_knn_method", None) or "exact"
        if method != "exact":
            log.warning("PointTransformer evaluation uses APPROXIMATE "
                        "neighbors (eval_knn_method=%s); reported accuracy "
                        "is not the exact-path accuracy.", method)
        return self.get_net(knn_method=method)

    def preprocess(self, data, attr):
        """Grid-subsample at ``voxel_size`` (from the cloud's minimum),
        build the KD-tree, and for a test split each input point's nearest
        kept point (``proj_inds``)."""
        cfg = self.cfg
        points = np.array(data["point"], dtype=np.float32)
        labels = (np.zeros((points.shape[0],), np.int32)
                  if data.get("label") is None else
                  np.array(data["label"], np.int32).reshape(-1))
        feat = None if data.get("feat") is None else \
            np.array(data["feat"], np.float32)
        if cfg.voxel_size:
            points = points - points.min(0)
            if feat is None:
                sub_points, sub_labels = DataProcessing.grid_subsampling(
                    points, labels=labels, grid_size=cfg.voxel_size)
                sub_feat = None
            else:
                sub_points, sub_feat, sub_labels = \
                    DataProcessing.grid_subsampling(
                        points, features=feat, labels=labels,
                        grid_size=cfg.voxel_size)
        else:
            sub_points, sub_feat, sub_labels = points, feat, labels
        search_tree = cKDTree(sub_points)
        out = {"point": sub_points, "feat": sub_feat, "label": sub_labels,
               "search_tree": search_tree}
        if attr["split"] in ("test", "testing"):
            _, proj = search_tree.query(points, k=1)
            out["proj_inds"] = np.asarray(proj, np.int32).reshape(-1)
        return out

    def transform(self, data, attr, rng=None):
        """Augment (the training split only), then crop the ``num_points``
        nearest points around a seed point (random on the training split,
        the middle index otherwise) in shuffled order, or pad by repeating
        random points; recentre on the box centre and scale the colours
        by 1 / 255. Every draw comes from ``rng`` (the model's by
        default), in the JAX package's order."""
        cfg = self.cfg
        rng = rng or self.rng
        points = np.asarray(data["point"], np.float32).copy()
        feat = None if data["feat"] is None else \
            np.asarray(data["feat"], np.float32).copy()
        labels = np.asarray(data["label"], np.int32).copy()

        if attr["split"] in ("training", "train"):
            points, feat, labels = self.augmenter.augment(
                points, feat, labels, dict(cfg.get("augment") or {}),
                seed=rng)

        n_target = cfg.num_points
        n = points.shape[0]
        if n > n_target:
            init_idx = int(rng.integers(n)) if "train" in attr["split"] \
                else n // 2
            d2 = np.sum(np.square(points - points[init_idx]), 1)
            sel = np.argsort(d2)[:n_target]
            rng.shuffle(sel)
        else:
            pad = rng.choice(n, n_target - n) if n_target > n else \
                np.empty((0,), np.int64)
            sel = np.concatenate([np.arange(n), pad])
        points = points[sel]
        labels = labels[sel]
        if feat is not None:
            feat = feat[sel]

        pmin, pmax = points.min(0), points.max(0)
        points = points - (pmin + pmax) / 2.0
        return {
            "point": points.astype(np.float32),
            "label": labels.astype(np.int32),
            "point_inds": np.asarray(sel, np.int32),
            "feat": ((feat / 255.0).astype(np.float32) if feat is not None
                     else np.zeros((n_target, 0), np.float32)),
        }

    def get_loss(self, loss, results, inputs):
        """(loss, remapped labels [B * N], scores [B * N, num_classes]) of
        logits ``results`` [B, N, num_classes] against the raw labels
        ``inputs["label"]`` [B, N]; ``loss`` is a ``SemSegLoss``."""
        cfg = self.cfg
        labels = inputs["label"].reshape(-1)
        scores = results.reshape(-1, cfg.num_classes)
        remapped, valid = filter_valid_label(scores, labels, cfg.num_classes,
                                             cfg.ignored_label_inds)
        return (loss.weighted_cross_entropy(scores, remapped, valid),
                remapped, scores)

    def get_optimizer(self, cfg_pipeline, net):
        """(SGD over ``net``'s parameters, its learning-rate scheduler), as
        the JAX package's ``optax.sgd``: the rate ``optimizer.lr`` (else
        0.5), momentum ``optimizer.momentum`` (else 0.9), no dampening, no
        Nesterov, and no weight decay (the JAX package reads no
        ``optimizer.weight_decay``); ``optimizer.name: adam`` takes
        ``optax.adam``'s Adam (0.9, 0.999, eps 1e-8) instead. Either under
        ``piecewise_lr``: the rate falls 10x from update
        int(0.6 * max_epoch) * steps_per_epoch on and again from
        int(0.8 * max_epoch) * steps_per_epoch; ``steps_per_epoch`` is the
        pipeline's (``run_train`` sets it), else 1. Step the scheduler
        after every optimizer step."""
        opt = dict(cfg_pipeline.get("optimizer") or {})
        lr = opt.get("lr", 0.5)
        max_epoch = cfg_pipeline.get("max_epoch", 100)
        steps = cfg_pipeline.get("steps_per_epoch", 1)
        boundaries = {int(max_epoch * 0.6) * steps: 0.1,
                      int(max_epoch * 0.8) * steps: 0.1}
        if opt.get("name", "sgd").lower() == "adam":
            optimizer = torch.optim.Adam(net.parameters(), lr=lr,
                                         betas=(0.9, 0.999), eps=1e-8)
        else:
            optimizer = torch.optim.SGD(net.parameters(), lr=lr,
                                        momentum=opt.get("momentum", 0.9))
        return optimizer, piecewise_lr(optimizer, boundaries)

    def update_probs(self, inputs, results, test_probs):
        """Write each sample's class probabilities (softmax of its logits)
        into the cloud's ``test_probs`` [N, num_classes] at its points."""
        results = np.asarray(results, np.float32)
        for b in range(results.shape[0]):
            logits = results[b].reshape(-1, self.cfg.num_classes)
            exp = np.exp(logits - logits.max(axis=-1, keepdims=True))
            inds = np.asarray(inputs["point_inds"][b])
            test_probs[inds] = exp / exp.sum(axis=-1, keepdims=True)
        return test_probs

