"""PointPillars 3D object detection: serving, evaluation and training.

Counterpart of ``open3d_ml_tpu/models/point_pillars.py``: the same network
(pillarization, the pillar feature net, the BEV canvas, the SECOND
backbone, the SECONDFPN neck and the anchor head's three convolutions),
the same decode and NMS, the anchor assignment and the three losses, and
the host side of every split. Two nets share one ``state_dict``:

* ``get_net()``, the serving net: canvas-major pillarization (the canvas
  cell is the segment id, and the PFN's segment max writes the BEV canvas
  directly); the PFN's linear and BatchNorm in float32, its pillar max
  over their output cast to ``compute_dtype`` (bf16 by default), so that
  ties split the gradient as the JAX net's bf16 segment max splits it,
  and the pooled canvas in that dtype; the backbone's and the neck's
  convolutions take bf16 inputs and weights, and each of their BatchNorms
  runs in float32 on the convolution's bf16 output, as flax promotes it;
  the head's convolutions in float32. These are explicit casts. It is
  the training net too (``train()``): its BatchNorms then take flax's
  batch statistics (``common.BatchNorm``; the PFN's over every point row
  of the batch, masked ones and the pad row included, the backbone's
  over every canvas cell, empty ones included).
* ``get_eval_net()``, the evaluation net: compact pillars from the sort
  voxelizer, with the reference's caps (``max_voxels``, and
  ``max_num_points`` points a pillar, the first in input order), in
  float32 throughout.

The net keeps the JAX net's NHWC layout at its ends: the canvas is
[B, ny, nx, C] and the head's outputs [B, H, W, A * x], so the decode
reads them cell-major, then anchor (size, then rotation), then class, as
the JAX decode does. In between it runs contiguous NCHW; whether
``channels_last`` would serve faster on the card is not settled.

Training: ``assign_bboxes`` matches anchors to gt boxes on the device for
a whole batch, ``get_loss`` gives the focal, smooth-L1 and direction
losses, ``get_optimizer`` AdamW (no gradient clipping: the JAX pipeline
never reads ``grad_clip_norm``), and ``preprocess`` of the train split
runs ``ObjdetAugmentation`` (ObjectSample with its gt database,
ObjectRangeFilter, PointShuffle) after the range filter.

Of the five shipped configs, two fail where the JAX package fails, and
the port's error names the fault (``NECK_FAULT``, ``COLUMNS_FAULT``):
``pointpillars_waymo.yml``'s canvas gives neck maps of different sizes,
and the Argoverse reader's frames have 3 columns where ``transform``
takes 4.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..datasets.augment import ObjdetAugmentation
from ..datasets.utils import BEVBox3D
from ..modules.losses import CrossEntropyLoss, FocalLoss, SmoothL1Loss
from ..ops.bev import bev_scatter
from ..ops.nms import nms_bev
from ..ops.voxelize import voxelize
from ..parallel.mesh import global_sum
from ..utils.registry import MODEL
from .base_model_objdet import ObjdetBaseModel
from .common import BatchNorm
from .objdet_helper import (Anchor3DRangeGenerator, BBoxCoder, bbox_overlaps,
                            box3d_to_bev, box3d_to_bev2d, limit_period)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Two shipped configs that the JAX package cannot run either; the port
# fails where it fails, and names the fault
NECK_FAULT = (
    "ROADMAP.md queue 3, 'The Waymo PointPillars net cannot join its "
    "neck': a canvas side that the backbone's strides do not divide "
    "(pointpillars_waymo.yml's 468: stages of 234, 117 and 59) gives neck "
    "maps of different sizes (234, 234, 236), whose concatenation fails "
    "(open3d_ml_tpu/models/point_pillars.py:263, in JAX too)")
COLUMNS_FAULT = (
    "ROADMAP.md queue 3, 'Argoverse frames have 3 columns, PointPillars "
    "takes 4': the Argoverse reader gives x, y, z only, and transform's "
    "copy into the [max_points, 4] points fails "
    "(open3d_ml_tpu/models/point_pillars.py:546, in JAX too)")


def segment_max(y, seg_ids, num_segments):
    """[num_segments, C]: the max of the rows of ``y`` [N, C] in each
    segment (-inf where there is none); ``seg_ids`` [N] in [0,
    num_segments]; ids of num_segments are dropped. A tie splits the
    gradient evenly, as JAX's ``segment_max`` does."""
    index = seg_ids.long()[:, None].expand(-1, y.shape[1])
    vmax = y.new_full((num_segments + 1, y.shape[1]), -np.inf)
    vmax.scatter_reduce_(0, index, y, "amax", include_self=False)
    return vmax[:num_segments]


class PFNLayer(nn.Module):
    """Linear, BatchNorm and ReLU, then the max over each pillar's points.

    Two modes over the same parameters:

    * voxel-major: ``x [V, P, C]`` and ``mask [V, P]``, the reference's
      dense layout;
    * point-major: ``x [N, C]`` and ``seg_ids [N]``; the pillar max is a
      segment max over the points (a scatter max).

    The reference maxes over every row of a pillar's [P] buffer, zero pads
    included, each pad worth relu(BN(linear(0))) = relu(BN(0)). The
    point-major mode folds that pad value into every pillar with fewer
    than ``max_pts`` points, and sets empty pillars to 0.
    """

    def __init__(self, in_channels, out_channels, last_layer=True,
                 pool_dtype="float32"):
        super().__init__()
        self.units = out_channels if last_layer else out_channels // 2
        self.last_layer = last_layer
        # the dtype of the pooled output (the canvas); linear and BN
        # always run in float32
        self.pool_dtype = _DTYPES[pool_dtype]
        self.linear = nn.Linear(in_channels, self.units, bias=False)
        self.norm = BatchNorm(self.units, eps=1e-3)

    def forward(self, x, mask=None, *, seg_ids=None, num_segments=None,
                seg_counts=None, max_pts=None):
        if seg_ids is not None:  # point-major
            # one extra zero row gives the pad value relu(BN(0)); the
            # batch has one, however many ranks share it
            xa = torch.cat([x, x.new_zeros((1, x.shape[-1]))])
            # the max runs over the values cast to the pool dtype, as the
            # JAX net's; their ties decide the gradient
            y = F.relu(self.norm(self.linear(xa), shared_rows=1)).to(
                self.pool_dtype)
            pad_val = y[-1]
            y = y[:-1]
            vmax = segment_max(y, seg_ids, num_segments)
            has_pad = (seg_counts < max_pts)[:, None]
            vmax = torch.maximum(vmax, torch.where(has_pad, pad_val, -np.inf))
            vmax = torch.where((seg_counts <= 0)[:, None], 0.0, vmax)
            if self.last_layer:
                return vmax
            rep = vmax[seg_ids.long().clamp(0, num_segments - 1)]
            return torch.cat([y, rep], dim=1)

        # voxel-major: the reference's layout
        x = F.relu(self.norm(self.linear(x)))
        x_max = x.max(dim=1, keepdim=True).values  # [V, 1, units]
        x_max = torch.where(mask.any(1)[:, None, None], x_max, 0.0)
        if self.last_layer:
            return x_max
        rep = x_max.expand(x.shape[0], x.shape[1], self.units)
        return torch.cat([x, rep], dim=2)


class PillarFeatureNet(nn.Module):
    """Decorate each point with its offsets from its pillar's mean and
    its pillar's center, then run the PFN layers. Voxel-major ([V, P, 4]
    gathered pillars) and point-major ([N, 4] points and each point's
    pillar) modes share the parameters; see ``PFNLayer``."""

    def __init__(self, in_channels=4, feat_channels=(64,),
                 voxel_size=(0.16, 0.16, 4),
                 point_cloud_range=(0, -40.0, -3, 70.0, 40.0, 1), max_pts=32,
                 pool_dtype="float32"):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_pts = max_pts
        # pool_dtype applies to the point-major mode (the voxel-major mode
        # pools in float32, as the JAX net's does)
        self.layers = []
        cin = in_channels + 5
        for i, ch in enumerate(feat_channels):
            layer = PFNLayer(cin, ch, last_layer=i == len(feat_channels) - 1,
                             pool_dtype=pool_dtype)
            self.add_module(f"pfn_{i}", layer)
            self.layers.append(layer)
            cin = ch

    def forward(self, features, counts, coors=None, mask=None, *,
                point_to_voxel=None, num_voxels=None):
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        x_offset = vx / 2 + x0
        y_offset = vy / 2 + y0

        def const(value):  # a float32 tensor: a true division on the card
            return torch.tensor(value, dtype=features.dtype,
                                device=features.device)

        if point_to_voxel is not None:  # point-major
            # features [N, 4]; counts [V], or None to count here with the
            # coordinate sums; point_to_voxel [N], num_voxels for a
            # dropped point
            seg = point_to_voxel.long()
            valid = (seg < num_voxels)[:, None]
            xyz = features[:, :3]
            if counts is None:
                one_xyz = torch.cat([xyz.new_ones((xyz.shape[0], 1)), xyz],
                                    dim=-1)
                s4 = xyz.new_zeros((num_voxels + 1, 4)).index_add_(
                    0, seg, torch.where(valid, one_xyz, 0.0))[:num_voxels]
                counts = s4[:, 0].to(torch.int32)
                sums = s4[:, 1:]
            else:
                sums = xyz.new_zeros((num_voxels + 1, 3)).index_add_(
                    0, seg, torch.where(valid, xyz, 0.0))[:num_voxels]
            means = sums / counts.clamp(min=1).to(features.dtype)[:, None]
            f_cluster = xyz - means[seg.clamp(0, num_voxels - 1)]
            # the pillar's center from the point's own cell
            fx = features[:, 0:1] - (torch.floor(
                (features[:, 0:1] - const(x0)) / const(vx)) * vx + x_offset)
            fy = features[:, 1:2] - (torch.floor(
                (features[:, 1:2] - const(y0)) / const(vy)) * vy + y_offset)
            feats = torch.cat([features, f_cluster, fx, fy], dim=-1)
            feats = torch.where(valid, feats, 0.0)
            seg_s = torch.where(valid[:, 0], seg, num_voxels)
            for layer in self.layers:
                feats = layer(feats, seg_ids=seg_s, num_segments=num_voxels,
                              seg_counts=counts, max_pts=self.max_pts)
            return feats  # [V, C]

        # voxel-major: features [V, P, 4], coors [V, >=2] (x, y first)
        n = counts.clamp(min=1).to(features.dtype)[:, None, None]
        points_mean = torch.where(mask[..., None], features[:, :, :3],
                                  0.0).sum(1, keepdim=True) / n
        f_cluster = features[:, :, :3] - points_mean
        fx = features[:, :, 0:1] - (
            coors[:, 0].to(features.dtype)[:, None, None] * vx + x_offset)
        fy = features[:, :, 1:2] - (
            coors[:, 1].to(features.dtype)[:, None, None] * vy + y_offset)
        feats = torch.cat([features, f_cluster, fx, fy], dim=-1)
        feats = torch.where(mask[..., None], feats, 0.0)
        for layer in self.layers:
            feats = layer(feats, mask)
        return feats[:, 0, :]  # [V, C]


def _conv_bn_relu(x, conv, bn, dtype, transpose=False):
    """A bias-free convolution on ``dtype`` inputs and weights, then BN and
    ReLU in float32 on its output."""
    op = F.conv_transpose2d if transpose else F.conv2d
    kwargs = {} if transpose else {"padding": conv.padding}
    x = op(x.to(dtype), conv.weight.to(dtype), None, stride=conv.stride,
           **kwargs)
    return F.relu(bn(x))


class SECOND(nn.Module):
    """Stages of 3x3 convolutions over the BEV canvas, each starting with
    a strided one; returns every stage's output."""

    def __init__(self, in_channels=64, out_channels=(64, 128, 256),
                 layer_nums=(3, 5, 5), layer_strides=(2, 2, 2),
                 compute_dtype="float32"):
        super().__init__()
        self.dtype = _DTYPES[compute_dtype]
        self.layer_nums = tuple(layer_nums)
        cin = in_channels
        for i, num in enumerate(self.layer_nums):
            for j in range(num + 1):
                self.add_module(f"block{i}_conv{j}", nn.Conv2d(
                    cin, out_channels[i], 3,
                    stride=layer_strides[i] if j == 0 else 1, padding=1,
                    bias=False))
                self.add_module(f"block{i}_bn{j}", BatchNorm(
                    out_channels[i], eps=1e-3, axis=1))
                cin = out_channels[i]

    def forward(self, x):
        outs = []
        for i, num in enumerate(self.layer_nums):
            for j in range(num + 1):
                x = _conv_bn_relu(x, getattr(self, f"block{i}_conv{j}"),
                                  getattr(self, f"block{i}_bn{j}"),
                                  self.dtype)
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    """Bring every stage to the first stage's resolution and concatenate.

    A stride s >= 1 is a transposed convolution of kernel s and stride s
    (unless ``use_conv_for_no_stride`` at s = 1); a stride below 1 is a
    convolution of kernel and stride 1 / s.
    """

    def __init__(self, in_channels=(64, 128, 256),
                 out_channels=(128, 128, 128), upsample_strides=(1, 2, 4),
                 use_conv_for_no_stride=False, compute_dtype="float32"):
        super().__init__()
        self.dtype = _DTYPES[compute_dtype]
        self.transposed = []
        for i, stride in enumerate(upsample_strides):
            if stride > 1 or (stride == 1 and not use_conv_for_no_stride):
                self.add_module(f"deblock{i}_up", nn.ConvTranspose2d(
                    in_channels[i], out_channels[i], stride, stride=stride,
                    bias=False))
                self.transposed.append(True)
            else:
                s = int(np.round(1 / stride))
                self.add_module(f"deblock{i}_conv", nn.Conv2d(
                    in_channels[i], out_channels[i], s, stride=s,
                    bias=False))
                self.transposed.append(False)
            self.add_module(f"deblock{i}_bn", BatchNorm(
                out_channels[i], eps=1e-3, axis=1))

    def forward(self, xs):
        ups = []
        for i, (x, transposed) in enumerate(zip(xs, self.transposed)):
            conv = getattr(self, f"deblock{i}_up" if transposed
                           else f"deblock{i}_conv")
            ups.append(_conv_bn_relu(x, conv, getattr(self, f"deblock{i}_bn"),
                                     self.dtype, transpose=transposed))
        sizes = [tuple(u.shape[2:]) for u in ups]
        if len(set(sizes)) > 1:
            raise RuntimeError(f"neck maps of sizes {sizes}: {NECK_FAULT}")
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]


class PointPillarsNet(nn.Module):
    """The whole network over a padded batch.

    Input dict: point [B, P, 4] float32, point_count [B]. Returns (cls
    [B, H, W, A * C], reg [B, H, W, A * 7], dir [B, H, W, A * 2]), float32.

    ``pillar_mode``: "canvas" pools every point of a cell into its canvas
    cell, with no cap (``max_num_points`` only decides which pillars take
    the pad value, ``max_voxels`` is not used); "compact" voxelizes each
    sample with the reference's caps, pools the kept points of each kept
    pillar and places the pillars on the canvas (``ops/bev.py``).
    """

    # the flax tree of the JAX net sits at the root (no BatchedNet scope)
    JAX_SCOPE = None

    def __init__(self, classes, point_cloud_range, voxel_size,
                 max_num_points, max_voxels, feat_channels, output_shape,
                 backbone, neck, head, in_channels=4,
                 compute_dtype="bfloat16", pillar_mode="canvas"):
        super().__init__()
        if pillar_mode not in ("canvas", "compact"):
            raise ValueError(f"pillar_mode {pillar_mode!r}")
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.max_num_points = max_num_points
        self.max_voxels = max_voxels
        self.output_shape = tuple(output_shape)
        self.pillar_mode = pillar_mode
        feat_channels = tuple(feat_channels)
        self.voxel_encoder = PillarFeatureNet(
            in_channels, feat_channels, self.voxel_size,
            self.point_cloud_range, max_num_points, pool_dtype=compute_dtype)
        backbone = dict(backbone, in_channels=feat_channels[-1])
        self.backbone = SECOND(**backbone, compute_dtype=compute_dtype)
        neck = dict(neck, in_channels=tuple(
            backbone.get("out_channels", (64, 128, 256))))
        self.neck = SECONDFPN(**neck, compute_dtype=compute_dtype)
        cin = sum(neck.get("out_channels", (128, 128, 128)))
        sizes = head.get("sizes", [[1.6, 3.9, 1.56]])
        rotations = head.get("rotations", [0, 1.5707963])
        num_anchors = len(np.asarray(sizes).reshape(-1, 3)) * len(rotations)
        self.conv_cls = nn.Conv2d(cin, num_anchors * len(classes), 1)
        self.conv_reg = nn.Conv2d(cin, num_anchors * 7, 1)
        self.conv_dir_cls = nn.Conv2d(cin, num_anchors * 2, 1)

    def _canvas_major(self, points, pmask):
        """Canvas-major: the canvas cell is the segment id; the PFN's
        segment max writes the [B * ny * nx, C] canvas."""
        b, p, _ = points.shape
        ny, nx = self.output_shape
        nc = ny * nx
        pc, vs = self.point_cloud_range, self.voxel_size

        def const(value):
            return torch.tensor(value, dtype=points.dtype,
                                device=points.device)

        cx = torch.floor((points[..., 0] - const(pc[0])) /
                         const(vs[0])).to(torch.int64)
        cy = torch.floor((points[..., 1] - const(pc[1])) /
                         const(vs[1])).to(torch.int64)
        xyz = points[..., :3]
        valid = (pmask & (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) &
                 (xyz >= const(pc[:3])).all(-1) &
                 (xyz < const(pc[3:])).all(-1))
        batch = torch.arange(b, device=points.device)[:, None] * nc
        seg = torch.where(valid, cy * nx + cx + batch, b * nc)
        canvas = self.voxel_encoder(points.reshape(b * p, -1), None,
                                    point_to_voxel=seg.reshape(b * p),
                                    num_voxels=b * nc)
        return canvas.reshape(b, ny, nx, -1)

    def _compact(self, points, pmask):
        """Compact pillars: each sample voxelized with the caps, the PFN
        over per-sample slot ranges, then the canvas."""
        b, p, _ = points.shape
        ny, nx = self.output_shape
        mv = self.max_voxels
        pc = self.point_cloud_range
        vds = [voxelize(points[i, :, :3], self.voxel_size, pc[:3], pc[3:],
                        mv, self.max_num_points, points_mask=pmask[i])
               for i in range(b)]
        p2v = torch.stack([vd.point_to_voxel for vd in vds]).long()
        counts = torch.stack([vd.num_points_per_voxel for vd in vds])
        coors = torch.stack([vd.coords for vd in vds]).long()
        vmask = torch.stack([vd.voxel_mask for vd in vds])
        batch = torch.arange(b, device=points.device)[:, None] * mv
        seg = torch.where(p2v < mv, p2v + batch, b * mv)
        feats = self.voxel_encoder(points.reshape(b * p, -1),
                                   counts.reshape(b * mv),
                                   point_to_voxel=seg.reshape(b * p),
                                   num_voxels=b * mv)
        # the pillar key is its canvas cell (one z bin)
        spare = ny * nx + torch.arange(mv, device=points.device)[None, :]
        cells = torch.where(vmask, coors[..., 1] * nx + coors[..., 0], spare)
        canvas = bev_scatter(feats.reshape(b, mv, -1), cells, ny * nx)
        return canvas.reshape(b, ny, nx, -1)

    def forward(self, inputs):
        points = inputs["point"]
        counts = inputs["point_count"]
        p = points.shape[1]
        pmask = torch.arange(p, device=points.device)[None, :] < \
            counts[:, None]
        if self.pillar_mode == "canvas":
            canvas = self._canvas_major(points, pmask)
        else:
            canvas = self._compact(points, pmask)
        feat = self.neck(self.backbone(
            canvas.permute(0, 3, 1, 2).contiguous()))
        outs = (self.conv_cls(feat.float()), self.conv_reg(feat.float()),
                self.conv_dir_cls(feat.float()))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)


@MODEL.register_module()
class PointPillars(ObjdetBaseModel):
    """PointPillars: the host side of every split, the two nets, the anchor
    assignment, the losses and the optimizer, the decode and the boxes."""

    # its BatchNorms and its loss's divisor take the global batch's
    # statistics under a split batch (``parallel.mesh``)
    data_parallel = True

    def __init__(self,
                 name="PointPillars",
                 point_cloud_range=[0, -40.0, -3, 70.0, 40.0, 1],
                 classes=['car'],
                 voxelize={},
                 voxel_encoder={},
                 scatter={},
                 backbone={},
                 neck={},
                 head={},
                 loss={},
                 max_points=32768,
                 augment=None,
                 **kwargs):
        super().__init__(name=name,
                         point_cloud_range=point_cloud_range,
                         classes=classes,
                         voxelize=voxelize,
                         voxel_encoder=voxel_encoder,
                         scatter=scatter,
                         backbone=backbone,
                         neck=neck,
                         head=head,
                         loss=loss,
                         max_points=max_points,
                         augment=augment,
                         **kwargs)
        self.point_cloud_range = point_cloud_range
        self.classes = classes
        self.name2lbl = {n: i for i, n in enumerate(classes)}
        self.lbl2name = {i: n for i, n in enumerate(classes)}
        self.augmenter = ObjdetAugmentation(self.cfg.augment, seed=self.rng)

        self.voxel_size = voxelize.get("voxel_size", [0.16, 0.16, 4])
        self.max_num_points = voxelize.get("max_num_points", 32)
        mv = voxelize.get("max_voxels", [16000, 40000])
        self.max_voxels = mv if isinstance(mv, (list, tuple)) else [mv, mv]
        self.output_shape = tuple(scatter.get("output_shape", [496, 432]))

        self.nms_pre = head.get("nms_pre", 100)
        self.score_thr = head.get("score_thr", 0.1)
        self.dir_offset = head.get("dir_offset", 0)
        iou_thr = head.get("iou_thr", [[0.35, 0.5]])
        if len(iou_thr) != len(classes):
            assert len(iou_thr) == 1
            iou_thr = iou_thr * len(classes)
        self.iou_thr = iou_thr
        self.anchor_generator = Anchor3DRangeGenerator(
            ranges=head.get("ranges", [list(point_cloud_range)]),
            sizes=head.get("sizes", [[1.6, 3.9, 1.56]]),
            rotations=head.get("rotations", [0, 1.5707963]))
        self.loss_cls = FocalLoss(**loss.get("focal", {}))
        self.loss_bbox = SmoothL1Loss(**loss.get("smooth_l1", {}))
        self.loss_dir = CrossEntropyLoss(**loss.get("cross_entropy", {}))
        self.max_gt = int(kwargs.get("max_gt", 64))
        self._anchor_tensors = {}

    def _net(self, max_voxels, compute_dtype, pillar_mode):
        cfg = self.cfg
        return PointPillarsNet(
            classes=tuple(self.classes),
            point_cloud_range=tuple(self.point_cloud_range),
            voxel_size=tuple(self.voxel_size),
            max_num_points=self.max_num_points,
            max_voxels=max_voxels,
            in_channels=cfg.voxel_encoder.get("in_channels", 4),
            feat_channels=tuple(cfg.voxel_encoder.get("feat_channels",
                                                      [64])),
            output_shape=self.output_shape,
            backbone={k: tuple(v) if isinstance(v, list) else v
                      for k, v in dict(cfg.backbone or {}).items()},
            neck={k: tuple(v) if isinstance(v, list) else v
                  for k, v in dict(cfg.neck or {}).items()},
            head=dict(cfg.head or {}),
            compute_dtype=compute_dtype,
            pillar_mode=pillar_mode)

    def get_net(self, training=True):
        """The serving net (``compute_dtype``, default bf16;
        ``pillar_mode``, default canvas)."""
        cfg = self.cfg
        return self._net(self.max_voxels[0 if training else 1],
                         cfg.get("compute_dtype", "bfloat16"),
                         cfg.get("pillar_mode", "canvas"))

    def get_eval_net(self):
        """The evaluation net: compact pillars with the reference's caps
        (the eval ``max_voxels``), float32."""
        return self._net(self.max_voxels[1], "float32", "compact")

    # ------------------------------------------------------------- host side

    def preprocess(self, data, attr):
        """Keep the points inside the range, then, on the train split,
        augment (``ObjdetAugmentation`` drawing from the model's
        generator)."""
        points = np.array(data["point"][:, 0:4], dtype=np.float32)
        min_val = np.array(self.point_cloud_range[:3])
        max_val = np.array(self.point_cloud_range[3:])
        points = points[np.all(
            np.logical_and(points[:, :3] >= min_val, points[:, :3] < max_val),
            axis=-1)]
        data = dict(data, point=points)
        if attr["split"] not in ("test", "testing", "val", "validation"):
            data = self.augmenter.augment(data, attr, seed=self.rng)

        new_data = {"point": data["point"], "calib": data.get("calib")}
        if attr["split"] not in ("test", "testing"):
            new_data["bbox_objs"] = data.get("bounding_boxes", [])
        return new_data

    def transform(self, data, attr):
        """Pad to fixed shapes: point [max_points, 4] and its count; gt
        boxes [max_gt, 7], their labels and count."""
        points = np.asarray(data["point"], np.float32)
        p = int(self.cfg.max_points)
        count = min(len(points), p)
        out_pts = np.zeros((p, 4), np.float32)
        try:
            out_pts[:count] = points[:count]
        except ValueError as err:
            raise ValueError(f"{err}: {COLUMNS_FAULT}") from err

        t_data = {
            "point": out_pts,
            "point_count": np.int32(count),
            "calib": data.get("calib"),
        }
        if attr["split"] not in ("test", "testing"):
            bbox_objs = data.get("bbox_objs", [])
            g = self.max_gt
            boxes = np.zeros((g, 7), np.float32)
            labels = np.full((g,), len(self.classes), np.int32)
            gcount = min(len(bbox_objs), g)
            for i in range(gcount):
                boxes[i] = bbox_objs[i].to_xyzwhlr()
                labels[i] = self.name2lbl.get(bbox_objs[i].label_class,
                                              len(self.classes))
            t_data["bboxes"] = boxes
            t_data["labels"] = labels
            t_data["bbox_count"] = np.int32(gcount)
            t_data["bbox_objs"] = bbox_objs
        return t_data

    # ----------------------------------------------------------- device side

    def _featmap_size(self):
        """The head's feature map: the canvas over (the first backbone
        stride / the first neck upsample stride); (248, 216) at KITTI."""
        ny, nx = self.output_shape
        backbone = dict(self.cfg.backbone or {})
        neck = dict(self.cfg.neck or {})
        stride0 = backbone.get("layer_strides", [2, 2, 2])[0]
        up0 = neck.get("upsample_strides", [1, 2, 4])[0]
        scale = max(stride0 // up0, 1)
        return (ny // scale, nx // scale)

    def _anchors(self):
        """[H, W, S, R, 7] numpy anchors."""
        return self.anchor_generator.grid_anchors(self._featmap_size())

    def _anchors_on(self, device):
        """The anchors [H, W, S, R, 7] as a tensor on ``device``, made once
        a device."""
        key = str(device)
        if key not in self._anchor_tensors:
            self._anchor_tensors[key] = torch.from_numpy(
                self._anchors()).to(device)
        return self._anchor_tensors[key]

    def assign_bboxes(self, gt_bboxes, gt_labels, gt_counts):
        """Match every anchor of a padded batch to its gt box.

        Args:
            gt_bboxes: [B, G, 7], gt_labels: [B, G], gt_counts: [B]; the
                boxes past a sample's count are padding.

        Returns a dict of per-anchor tensors over the batch, flattened in
        the head's [B, H, W, S, R] order: target_deltas [T, 7],
        target_labels [T] (num_classes for the background), pos_mask
        [T], neg_mask [T], dir_targets [T].

        Size s of the anchors is matched to class s by the axis-aligned
        BEV IoU (``box3d_to_bev2d``) at that class's (neg, pos)
        thresholds: an anchor is positive at IoU >= pos with its best gt
        (the first on a tie), negative at 0 <= IoU < neg; every anchor
        whose IoU equals a gt's best IoU (>= neg) is positive too, and
        the anchor that gt's argmax picks is matched to it (the gt of the
        highest index where several pick one anchor). A sample with no gt
        matches the zero pad box: its deltas hold -inf, as the JAX
        package's do.
        """
        anchors = self._anchors_on(gt_bboxes.device)  # [H, W, S, R, 7]
        h, w, s, r, _ = anchors.shape
        num_classes = len(self.classes)
        assert s == num_classes or num_classes == 1
        b, g = gt_labels.shape
        k_ids = torch.arange(g, device=gt_bboxes.device)
        gmask = k_ids[None, :] < gt_counts[:, None]
        gt_bev = box3d_to_bev2d(gt_bboxes)
        per_class = []
        for j in range(s):
            aj = anchors[:, :, j].reshape(-1, 7)  # [A, 7], A = H * W * R
            a = aj.shape[0]
            neg_th, pos_th = self.iou_thr[j]
            overlaps = bbox_overlaps(gt_bev, box3d_to_bev2d(aj))  # [B, G, A]
            overlaps = torch.where(gmask[..., None], overlaps, -1.0)
            max_o, arg_o = overlaps.max(dim=1)
            gt_max, gt_arg = overlaps.max(dim=2)
            pos = max_o >= pos_th
            neg = (max_o >= 0) & (max_o < neg_th)

            # low-quality rescue: the anchors tying each gt's best IoU
            valid_k = gmask & (gt_max >= neg_th)
            tie = (overlaps == gt_max[..., None]) & valid_k[..., None]
            pos = pos | tie.any(dim=1)
            # anchor gt_arg[k] -> gt k, the last k where several pick one
            a_target = torch.where(valid_k, gt_arg, a)
            lq_k = torch.full((b, a + 1), -1, dtype=torch.long,
                              device=gt_bboxes.device)
            lq_k.scatter_reduce_(1, a_target,
                                 torch.where(valid_k, k_ids, -1), "amax")
            lq_k = lq_k[:, :a]
            arg = torch.where(lq_k >= 0, lq_k, arg_o)

            matched = torch.take_along_dim(gt_bboxes, arg[..., None], 1)
            lbls = torch.where(pos, torch.take_along_dim(
                gt_labels.long(), arg, 1), num_classes)
            yaw = limit_period(matched[..., -1], 0, 2 * np.pi)
            dirs = torch.floor(yaw / yaw.new_full((), np.pi)).long() % 2
            per_class.append((pos, neg, lbls, BBoxCoder.encode(aj, matched),
                              dirs))

        def stacked(i, *tail):  # [B, H*W*R, ...] x S -> [B*H*W*S*R, ...]
            parts = [t[i].reshape(b, h, w, r, *tail) for t in per_class]
            return torch.stack(parts, dim=3).reshape(-1, *tail)

        return {"pos_mask": stacked(0), "neg_mask": stacked(1),
                "target_labels": stacked(2), "target_deltas": stacked(3, 7),
                "dir_targets": stacked(4)}

    def get_loss(self, results, inputs):
        """{"loss_cls", "loss_bbox", "loss_dir"} of the head outputs
        ``results`` on the padded batch ``inputs``: the focal loss over
        the positive and negative anchors, smooth-L1 over the positive
        ones' deltas with the angle as sin(a - b) = sin a cos b - cos a
        sin b, and the direction's cross-entropy over them; each divided
        by the positive anchors of the whole batch (at least 1).
        Positive anchors matched to a gt whose label is no class count in
        that divisor but give no box or direction loss."""
        cls_scores, bbox_preds, dir_preds = results
        num_classes = len(self.classes)
        t = self.assign_bboxes(inputs["bboxes"], inputs["labels"],
                               inputs["bbox_count"])
        pos, neg = t["pos_mask"], t["neg_mask"]
        labels = t["target_labels"]
        pos_v = (pos & (labels >= 0) & (labels < num_classes)).float()
        # the positive anchors of the global batch
        avg = global_sum(pos.sum().float()).clamp(min=1.0)

        loss_cls = self.loss_cls(cls_scores.reshape(-1, num_classes),
                                 torch.where(pos, labels, num_classes),
                                 weight=(pos | neg).float(), avg_factor=avg)

        preds = bbox_preds.reshape(-1, 7)
        targets = t["target_deltas"]
        r0 = torch.sin(preds[:, -1:]) * torch.cos(targets[:, -1:])
        r1 = torch.cos(preds[:, -1:]) * torch.sin(targets[:, -1:])
        loss_bbox = self.loss_bbox(torch.cat([preds[:, :-1], r0], dim=-1),
                                   torch.cat([targets[:, :-1], r1], dim=-1),
                                   weight=pos_v, avg_factor=avg)
        loss_dir = self.loss_dir(dir_preds.reshape(-1, 2), t["dir_targets"],
                                 weight=pos_v, avg_factor=avg)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
                "loss_dir": loss_dir}

    def get_optimizer(self, cfg_pipeline, net):
        """(AdamW over every parameter of ``net``, BatchNorm's included,
        None): the pipeline's ``optimizer`` lr (1e-3), betas ((0.95,
        0.99)) and weight_decay (0.01), eps 1e-8, a constant learning
        rate, as ``optax.adamw``. No gradient clipping: the JAX pipeline
        never reads ``grad_clip_norm``. The JAX signature has no ``net``:
        optax transforms take the parameters at each update."""
        opt = dict(cfg_pipeline.get("optimizer") or {})
        betas = opt.get("betas", [0.95, 0.99])
        optimizer = torch.optim.AdamW(
            net.parameters(), lr=opt.get("lr", 1e-3),
            betas=(betas[0], betas[1]),
            weight_decay=opt.get("weight_decay", 0.01), eps=1e-8)
        return optimizer, None

    def get_bboxes(self, cls_scores, bbox_preds, dir_preds):
        """Decode and per-class rotated NMS over the ``nms_pre`` best
        anchors of each sample, on the outputs' device.

        Inputs [B, H, W, A * x]: the JAX ``get_bboxes`` mapped over the
        batch. Returns fixed-size (bboxes [B, M, 7], scores [B, M], labels
        [B, M], valid [B, M]), M = nms_pre * num_classes, class-major.
        """
        num_classes = len(self.classes)
        b = cls_scores.shape[0]
        anchors = self._anchors_on(cls_scores.device).reshape(-1, 7)

        scores = torch.sigmoid(cls_scores.reshape(b, -1, num_classes))
        preds = bbox_preds.reshape(b, -1, 7)
        dirs = torch.argmax(dir_preds.reshape(b, -1, 2), dim=-1)

        # top-k as lax.top_k orders it: ties to the lower index
        npre = min(self.nms_pre, scores.shape[1])
        topk = torch.sort(scores.max(dim=-1).values, dim=1, descending=True,
                          stable=True).indices[:, :npre]
        boxes = BBoxCoder.decode(
            anchors[topk], torch.take_along_dim(preds, topk[..., None], 1))
        scores_k = torch.take_along_dim(scores, topk[..., None], 1)
        dirs_k = torch.take_along_dim(dirs, topk, 1)

        # every class at once: [B, C, npre]
        cls_s = scores_k.transpose(1, 2)
        m = cls_s > self.score_thr
        bev = box3d_to_bev(boxes)[:, None].expand(b, num_classes, npre, 5)
        keep = nms_bev(bev, torch.where(m, cls_s, -np.inf), 0.01,
                       valid_mask=m)

        boxes = boxes.repeat(1, num_classes, 1)
        scores_o = cls_s.reshape(b, -1)
        labels_o = torch.arange(num_classes, device=boxes.device)\
            .repeat_interleave(npre).expand(b, -1)
        valid_o = (keep & m).reshape(b, -1)
        dir_all = dirs_k.repeat(1, num_classes)
        dir_rot = limit_period(boxes[..., 6] - self.dir_offset, 1, np.pi)
        yaw = dir_rot + self.dir_offset + np.pi * dir_all.to(boxes.dtype)
        boxes = torch.cat([boxes[..., :6], yaw[..., None]], dim=-1)
        return boxes, scores_o, labels_o, valid_o

    def inference_end(self, results, inputs):
        """Decode on the device, then ``BEVBox3D``s on the host: one list
        per sample."""
        cls_scores, bbox_preds, dir_preds = results
        b = cls_scores.shape[0]
        with torch.no_grad():
            decoded = self.get_bboxes(cls_scores, bbox_preds, dir_preds)
        boxes_b, scores_b, labels_b, valid_b = (t.cpu().numpy()
                                                for t in decoded)

        calibs = inputs.get("calib", None)
        if isinstance(calibs, dict):
            # the batcher stacks the samples' calib dicts: un-collate
            calibs = [{k: np.asarray(calibs[k][i]) for k in calibs}
                      for i in range(b)]
        if calibs is None:
            calibs = [None] * b
        out = []
        for i in range(b):
            out.append([])
            calib = calibs[i]
            world_cam = cam_img = None
            if calib is not None:
                world_cam = calib.get("world_cam")
                cam_img = calib.get("cam_img")
            for box, score, label, ok in zip(boxes_b[i], scores_b[i],
                                             labels_b[i], valid_b[i]):
                if not ok:
                    continue
                dim = box[[3, 5, 4]]
                pos = box[:3] + [0, 0, dim[1] / 2]
                yaw = box[-1]
                name = self.lbl2name.get(int(label), "ignore")
                out[-1].append(
                    BEVBox3D(pos, dim, yaw, name, float(score), world_cam,
                             cam_img))
        return out
