"""SparseConvUnet for semantic segmentation: the fused stencil path and the
exact hash path.

Counterpart of ``open3d_ml_tpu/models/sparseconvunet.py``: a U-Net of
``num_levels`` levels of submanifold 3x3x3 convolutions over the active
voxel sites, with stride-2 kernel-2 down and up convolutions, the input
features averaged per voxel and the logits read back per point. Two
execution paths share one ``state_dict``:

* ``conv_method="bucket"`` (``get_net``): the whole [B, N, .] batch. The
  sites are Morton-sorted once; every level keeps that order, and every
  convolution is one ``stencil_conv`` call (``ops/cuda/stencil.py``) over
  block tables from ``ops/sparse_bucket.py``: 39 calls per forward at 7
  levels with one block a level.
* ``conv_method="hash"`` (``get_eval_net``): one sample at a time, with
  sort + ``searchsorted`` rulebooks and gather-GEMM convolutions
  (``ops/sparse.py``), in float32: the reference-exact twin, which does not
  depend on the tables' segment budget.

The parameter names follow the JAX variable tree (``utils/convert_jax.py``
maps one onto the other); stencil weights are [K, Cin, Cout] with the taps
in ``kernel_offsets`` order. BatchNorm is ``MaskedBatchNorm`` with eps
1e-4 and flax momentum 0.99 (torch 0.01). With ``compute_dtype``
bfloat16 the convolutions round their inputs and weights to bfloat16 and
sum in float32; BatchNorm, the shortcut and the head stay float32.

Site caps and segment tables can fall short of a scene: the net keeps the
counts of its last forward in ``overflow`` (device tensors, read without a
synchronisation inside ``forward``) and logs the JAX package's warning when
one is not 0 and ``warn_on_overflow`` is set.

Training runs on the stencil path: BatchNorm takes the masked statistics
of the whole [B, V] batch, and each ``stencil_conv`` whose values or weight
need a gradient goes through ``StencilConv`` (the rulebook, the bucket
gather and its backward). The hash path runs one sample at a time, so its
batch statistics would be per sample where the JAX net's are the batch's:
it raises in train mode. ``get_loss`` and ``get_optimizer`` are the
training step's loss and its Adam.
"""

import logging

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..datasets.augment import SemsegAugmentation
from ..modules.losses import filter_valid_label
from ..modules.schedulers import exponential_lr
from ..ops.cuda.stencil import stencil_conv
from ..ops.sparse import (SiteHash, apply_sparse_conv,
                          apply_sparse_conv_transpose, build_rulebook,
                          downsample_sites, kernel_offsets)
from ..ops.sparse_bucket import (StencilCtx, bucket_downsample,
                                 rank_site_segments, sort_sites,
                                 stencil_query_keys, support_points)
from ..ops.voxelize import voxelize
from ..utils.registry import MODEL
from .base_model import BaseModel
from .common import MaskedBatchNorm

log = logging.getLogger(__name__)

CONV_METHODS = ("bucket", "hash")
_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}
_OFFS27 = kernel_offsets(3, centered=True)
_OFFS8 = kernel_offsets(2, centered=False)
UP_QBLOCK = 128  # the up convolution's own query block (one live tap)


def _stencil_weight(taps, cin, cout):
    """A [K, Cin, Cout] stencil weight, 0 until ``_draw_stencil`` draws it."""
    return nn.Parameter(torch.zeros(taps, cin, cout))


def _draw_stencil(weight, gen):
    """Draw a [K, Cin, Cout] stencil weight from ``gen`` as flax's
    variance_scaling(1, fan_in, normal) draws it: normal, std
    1 / sqrt(K * Cin)."""
    taps, cin = weight.shape[:2]
    with torch.no_grad():
        weight.normal_(0.0, (taps * cin) ** -0.5, generator=gen)


class SubmanifoldConv(nn.Module):
    """3x3x3 submanifold convolution: the same active sites in and out.

    ``ctx`` is a ``StencilCtx`` (stencil path, [B, V, C] features) or a
    [V, K] rulebook (hash path, one sample); the weight [K, Cin, Cout] and
    the tap order are the same on both.
    """

    def __init__(self, cin, filters, compute_dtype):
        super().__init__()
        self.weight = _stencil_weight(len(_OFFS27), cin, filters)
        self.compute_dtype = compute_dtype

    def reset_parameters(self, gen):
        """Draw the weight from ``gen``."""
        _draw_stencil(self.weight, gen)

    def forward(self, feat, ctx, mask):
        if isinstance(ctx, StencilCtx):
            out = stencil_conv(feat, ctx.keys, ctx.qkeys, ctx.seg_ids,
                               self.weight, seg=ctx.seg, qblock=ctx.qblock,
                               compute_dtype=self.compute_dtype or
                               torch.float32)
            return torch.where(mask[..., None], out, 0.0)
        return apply_sparse_conv(feat, ctx, self.weight, out_mask=mask,
                                 compute_dtype=self.compute_dtype)


class SCBlock(nn.Module):
    """BN -> ReLU -> SubmanifoldConv."""

    def __init__(self, cin, filters, bn_eps, bn_momentum, compute_dtype):
        super().__init__()
        self.bn = MaskedBatchNorm(cin, bn_eps, bn_momentum)
        self.conv = SubmanifoldConv(cin, filters, compute_dtype)

    def forward(self, feat, ctx, mask):
        return self.conv(F.relu(self.bn(feat, mask)), ctx, mask)


class ResidualSCBlock(nn.Module):
    """2 x (BN -> ReLU -> SubmanifoldConv) plus a shortcut, a bias-free
    Linear (``lin``) where the width changes."""

    def __init__(self, cin, filters, bn_eps, bn_momentum, compute_dtype):
        super().__init__()
        self.lin = (nn.Linear(cin, filters, bias=False) if cin != filters
                    else None)
        self.bn1 = MaskedBatchNorm(cin, bn_eps, bn_momentum)
        self.conv1 = SubmanifoldConv(cin, filters, compute_dtype)
        self.bn2 = MaskedBatchNorm(filters, bn_eps, bn_momentum)
        self.conv2 = SubmanifoldConv(filters, filters, compute_dtype)

    def forward(self, feat, ctx, mask):
        shortcut = feat if self.lin is None else self.lin(feat)
        x = self.conv1(F.relu(self.bn1(feat, mask)), ctx, mask)
        x = self.conv2(F.relu(self.bn2(x, mask)), ctx, mask)
        return shortcut + x


class SparseConvUnetNet(nn.Module):
    """The SparseConvUnet network on the stencil or the hash path.

    ``forward({"point": [B, N, 3] voxel-unit coordinates (>= 0, < 1024),
    "feat": [B, N, in_channels], "point_mask": [B, N] bool})`` returns
    logits [B, N, num_classes]; a point in no kept voxel gets 0.
    ``bn_momentum`` is flax's (0.99), as in the JAX net. The stencil
    weights are 0 until ``reset_parameters(gen)`` of the net (its down and
    up kernels) and of each ``SubmanifoldConv`` draws them, as flax's
    ``init`` draws a net's variables from a key; ``SemanticSegmentation``
    draws every weight from its seeded generator.
    """

    def __init__(self, in_channels, num_classes, multiplier=16,
                 conv_block_reps=1, residual_blocks=False, num_levels=7,
                 max_voxels=20000, bn_eps=1e-4, bn_momentum=0.99,
                 level_caps=(), compute_dtype=None, warn_on_overflow=True,
                 conv_method="hash", bucket_seg=64, bucket_qblock=32,
                 bucket_segs=16):
        super().__init__()
        if conv_method not in CONV_METHODS:
            raise ValueError(f"conv_method {conv_method!r}")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        self.conv_method = conv_method
        self.num_levels = num_levels
        self.conv_block_reps = conv_block_reps
        self.max_voxels = max_voxels
        self.caps = list(level_caps) or [
            max(((max_voxels >> i) + 7) & ~7, 64) for i in range(num_levels)]
        self.seg, self.qblock, self.num_segs = (bucket_seg, bucket_qblock,
                                                bucket_segs)
        self.compute_dtype = _DTYPES[compute_dtype]
        self.warn_on_overflow = warn_on_overflow
        self.overflow = {}
        self._pending = []

        cdt = self.compute_dtype
        bn = dict(bn_eps=bn_eps, bn_momentum=1.0 - bn_momentum)
        block = ResidualSCBlock if residual_blocks else SCBlock
        planes = [multiplier * (i + 1) for i in range(num_levels)]
        self.input_conv = SubmanifoldConv(in_channels, multiplier, cdt)
        for lvl, p in enumerate(planes):
            for r in range(conv_block_reps):
                self.add_module(f"l{lvl}_block{r}", block(p, p, **bn,
                                                          compute_dtype=cdt))
            if lvl == num_levels - 1:
                break
            deeper = planes[lvl + 1]
            self.add_module(f"l{lvl}_down_bn",
                            MaskedBatchNorm(p, bn_eps, 1.0 - bn_momentum))
            self.register_parameter(f"l{lvl}_down_kernel",
                                    _stencil_weight(8, p, deeper))
            self.add_module(f"l{lvl}_up_bn",
                            MaskedBatchNorm(deeper, bn_eps, 1.0 - bn_momentum))
            self.register_parameter(f"l{lvl}_up_kernel",
                                    _stencil_weight(8, deeper, p))
            for r in range(conv_block_reps):
                self.add_module(f"l{lvl}_post{r}",
                                block(2 * p if r == 0 else p, p, **bn,
                                      compute_dtype=cdt))
        self.final_bn = MaskedBatchNorm(planes[0], bn_eps, 1.0 - bn_momentum)
        self.linear = nn.Linear(planes[0], num_classes)

    def reset_parameters(self, gen):
        """Draw the net's own stencil weights (the down and up kernels,
        in registration order) from ``gen``."""
        for weight in self.parameters(recurse=False):
            _draw_stencil(weight, gen)

    def _blocks(self, kind, level, feat, ctx, mask):
        for r in range(self.conv_block_reps):
            feat = getattr(self, f"l{level}_{kind}{r}")(feat, ctx, mask)
        return feat

    def _head(self, feat, mask):
        return self.linear(F.relu(self.final_bn(feat, mask)))

    def forward(self, inputs):
        points = inputs["point"]
        pmask = inputs.get("point_mask")
        if pmask is None:
            pmask = torch.ones(points.shape[:2], dtype=torch.bool,
                               device=points.device)
        if self.conv_method == "bucket":
            logits, counters = self._forward_bucket(points, inputs["feat"],
                                                    pmask)
        elif self.training:
            raise NotImplementedError(
                "SparseConvUnet hash path in train mode: it runs one sample "
                "at a time, so its BatchNorm statistics would be per sample; "
                "train on the stencil path (conv_method='bucket')")
        else:
            outs = [self._forward_hash(points[i], inputs["feat"][i],
                                       pmask[i])
                    for i in range(points.shape[0])]
            logits = torch.stack([o[0] for o in outs])
            counters = {name: torch.stack([o[1][name] for o in outs])
                        for name in outs[0][1]}
        self._note_overflow(counters)
        return logits

    # ---------------------------------------------------------- stencil path

    def _voxelize(self, points, feat_in, pmask):
        """Voxelize each cloud, Morton-sort the sites and average the input
        features per site."""
        b, _, c = feat_in.shape
        cap = self.max_voxels
        vds = [voxelize(points[i], (1.0, 1.0, 1.0), (0.0, 0.0, 0.0),
                        (1024.0, 1024.0, 1024.0), cap, 1024 // 8,
                        points_mask=pmask[i]) for i in range(b)]
        coords, mask, mkey, inv_perm = sort_sites(
            torch.stack([vd.coords for vd in vds]),
            torch.stack([vd.voxel_mask for vd in vds]))
        p2v = torch.stack([vd.point_to_voxel for vd in vds]).long()
        inv_pad = torch.cat([inv_perm, inv_perm.new_full((b, 1), cap)], 1)
        valid_pt = (p2v < cap) & pmask
        point_site = torch.where(valid_pt, torch.gather(inv_pad, 1, p2v),
                                 cap).long()
        voxel_ovf = (pmask & ~valid_pt).sum().to(torch.int32)
        fsum = feat_in.new_zeros((b, cap + 1, c)).scatter_add_(
            1, point_site[..., None].expand(-1, -1, c),
            torch.where(valid_pt[..., None], feat_in, 0.0))
        cnt = feat_in.new_zeros((b, cap + 1)).scatter_add_(
            1, point_site, valid_pt.to(feat_in.dtype))
        feat = fsum[:, :cap] / torch.clamp(cnt[:, :cap], min=1.0)[..., None]
        return feat, coords, mask, mkey, point_site, voxel_ovf

    def _sub_ctx(self, coords, mask, nv, mkey, table_ovf):
        sup = support_points(coords, mask, self.seg)
        seg_ids, ovf = rank_site_segments(
            sup, nv, coords.float(), nv, seg=self.seg, qblock=self.qblock,
            num_segs=self.num_segs, reach=1.74)
        table_ovf.append(ovf)
        return StencilCtx(seg_ids, stencil_query_keys(coords, mask, _OFFS27),
                          mkey, self.seg, self.qblock)

    def _forward_bucket(self, points, feat_in, pmask):
        feat, coords, mask, mkey, point_site, voxel_ovf = self._voxelize(
            points, feat_in, pmask)
        nvalid = mask.sum(1).to(torch.int32)
        drops, table_ovf = [], []
        ctx0 = self._sub_ctx(coords, mask, nvalid, mkey, table_ovf)
        feat = self.input_conv(feat, ctx0, mask)
        feat = self._u_bucket(0, feat, coords, mask, nvalid, mkey, ctx0,
                              drops, table_ovf)
        logits = self._head(feat, mask)
        b = logits.shape[0]
        logits = torch.cat([logits, logits.new_zeros((b, 1,
                                                      logits.shape[2]))], 1)
        logits = torch.gather(logits, 1, point_site[..., None].expand(
            -1, -1, logits.shape[2]))
        counters = {"voxel_overflow_points": voxel_ovf}
        counters.update({f"l{i}_down_overflow_children": d
                         for i, d in enumerate(drops)})
        counters["table_overflow_blocks"] = torch.stack(
            [o.sum() for o in table_ovf]).sum().to(torch.int32)
        return logits, counters

    def _u_bucket(self, level, feat, coords, mask, nv, mkey, ctx, drops,
                  table_ovf):
        seg, qblock, cdt = self.seg, self.qblock, self.compute_dtype
        cdt = cdt or torch.float32
        feat = self._blocks("block", level, feat, ctx, mask)
        if level == self.num_levels - 1:
            return feat
        x = F.relu(getattr(self, f"l{level}_down_bn")(feat, mask))
        pcoords, pmask, pkey, off_idx, dropped = bucket_downsample(
            coords, mask, mkey, self.caps[level + 1])
        drops.append(dropped.sum().to(torch.int32))
        npar = pmask.sum(1).to(torch.int32)
        child = torch.arange(8, dtype=torch.int32, device=feat.device)

        # down: the parents query their children; tap k of parent p is the
        # child of code k (x fastest, as _OFFS8), key (pkey << 3) | k
        sup_f = support_points(coords, mask, seg)
        pq = torch.where(pmask[..., None], (pcoords * 2).float(), 2e9)
        seg_ids_d, ovf_d = rank_site_segments(
            sup_f, nv, pq, npar, seg=seg, qblock=qblock,
            num_segs=self.num_segs, reach=1.74)
        table_ovf.append(ovf_d)
        qkeys_d = torch.where(pmask[..., None], (pkey[..., None] << 3) | child,
                              -1)
        x_down = stencil_conv(x, mkey, qkeys_d, seg_ids_d,
                              getattr(self, f"l{level}_down_kernel"), seg=seg,
                              qblock=qblock, compute_dtype=cdt)
        x_down = torch.where(pmask[..., None], x_down, 0.0)

        ctx_p = self._sub_ctx(pcoords, pmask, npar, pkey, table_ovf)
        x_deep = self._u_bucket(level + 1, x_down, pcoords, pmask, npar, pkey,
                                ctx_p, drops, table_ovf)

        # up: each fine site reads its parent through the weight of its
        # child code: tap k holds the parent's key only where the code is k
        y = F.relu(getattr(self, f"l{level}_up_bn")(x_deep, pmask))
        supp = support_points(pcoords, pmask, seg)
        fq = torch.where(mask[..., None], (coords >> 1).float(), 2e9)
        seg_ids_u, ovf_u = rank_site_segments(
            supp, npar, fq, nv, seg=seg, qblock=UP_QBLOCK,
            num_segs=self.num_segs, reach=0.1)
        table_ovf.append(ovf_u)
        qkeys_u = torch.where(mask[..., None] & (off_idx[..., None] == child),
                              (mkey >> 3)[..., None], -1)
        y_up = stencil_conv(y, pkey, qkeys_u, seg_ids_u,
                            getattr(self, f"l{level}_up_kernel"), seg=seg,
                            qblock=UP_QBLOCK, compute_dtype=cdt)
        y_up = torch.where(mask[..., None], y_up, 0.0)
        return self._blocks("post", level, torch.cat([feat, y_up], -1), ctx,
                            mask)

    # ------------------------------------------------------------- hash path

    def _forward_hash(self, points, feat_in, pmask):
        """One sample: ([N, num_classes] logits, its counters)."""
        cap = self.max_voxels
        c = feat_in.shape[1]
        vd = voxelize(points, (1.0, 1.0, 1.0), (0.0, 0.0, 0.0),
                      (1024.0, 1024.0, 1024.0), cap, 1024 // 8,
                      points_mask=pmask)
        coords, mask = vd.coords, vd.voxel_mask
        point_site = vd.point_to_voxel.long()
        valid_pt = (point_site < cap) & pmask
        counters = {"voxel_overflow_points":
                    (pmask & ~valid_pt).sum().to(torch.int32)}
        fsum = feat_in.new_zeros((cap + 1, c)).index_add_(
            0, point_site, torch.where(valid_pt[:, None], feat_in, 0.0))
        cnt = feat_in.new_zeros((cap + 1,)).index_add_(
            0, point_site, valid_pt.to(feat_in.dtype))
        feat = fsum[:cap] / torch.clamp(cnt[:cap], min=1.0)[:, None]
        rulebook = build_rulebook(coords, mask, _OFFS27)
        feat = self.input_conv(feat, rulebook, mask)
        feat = self._u_hash(0, feat, coords, mask, rulebook, counters)
        logits = self._head(feat, mask)
        logits = torch.cat([logits, logits.new_zeros((1, logits.shape[1]))])
        return logits[point_site], counters

    def _u_hash(self, level, feat, coords, mask, rulebook, counters):
        cdt = self.compute_dtype
        feat = self._blocks("block", level, feat, rulebook, mask)
        if level == self.num_levels - 1:
            return feat
        x = F.relu(getattr(self, f"l{level}_down_bn")(feat, mask))
        dcap = self.caps[level + 1]
        pcoords, pmask, parent_idx, off_idx = downsample_sites(coords, mask,
                                                               dcap)
        counters[f"l{level}_down_overflow_children"] = (
            mask & (parent_idx == dcap)).sum().to(torch.int32)
        # each parent reads its children at 2 * p + {0, 1}^3
        offs8 = torch.as_tensor(_OFFS8, device=coords.device)
        child_q = pcoords[:, None, :] * 2 + offs8[None]
        child_idx, _ = SiteHash(coords, mask).lookup(
            child_q.reshape(-1, 3), pmask.repeat_interleave(8))
        x_down = apply_sparse_conv(x, child_idx.reshape(-1, 8),
                                   getattr(self, f"l{level}_down_kernel"),
                                   out_mask=pmask, compute_dtype=cdt)
        p_rb = build_rulebook(pcoords, pmask, _OFFS27)
        x_deep = self._u_hash(level + 1, x_down, pcoords, pmask, p_rb,
                              counters)
        y = F.relu(getattr(self, f"l{level}_up_bn")(x_deep, pmask))
        y_up = apply_sparse_conv_transpose(
            y, parent_idx, off_idx, getattr(self, f"l{level}_up_kernel"),
            out_mask=mask, compute_dtype=cdt)
        return self._blocks("post", level, torch.cat([feat, y_up], -1),
                            rulebook, mask)

    # -------------------------------------------------------------- overflow

    def _note_overflow(self, counters):
        """Keep the counters; queue their copy to the host (on a CUDA
        device, without waiting for it) for the warning."""
        self.overflow = counters
        if not self.warn_on_overflow:
            return
        flat = torch.cat([v.reshape(-1) for v in counters.values()])
        event = None
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            flat = host
        self._pending.append((counters, flat, event))
        self._flush_overflow(wait=False)

    def _flush_overflow(self, wait):
        """Log the warning for each queued forward whose counters have
        reached the host (all of them, when ``wait``)."""
        pending, self._pending = self._pending, []
        for entry in pending:
            counters, host, event = entry
            if event is not None:
                if not (wait or event.query()):
                    self._pending.append(entry)
                    continue
                event.synchronize()
            if host.any():
                self._warn(counters, host)

    def _warn(self, counters, host):
        values, i = {}, 0
        for name, v in counters.items():
            values[name] = int(host[i:i + v.numel()].sum())
            i += v.numel()
        drops = [values[f"l{i}_down_overflow_children"]
                 for i in range(self.num_levels - 1)]
        if self.conv_method == "bucket":
            log.warning(
                "SparseConvUnet bucket path saturated: %d points in over-cap "
                "voxels, truncated children %s, %d blocks short of exact "
                "segment tables — raise max_voxels / level_caps / "
                "bucket_segs.", values["voxel_overflow_points"], drops,
                values["table_overflow_blocks"])
        else:
            log.warning(
                "SparseConvUnet site caps saturated: %d points in over-cap "
                "voxels at level 0, per-level truncated children %s — output "
                "silently ignores real input; raise max_voxels / level_caps "
                "(see SparseConvUnetNet.level_caps).",
                values["voxel_overflow_points"], drops)

    def overflow_counts(self):
        """The last forward's counters as Python ints (lists of per-sample
        ints on the hash path), after logging every warning still queued;
        waits for the device."""
        self._flush_overflow(wait=True)
        return {name: v.tolist() for name, v in self.overflow.items()}


@MODEL.register_module()
class SparseConvUnet(BaseModel):
    """SparseConvUnet model: configuration, the networks (``get_net``,
    ``get_eval_net``) and the host side of inference.

    The defaults are the model section of
    ``open3d_ml_tpu/configs/sparseconvunet_scannet.yml``.
    """

    # ``transform`` crops the room itself: the possibility-map loop of the
    # pipeline's test and inference would never end (not ported)
    draws_patches = False
    patch_loop_queue = ("ROADMAP queue 1 item 2, 'SCU through "
                        "run_inference/run_test'")

    def __init__(self,
                 name="SparseConvUnet",
                 ckpt_path=None,
                 multiplier=32,
                 voxel_size=0.02,
                 residual_blocks=True,
                 conv_block_reps=1,
                 in_channels=3,
                 num_classes=20,
                 grid_size=4096,
                 num_points=65536,
                 max_voxels=40000,
                 compute_dtype="bfloat16",
                 conv_method="bucket",
                 bucket_seg=64,
                 bucket_qblock=32,
                 bucket_segs=16,
                 num_levels=7,
                 ignored_label_inds=(-1,),
                 batcher="DefaultBatcher",
                 augment=None,
                 **kwargs):
        if augment is None:
            augment = {
                "rotate": {"method": "vertical"},
                "scale": {"min_s": 0.9, "max_s": 1.1},
                "noise": {"noise_std": 0.01},
                "RandomDropout": {"dropout_ratio": 0.2},
                "RandomHorizontalFlip": {"axes": [0, 1]},
                "ChromaticAutoContrast": {"randomize_blend_factor": True,
                                          "blend_factor": 0.2},
                "ChromaticTranslation": {"trans_range_ratio": 0.1},
                "ChromaticJitter": {"std": 0.05}}
        super().__init__(name=name, ckpt_path=ckpt_path,
                         multiplier=multiplier, voxel_size=voxel_size,
                         residual_blocks=residual_blocks,
                         conv_block_reps=conv_block_reps,
                         in_channels=in_channels, num_classes=num_classes,
                         grid_size=grid_size, num_points=num_points,
                         max_voxels=max_voxels, compute_dtype=compute_dtype,
                         conv_method=conv_method, bucket_seg=bucket_seg,
                         bucket_qblock=bucket_qblock,
                         bucket_segs=bucket_segs, num_levels=num_levels,
                         ignored_label_inds=list(ignored_label_inds),
                         batcher=batcher, augment=augment, **kwargs)
        self.augmenter = SemsegAugmentation(self.cfg.augment, seed=self.rng)

    def get_net(self, conv_method=None, compute_dtype="cfg"):
        """The network (``SparseConvUnetNet``); ``conv_method`` and
        ``compute_dtype`` override the configuration (both paths share
        one ``state_dict``). The unfused bucket path of the JAX package
        (``bucket_fused: False``) is not ported and raises."""
        cfg = self.cfg
        if not cfg.get("bucket_fused", True):
            raise NotImplementedError(
                "SparseConvUnet bucket_fused=False (the match + gather + "
                "GEMM composition) is not ported; the port runs the fused "
                "stencil convolutions")
        return SparseConvUnetNet(
            in_channels=cfg.in_channels,
            num_classes=cfg.num_classes,
            multiplier=cfg.multiplier,
            conv_block_reps=cfg.conv_block_reps,
            residual_blocks=cfg.residual_blocks,
            num_levels=cfg.num_levels,
            max_voxels=cfg.max_voxels,
            level_caps=tuple(cfg.get("level_caps") or ()),
            compute_dtype=(cfg.get("compute_dtype", None)
                           if compute_dtype == "cfg" else compute_dtype),
            conv_method=conv_method or cfg.get("conv_method", "bucket"),
            bucket_seg=cfg.get("bucket_seg", 64),
            bucket_qblock=cfg.get("bucket_qblock", 32),
            bucket_segs=cfg.get("bucket_segs", 16),
            warn_on_overflow=cfg.get("warn_on_overflow", True))

    def get_eval_net(self):
        """The hash path in float32: sort + searchsorted rulebooks, exact
        whatever the segment budget; same ``state_dict`` as ``get_net``."""
        return self.get_net(conv_method="hash", compute_dtype=None)

    def preprocess(self, data, attr, rng=None):
        """Scale to voxel units, augment (training split), rebase to >= 0
        within a 1024^3 extent and snap to voxel centres."""
        cfg = self.cfg
        rng = rng or self.rng
        points = np.array(data["point"], dtype=np.float32)
        labels = (np.zeros((points.shape[0],), np.int32)
                  if data.get("label") is None else
                  np.array(data["label"], np.int32).reshape(-1))
        if data.get("feat") is None:
            raise ValueError("SparseConvUnet needs feature values.")
        feat = np.array(data["feat"], np.float32)

        points = points * (1.0 / cfg.voxel_size)
        if attr["split"] in ("training", "train"):
            points, feat, labels = self.augmenter.augment(
                points, feat, labels, dict(cfg.get("augment") or {}),
                seed=rng)

        points = points - points.min(0)
        inside = points.max(1) < 1023
        points, feat, labels = points[inside], feat[inside], labels[inside]
        points = (points.astype(np.int32) + 0.5).astype(np.float32)
        return {"point": points, "feat": feat, "label": labels}

    def transform(self, data, attr, rng=None):
        """Crop or pad to ``num_points`` points; colours over 1.5 are scaled
        to [-0.5, 0.5]."""
        cfg = self.cfg
        rng = rng or self.rng
        points = np.asarray(data["point"], np.float32)
        feat = np.asarray(data["feat"], np.float32)
        labels = np.asarray(data["label"], np.int32)

        n_target = cfg.num_points
        n = points.shape[0]
        if n >= n_target:
            sel = rng.choice(n, n_target, replace=False)
        else:
            sel = np.concatenate(
                [np.arange(n), rng.choice(max(n, 1), n_target - n)])
        mask = np.zeros((n_target,), bool)
        mask[:min(n, n_target)] = True
        out_feat = feat[sel] / 255.0 - 0.5 if feat.max() > 1.5 else feat[sel]
        return {
            "point": points[sel].astype(np.float32),
            "feat": out_feat.astype(np.float32),
            "label": labels[sel].astype(np.int32),
            "point_mask": mask,
            "point_inds": sel.astype(np.int32),
        }

    def get_loss(self, loss, results, inputs):
        """(loss, remapped labels [B * N], scores [B * N, num_classes]) of
        logits ``results`` [B, N, num_classes] against the raw labels
        ``inputs["label"]`` [B, N], over the valid labels of the points in
        ``inputs["point_mask"]``; ``loss`` is a ``SemSegLoss``."""
        cfg = self.cfg
        labels = inputs["label"].reshape(-1)
        scores = results.reshape(-1, cfg.num_classes)
        remapped, valid = filter_valid_label(scores, labels, cfg.num_classes,
                                             cfg.ignored_label_inds)
        valid = valid & inputs["point_mask"].reshape(-1)
        return (loss.weighted_cross_entropy(scores, remapped, valid),
                remapped, scores)

    def get_optimizer(self, cfg_pipeline, net):
        """(Adam over ``net``'s parameters, its learning-rate scheduler).

        The JAX package's ``optax.adam``: the learning rate ``optimizer.lr``
        (else 1e-3), the betas ``optimizer.betas`` (else 0.9 and 0.999),
        eps 1e-8, and no schedule (the JAX pipeline drops one, so
        ``scheduler_gamma`` is not read): the scheduler keeps the rate.
        """
        opt = dict(cfg_pipeline.get("optimizer") or {})
        b1, b2 = opt.get("betas", (0.9, 0.999))
        optimizer = torch.optim.Adam(net.parameters(), lr=opt.get("lr", 1e-3),
                                     betas=(b1, b2), eps=1e-8)
        return optimizer, exponential_lr(optimizer, 1.0)

    def update_probs(self, inputs, results, test_probs):
        """Write each sample's class probabilities (softmax of its logits)
        into the cloud's ``test_probs`` [N, num_classes] at its valid
        points."""
        results = np.asarray(results, np.float32)
        for b in range(results.shape[0]):
            logits = results[b].reshape(-1, self.cfg.num_classes)
            exp = np.exp(logits - logits.max(axis=-1, keepdims=True))
            probs = exp / exp.sum(axis=-1, keepdims=True)
            inds = np.asarray(inputs["point_inds"][b])
            valid = np.asarray(inputs["point_mask"][b])
            test_probs[inds[valid]] = probs[valid]
        return test_probs
