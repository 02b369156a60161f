"""PointRCNN two-stage 3D object detection: serving and training.

Counterpart of ``open3d_ml_tpu/models/point_rcnn.py``: stage 1 (the RPN:
the PointNet++ MSG backbone with a per-point foreground score and a
bin-based box regression) and stage 2 (the RCNN: the proposals decoded
and put through a rotated NMS per distance bucket, the points of each
proposal pooled into its canonical frame, and the refinement net), the
host side of every split, both stages' losses and their optimizer.
Everything runs in KITTI's camera frame (y down, a box's y at its bottom
face), as in JAX.

The JAX net vmaps the RPN over the samples and the RCNN over the rois of
a batch; the port runs each on the whole batch at once: the RPN on
[B, N, 3], the proposal layer on [B, N] with both buckets in one
``nms_bev`` call (the far bucket padded to the near one's size with
invalid boxes), and the RCNN on [B * rois, 512, 133]. At the shipped
config one frame of 16,384 points launches 14 ``knn_exact`` (8 RPN ball
queries at k = 16 and 32, 4 three-NN at k = 3, 2 RCNN ball queries at
k = 64), 6 ``fps`` and 1 ``nms_bev`` (the proposal layer's two buckets);
``inference_end`` launches one more ``nms_bev`` (the refined boxes). A
training step of mode RPN launches the RPN's 12 ``knn_exact`` and 4
``fps``; one of mode RCNN the whole forward's 14, 6 and 1, the proposal
layer at training's ``nms_post`` 512 and ``nms_thres`` 0.85.

Where ``jax.lax.top_k`` decides an output, its ties go to the lower
index: the port takes a stable descending sort there (the buckets'
candidates and survivors, whose ``-inf`` fills tie, and the roi
sampling's quotas, whose unfilled slots take the lowest-index ``-inf``
entries), and ``roipool3d`` orders its keys (index, or N + index outside
the box) so that no two tie.

Modes, trained stage by stage as the shipped YAML says:

* ``mode="RPN"`` (stage 1): the net returns the RPN's outputs,
  ``inference_end`` empty lists; the train and validation splits carry
  per-point labels (``generate_rpn_training_labels``: foreground,
  background, and an ignored ring 0.2 m deep around each box) and box
  targets; the loss is the focal loss of the scores and the bin loss of
  the boxes (``rpn_loss``); AdamW moves the RPN. The net's
  ``state_dict`` holds the RPN only, as the JAX variables of mode RPN do.
* ``mode="RCNN"`` (stage 2): the RPN runs as in eval (BatchNorm on its
  running statistics, no dropout, outputs detached) and the refinement
  trains: the proposals at training's NMS, ``rcnn_targets`` (the
  fixed-quota roi sampling, the jitter of each roi, the pooled points
  and the gt boxes in each roi's canonical frame, the labels), the RCNN
  net over every sampled roi, ``rcnn_loss``; AdamW moves the RCNN only
  (``freeze_rpn_mask``). Serving runs this mode in eval.

Randomness comes from the net's own generators (``manual_seed``): each
RPN head's dropout (``common.Dropout``) and the roi sampling, whose
uniform draws ``draw_sampling`` makes before the functions that use
them take them as tensors. A stage-1 checkpoint holds no RCNN weights,
so loading it into a mode-RCNN net strictly raises ``HANDOFF_FAULT``,
as the JAX pipeline fails on it; ``load_state_dict(state,
strict=False)`` carries the RPN's weights over.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..datasets.augment import ObjdetAugmentation
from ..datasets.utils import BEVBox3D, DataProcessing
from ..datasets.utils.operations import points_in_box
from ..modules.losses import CrossEntropyLoss, FocalLoss, SmoothL1Loss
from ..ops.iou import iou_3d_elementwise
from ..ops.nms import nms_bev
from ..utils.registry import MODEL
from .base_model_objdet import ObjdetBaseModel
from .common import Dropout
from .pointnet2 import (Pointnet2MSG, PointnetSAModule, SharedMLP2d,
                        gather_rows)

HANDOFF_FAULT = (
    "ROADMAP.md queue 3, 'PointRCNN's stage-1 checkpoint holds no RCNN "
    "weights': mode RPN's variables have no rcnn subtree, so a mode-RCNN "
    "run given that checkpoint fails, in the JAX pipeline too (flax's "
    "ScopeCollectionNotFound at the first step); carry the RPN's weights "
    "over with net.load_state_dict(state, strict=False) and train stage 2 "
    "in a log directory of its own")


def rotate_pc_along_y(pc, rot_angle):
    """Rotate [..., 3+] points about the camera's y axis by [...] angles."""
    cosa = torch.cos(rot_angle)
    sina = torch.sin(rot_angle)
    x = pc[..., 0]
    z = pc[..., 2]
    x_new = cosa * x + (-sina) * z
    z_new = sina * x + cosa * z
    return torch.cat([x_new[..., None], pc[..., 1:2], z_new[..., None],
                      pc[..., 3:]], dim=-1)


def _take(x, idx):
    """x [N, C], idx [N] -> [N]: x[n, idx[n]]."""
    return torch.take_along_dim(x, idx[:, None], dim=1)[:, 0]


def decode_bbox_target(roi_box3d, pred_reg, loc_scope, loc_bin_size,
                       num_head_bin, anchor_size, get_xz_fine=True,
                       get_y_by_bin=False, loc_y_scope=0.5,
                       loc_y_bin_size=0.25, get_ry_fine=False):
    """Bin-based box decoding: roi_box3d [N, 3 or 7], pred_reg [N, C] ->
    [N, 7] (x, y, z, h, w, l, ry) in the camera frame. Around [N, 7] rois
    the boxes are decoded in each roi's canonical frame and rotated back
    by its ry."""
    anchor = torch.tensor(anchor_size, dtype=torch.float32,
                          device=pred_reg.device)
    per_loc = int(loc_scope / loc_bin_size) * 2
    loc_y_bins = int(loc_y_scope / loc_y_bin_size) * 2

    x_bin = torch.argmax(pred_reg[:, 0:per_loc], dim=1)
    z_bin = torch.argmax(pred_reg[:, per_loc:per_loc * 2], dim=1)
    pos_x = x_bin * loc_bin_size + loc_bin_size / 2 - loc_scope
    pos_z = z_bin * loc_bin_size + loc_bin_size / 2 - loc_scope
    start = per_loc * 2
    if get_xz_fine:
        x_res = _take(pred_reg[:, per_loc * 2:per_loc * 3], x_bin) * \
            loc_bin_size
        z_res = _take(pred_reg[:, per_loc * 3:per_loc * 4], z_bin) * \
            loc_bin_size
        pos_x = pos_x + x_res
        pos_z = pos_z + z_res
        start = per_loc * 4

    if get_y_by_bin:
        y_bin = torch.argmax(pred_reg[:, start:start + loc_y_bins], dim=1)
        y_res = _take(pred_reg[:, start + loc_y_bins:
                               start + 2 * loc_y_bins], y_bin) * \
            loc_y_bin_size
        pos_y = (y_bin * loc_y_bin_size + loc_y_bin_size / 2 - loc_y_scope +
                 y_res) + roi_box3d[:, 1]
        start = start + 2 * loc_y_bins
    else:
        pos_y = roi_box3d[:, 1] + pred_reg[:, start]
        start = start + 1

    ry_bin = torch.argmax(pred_reg[:, start:start + num_head_bin], dim=1)
    ry_res_norm = _take(pred_reg[:, start + num_head_bin:
                                 start + 2 * num_head_bin], ry_bin)
    if get_ry_fine:
        apc = (np.pi / 2) / num_head_bin
        ry = ry_bin * apc + apc / 2 + ry_res_norm * (apc / 2) - np.pi / 4
    else:
        apc = (2 * np.pi) / num_head_bin
        ry = torch.remainder(ry_bin * apc + ry_res_norm * (apc / 2),
                             2 * np.pi)
        ry = torch.where(ry > np.pi, ry - 2 * np.pi, ry)
    start = start + 2 * num_head_bin

    size = pred_reg[:, start:start + 3] * anchor + anchor  # h, w, l

    box = torch.cat([pos_x[:, None], pos_y[:, None], pos_z[:, None], size,
                     ry[:, None]], dim=-1)
    if roi_box3d.shape[1] == 7:
        roi_ry = roi_box3d[:, 6]
        box = rotate_pc_along_y(box, -roi_ry)
        box = torch.cat([box[:, :6], (box[:, 6] + roi_ry)[:, None]], dim=-1)
    return torch.cat([(box[:, 0] + roi_box3d[:, 0])[:, None], box[:, 1:2],
                      (box[:, 2] + roi_box3d[:, 2])[:, None], box[:, 3:]],
                     dim=-1)


def _mod(x, y):
    """x mod y for y > 0 as ``jnp.remainder`` computes it: the exact
    ``fmod``, plus y where that is below 0."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def _bin(shift, size):
    """The bin index of each shift: floor(shift / size), int64."""
    return torch.floor(shift / size).long()


def get_reg_loss(pred_reg, reg_label, loc_scope, loc_bin_size, num_head_bin,
                 anchor_size, weight, get_xz_fine=True, get_y_by_bin=False,
                 loc_y_scope=0.5, loc_y_bin_size=0.25, get_ry_fine=False):
    """The bin-based box loss of pred_reg [N, C] against reg_label [N, 7]
    (x, y, z offsets, h, w, l, ry) over the rows that ``weight`` [N]
    selects, each term divided by max(selected, 1): the cross entropy of
    the x and z bins and the smooth-L1 of their residuals, y's smooth-L1
    (or its bin and residual), the heading's bin and residual (the full
    circle, or with ``get_ry_fine`` the quarter about the nearer of a
    heading and its opposite), and the size against ``anchor_size``.
    Returns (loss_loc, loss_angle, loss_size)."""
    ce = CrossEntropyLoss()
    sl1 = SmoothL1Loss()
    per_loc = int(loc_scope / loc_bin_size) * 2
    avg = torch.clamp(weight.sum(), min=1.0)

    x_shift = torch.clamp(reg_label[:, 0] + loc_scope, 0,
                          loc_scope * 2 - 1e-3)
    z_shift = torch.clamp(reg_label[:, 2] + loc_scope, 0,
                          loc_scope * 2 - 1e-3)
    x_bin = _bin(x_shift, loc_bin_size)
    z_bin = _bin(z_shift, loc_bin_size)

    loss_loc = ce(pred_reg[:, 0:per_loc], x_bin, weight=weight,
                  avg_factor=avg) + \
        ce(pred_reg[:, per_loc:2 * per_loc], z_bin, weight=weight,
           avg_factor=avg)
    start = 2 * per_loc
    if get_xz_fine:
        x_res_lbl = (x_shift -
                     (x_bin * loc_bin_size + loc_bin_size / 2)) / loc_bin_size
        z_res_lbl = (z_shift -
                     (z_bin * loc_bin_size + loc_bin_size / 2)) / loc_bin_size
        x_res = _take(pred_reg[:, 2 * per_loc:3 * per_loc], x_bin)
        z_res = _take(pred_reg[:, 3 * per_loc:4 * per_loc], z_bin)
        loss_loc = loss_loc + sl1(x_res, x_res_lbl, weight=weight,
                                  avg_factor=avg) + \
            sl1(z_res, z_res_lbl, weight=weight, avg_factor=avg)
        start = 4 * per_loc

    if get_y_by_bin:
        loc_y_bins = int(loc_y_scope / loc_y_bin_size) * 2
        y_shift = torch.clamp(reg_label[:, 1] + loc_y_scope, 0,
                              loc_y_scope * 2 - 1e-3)
        y_bin = _bin(y_shift, loc_y_bin_size)
        y_res_lbl = (y_shift - (y_bin * loc_y_bin_size +
                                loc_y_bin_size / 2)) / loc_y_bin_size
        y_res = _take(pred_reg[:, start + loc_y_bins:
                               start + 2 * loc_y_bins], y_bin)
        loss_loc = loss_loc + \
            ce(pred_reg[:, start:start + loc_y_bins], y_bin, weight=weight,
               avg_factor=avg) + \
            sl1(y_res, y_res_lbl, weight=weight, avg_factor=avg)
        start = start + 2 * loc_y_bins
    else:
        loss_loc = loss_loc + sl1(pred_reg[:, start], reg_label[:, 1],
                                  weight=weight, avg_factor=avg)
        start = start + 1

    ry_label = reg_label[:, 6]
    if get_ry_fine:
        apc = (np.pi / 2) / num_head_bin
        ry = _mod(ry_label, 2 * np.pi)
        opposite = (ry > np.pi * 0.5) & (ry < np.pi * 1.5)
        ry = torch.where(opposite, _mod(ry + np.pi, 2 * np.pi), ry)
        shift = torch.clamp(_mod(ry + np.pi * 0.5, 2 * np.pi) - np.pi * 0.25,
                            1e-3, np.pi * 0.5 - 1e-3)
    else:
        apc = (2 * np.pi) / num_head_bin
        shift = _mod(_mod(ry_label, 2 * np.pi) + apc / 2, 2 * np.pi)
    ry_bin = _bin(shift, apc)
    ry_res_lbl = (shift - (ry_bin * apc + apc / 2)) / (apc / 2)

    ry_res = _take(pred_reg[:, start + num_head_bin:
                            start + 2 * num_head_bin], ry_bin)
    loss_angle = ce(pred_reg[:, start:start + num_head_bin], ry_bin,
                    weight=weight, avg_factor=avg) + \
        sl1(ry_res, ry_res_lbl, weight=weight, avg_factor=avg)
    start = start + 2 * num_head_bin

    anchor = torch.tensor(anchor_size, dtype=torch.float32,
                          device=pred_reg.device)
    size_lbl = (reg_label[:, 3:6] - anchor) / anchor
    loss_size = sl1(pred_reg[:, start:start + 3], size_lbl, weight=weight,
                    avg_factor=avg)
    return loss_loc, loss_angle, loss_size


# --------------------------------------------------------------------------
# roi pooling
# --------------------------------------------------------------------------


def points_in_cam_box(points, boxes, extra_width=0.0):
    """Membership [B, M, N] of camera-frame points [B, N, 3] in boxes
    [B, M, 7] (x, y, z, h, w, l, ry; y down, a box spanning y - h .. y),
    each box grown by ``extra_width`` on every side."""
    p = points[:, None]  # [B, 1, N, 3]
    bx = boxes[..., None, :]  # [B, M, 1, 7]
    x = p[..., 0] - bx[..., 0]
    y = p[..., 1] - bx[..., 1]
    z = p[..., 2] - bx[..., 2]
    ry = bx[..., 6]
    cx = torch.cos(ry) * x + torch.sin(ry) * z
    cz = -torch.sin(ry) * x + torch.cos(ry) * z
    w = bx[..., 4] + extra_width * 2
    l = bx[..., 5] + extra_width * 2
    in_x = torch.abs(cx) <= l / 2
    in_z = torch.abs(cz) <= w / 2
    in_y = (y <= extra_width) & (y >= -(bx[..., 3] + extra_width))
    return in_x & in_y & in_z


def roipool3d(xyz, feats, boxes, extra_width, num_points):
    """The first ``num_points`` points inside each roi (grown by
    ``extra_width``), in index order.

    xyz [B, N, 3], feats [B, N, C], boxes [B, M, 7] -> (pooled
    [B, M, P, 3 + C], empty [B, M]), P = min(num_points, N). A roi with
    fewer points repeats its first one in the rest of the rows; an empty
    roi gets point 0 in every row, as JAX's top-k of all ``-inf`` scores
    gives.
    """
    n = xyz.shape[1]
    member = points_in_cam_box(xyz, boxes, extra_width)  # [B, M, N]
    index = torch.arange(n, device=xyz.device)
    # members by index, then the rest by index: unique keys
    key = torch.where(member, index, index + n)
    top = torch.topk(key, min(num_points, n), dim=-1, largest=False,
                     sorted=True).values
    valid = top < n
    idx = torch.where(valid, top, top - n)
    pooled = gather_rows(torch.cat([xyz, feats], dim=-1), idx)
    pooled = torch.where(valid[..., None], pooled, pooled[:, :, :1])
    return pooled, ~valid.any(dim=-1)


# --------------------------------------------------------------------------
# RCNN training targets
# --------------------------------------------------------------------------

# pos_range, hwl_range and angle_range of each jitter level (the
# reference's random_aug_box3d)
AUG_RANGE_CONFIG = np.array(
    [[0.2, 0.1, np.pi / 12], [0.3, 0.15, np.pi / 12],
     [0.5, 0.15, np.pi / 9], [0.8, 0.15, np.pi / 6],
     [1.0, 0.15, np.pi / 3]], np.float32)


def quotas(cfg):
    """(fg, hard bg, easy bg) slots of the ``roi_per_image`` sampled
    rois."""
    r = cfg["roi_per_image"]
    fg = int(np.round(cfg["fg_ratio"] * r))
    hard = int(np.round((r - fg) * cfg["hard_bg_ratio"]))
    return fg, hard, r - fg - hard


def draw_sampling(gen, b, m, cfg, device):
    """The random draws of one training step's ``rcnn_targets`` for a
    batch of b samples of m proposals, from the generator ``gen``:
    "priority" [B, 3, M] uniform in [0, 1) (the fg, hard-bg and easy-bg
    quotas' priorities), and for the jitter of the fg slots (A =
    ``roi_fg_aug_times`` attempts) and of the bg slots (1 attempt)
    "{fg,bg}_level" [B, slots, A] the jitter level (0-4),
    "{fg,bg}_jitter" [B, slots, A, 7] uniform in [-1, 1) and
    "{fg,bg}_keep" [B, slots, A] uniform in [0, 1) (an attempt keeps the
    roi below 0.2)."""
    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    draws = {"priority": uniform(b, 3, m)}
    aug_times = int(cfg.get("roi_fg_aug_times", 0))
    if aug_times > 0:
        fg = quotas(cfg)[0]
        for name, slots, times in (("fg", fg, aug_times),
                                   ("bg", cfg["roi_per_image"] - fg, 1)):
            draws[f"{name}_level"] = torch.randint(
                0, len(AUG_RANGE_CONFIG), (b, slots, times), generator=gen,
                device=device)
            draws[f"{name}_jitter"] = uniform(b, slots, times, 7) * 2 - 1
            draws[f"{name}_keep"] = uniform(b, slots, times)
    return draws


def _iou_frame(b):
    """Camera-frame boxes [..., 7] (x, y, z, h, w, l, ry; y the bottom)
    in ``iou_3d``'s convention [x, y - h, z, w, h, l, ry]."""
    return torch.stack([b[..., 0], b[..., 1] - b[..., 3], b[..., 2],
                        b[..., 4], b[..., 3], b[..., 5], b[..., 6]], dim=-1)


def roi_gt_iou(rois, gt):
    """The 3D IoU [B, M, G] of each roi [B, M, 7] with each gt box
    [B, G, 7], both in the camera frame."""
    a, g = torch.broadcast_tensors(_iou_frame(rois)[:, :, None],
                                   _iou_frame(gt)[:, None])
    return iou_3d_elementwise(a, g)


def sample_rois_for_rcnn(rois, roi_valid, gt, gt_count, priority, *,
                         roi_per_image=64, fg_ratio=0.5, reg_fg_thresh=0.55,
                         cls_bg_thresh=0.45, cls_bg_thresh_lo=0.05,
                         hard_bg_ratio=0.8):
    """Fixed-quota fg / bg sampling of a batch's proposals rois [B, M, 7]
    (``roi_valid`` [B, M]) against its gt boxes [B, G, 7], the first
    ``gt_count`` [B] of each sample real.

    A roi is fg at IoU >= ``reg_fg_thresh`` with its best gt box, hard bg
    in [``cls_bg_thresh_lo``, ``cls_bg_thresh``), easy bg below. Each
    quota (fg, hard bg, easy bg: ``quotas``) takes its rois in the order
    of ``priority`` [B, 3, M] (one row a quota), highest first; a quota
    with too few rois fills its other slots with the lowest-index rois
    outside it, flagged not ok, as ``lax.top_k`` over ``-inf`` gives
    them. Returns (rois [B, R, 7], their best gt boxes [B, R, 7], IoUs
    [B, R], ok [B, R]), R = ``roi_per_image``, the fg slots first."""
    g = gt.shape[1]
    iou = roi_gt_iou(rois, gt)
    gmask = torch.arange(g, device=gt.device)[None] < gt_count[:, None]
    iou = torch.where(gmask[:, None], iou, -1.0)
    max_iou = iou.max(dim=-1).values
    gt_arg = torch.argmax(iou, dim=-1)

    fg = (max_iou >= reg_fg_thresh) & roi_valid
    easy_bg = (max_iou < cls_bg_thresh_lo) & roi_valid
    hard_bg = (max_iou >= cls_bg_thresh_lo) & (max_iou < cls_bg_thresh) & \
        roi_valid

    cfg = {"roi_per_image": roi_per_image, "fg_ratio": fg_ratio,
           "hard_bg_ratio": hard_bg_ratio}
    sel, ok = [], []
    for j, (mask, quota) in enumerate(zip((fg, hard_bg, easy_bg),
                                          quotas(cfg))):
        pri = torch.where(mask, priority[:, j], -np.inf)
        idx = _stable_top(pri, quota)
        sel.append(idx)
        ok.append(torch.isfinite(torch.take_along_dim(pri, idx, dim=1)))
    sel, ok = torch.cat(sel, dim=1), torch.cat(ok, dim=1)
    sel_gt = torch.take_along_dim(gt_arg, sel, dim=1)
    return (torch.take_along_dim(rois, sel[..., None], dim=1),
            torch.take_along_dim(gt, sel_gt[..., None], dim=1),
            torch.take_along_dim(max_iou, sel, dim=1), ok)


def aug_roi_by_noise(rois, gt, iou_src, level, jitter, keep, *,
                     pos_thresh):
    """The jitter of rois [B, R, 7] around their gt boxes [B, R, 7]: A
    attempts a roi (``level`` [B, R, A] the jitter level, ``jitter``
    [B, R, A, 7] in [-1, 1) the centre, size and heading moves scaled by
    that level's ranges, ``keep`` [B, R, A] below 0.2 keeping the roi as
    it is); the first attempt whose 3D IoU with the gt box reaches
    ``pos_thresh`` is kept, else the last. Returns (rois [B, R, 7], IoUs
    [B, R]): ``iou_src`` [B, R], the IoU before the jitter, where the
    kept attempt is the roi itself."""
    times = level.shape[-1]
    ranges = torch.as_tensor(AUG_RANGE_CONFIG, device=rois.device)[level.long()]
    base = rois[..., None, :]
    pos = base[..., 0:3] + jitter[..., 0:3] * ranges[..., 0:1]
    hwl = base[..., 3:6] * (jitter[..., 3:6] * ranges[..., 1:2] + 1.0)
    ang = base[..., 6:7] + jitter[..., 6:7] * ranges[..., 2:3]
    kept = keep < 0.2
    cand = torch.where(kept[..., None], base,
                       torch.cat([pos, hwl, ang], dim=-1))  # [B, R, A, 7]
    ious = iou_3d_elementwise(
        _iou_frame(cand), _iou_frame(gt)[..., None, :].expand(cand.shape))
    success = ious >= pos_thresh
    pick = torch.where(success.any(dim=-1),
                       torch.argmax(success.to(torch.uint8), dim=-1),
                       times - 1)[..., None]
    sel = torch.take_along_dim(cand, pick[..., None], dim=-2)[..., 0, :]
    sel_iou = torch.take_along_dim(ious, pick, dim=-1)[..., 0]
    sel_keep = torch.take_along_dim(kept, pick, dim=-1)[..., 0]
    return sel, torch.where(sel_keep, iou_src, sel_iou)


def canonical(points, rois):
    """Points [B, R, P, 3 + C] moved into each roi's [B, R, 7] canonical
    frame: centred on it and turned by its heading about y."""
    pts = points[..., 0:3] - rois[:, :, None, 0:3]
    pts = rotate_pc_along_y(pts, rois[..., 6:7].expand(pts.shape[:3]))
    return torch.cat([pts, points[..., 3:]], dim=-1)


def rcnn_targets(xyz, pts_feature, rois, roi_valid, gt, gt_count, draws,
                 cfg):
    """The RCNN's training inputs and targets of a batch (the reference's
    ProposalTargetLayer): ``sample_rois_for_rcnn`` on the proposals rois
    [B, M, 7], the jitter of the fg slots (``roi_fg_aug_times``
    attempts) and of the bg slots (one) at the IoU ``min(reg_fg_thresh,
    cls_fg_thresh)``, the points of each sampled roi pooled
    (``roipool3d``, xyz [B, N, 3] and pts_feature [B, N, C]) into its
    canonical frame, and its gt box in that frame. ``draws``:
    ``draw_sampling``'s.

    Returns {"pts_input" [B, R, P, 3 + C], "cls_label" [B, R] (1 above
    ``cls_fg_thresh``, 0 at or below ``cls_bg_thresh``, -1 between them
    and for a slot not ok or a roi with no point), "reg_valid_mask"
    [B, R] (IoU above ``reg_fg_thresh``, the slot ok and its roi not
    empty), "gt_of_rois" [B, R, 7] (canonical), "roi_boxes3d" [B, R, 7]}.
    """
    sel_rois, sel_gt, sel_iou, sel_ok = sample_rois_for_rcnn(
        rois, roi_valid, gt, gt_count, draws["priority"],
        roi_per_image=cfg["roi_per_image"], fg_ratio=cfg["fg_ratio"],
        reg_fg_thresh=cfg["reg_fg_thresh"],
        cls_bg_thresh=cfg["cls_bg_thresh"],
        cls_bg_thresh_lo=cfg["cls_bg_thresh_lo"],
        hard_bg_ratio=cfg["hard_bg_ratio"])

    if int(cfg.get("roi_fg_aug_times", 0)) > 0:
        fg = quotas(cfg)[0]
        pos_thresh = min(cfg["reg_fg_thresh"], cfg["cls_fg_thresh"])
        parts = [aug_roi_by_noise(
            sel_rois[:, cut], sel_gt[:, cut], sel_iou[:, cut],
            draws[f"{name}_level"], draws[f"{name}_jitter"],
            draws[f"{name}_keep"], pos_thresh=pos_thresh)
            for name, cut in (("fg", slice(0, fg)), ("bg", slice(fg, None)))]
        sel_rois = torch.cat([p[0] for p in parts], dim=1)
        sel_iou = torch.cat([p[1] for p in parts], dim=1)

    pooled, empty = roipool3d(xyz, pts_feature, sel_rois,
                              cfg["pool_extra_width"], cfg["num_points"])
    pooled = canonical(pooled, sel_rois)

    roi_ry = _mod(sel_rois[..., 6], 2 * np.pi)
    centre = sel_gt[..., 0:3] - sel_rois[..., 0:3]
    centre = rotate_pc_along_y(centre[..., None, :], roi_ry[..., None])
    gt_ct = torch.cat([centre[..., 0, :], sel_gt[..., 3:6],
                       (sel_gt[..., 6] - roi_ry)[..., None]], dim=-1)

    valid = sel_ok & ~empty
    reg_valid = (sel_iou > cfg["reg_fg_thresh"]) & valid
    cls_label = (sel_iou > cfg["cls_fg_thresh"]).to(torch.int32)
    ambiguous = (sel_iou > cfg["cls_bg_thresh"]) & \
        (sel_iou < cfg["cls_fg_thresh"])
    cls_label = torch.where(~valid | ambiguous, -1, cls_label)
    return {"pts_input": pooled, "cls_label": cls_label,
            "reg_valid_mask": reg_valid, "gt_of_rois": gt_ct,
            "roi_boxes3d": sel_rois}


# --------------------------------------------------------------------------
# networks
# --------------------------------------------------------------------------


class _ConvHead(SharedMLP2d):
    """``SharedMLP2d`` layers (``conv{i}``, ``bn{i}`` where ``use_bn``,
    ReLU, dropout), then the output Linear (``final``)."""

    def __init__(self, in_channels, out_ch, final, db_ratio=0.5,
                 use_bn=True):
        super().__init__(in_channels, tuple(out_ch), bn=use_bn,
                         dropout=db_ratio)
        self.final = nn.Linear(self.out_channels, final)

    def forward(self, x):
        return self.final(super().forward(x))


class RPNNet(nn.Module):
    """Stage 1: the backbone and the per-point heads: cls [B, N, 1], reg
    [B, N, reg_channels], and the backbone's xyz [B, N, 3] and features
    [B, N, C]."""

    def __init__(self, backbone_cfg, cls_out_ch, reg_out_ch, reg_channels,
                 db_ratio=0.5):
        super().__init__()
        self.backbone = Pointnet2MSG(**backbone_cfg)
        width = backbone_cfg["fp_mlps"][0][-1]
        self.cls_blocks = _ConvHead(width, cls_out_ch, 1, db_ratio)
        self.reg_blocks = _ConvHead(width, reg_out_ch, reg_channels,
                                    db_ratio)

    def forward(self, points):
        xyz, feats = self.backbone(points)
        return self.cls_blocks(feats), self.reg_blocks(feats), xyz, feats


class RCNNNet(nn.Module):
    """Stage 2 over a batch of rois' pooled points [R, P, 3 + 2 + C]
    (canonical xyz, the segmentation mask, the depth, the RPN's features)
    -> (cls [R, 1 or classes], reg [R, reg_channels]). Its
    ``xyz_up_layer`` and ``merge_down_layer`` are biased Linear layers
    with ReLU and no BatchNorm, as the reference builds them."""

    def __init__(self, num_classes, sa_npoints, sa_radius, sa_nsample,
                 sa_mlps, xyz_up_layer, cls_out_ch, reg_out_ch, reg_channels,
                 rcnn_input_channel=5, in_channels=128):
        super().__init__()
        self.rcnn_input_channel = rcnn_input_channel
        self.xyz_up_layer = SharedMLP2d(rcnn_input_channel,
                                        tuple(xyz_up_layer), bn=False)
        width = xyz_up_layer[-1]
        self.merge_down_layer = SharedMLP2d(width + in_channels, (width,),
                                            bn=False)
        self.levels = len(sa_npoints)
        for i in range(self.levels):
            np_i = sa_npoints[i]
            sa = PointnetSAModule(
                mlp=tuple(sa_mlps[i]),
                npoint=None if np_i in (-1, None) else np_i,
                radius=sa_radius[i], nsample=sa_nsample[i],
                in_channels=width)
            self.add_module(f"sa{i}", sa)
            width = sa.out_channels
        cls_ch = 1 if num_classes == 2 else num_classes
        self.cls_blocks = _ConvHead(width, cls_out_ch, cls_ch, 0.0,
                                    use_bn=False)
        self.reg_blocks = _ConvHead(width, reg_out_ch, reg_channels, 0.0,
                                    use_bn=False)

    def forward(self, pts_input):
        xyz = pts_input[..., 0:3].contiguous()
        xyz_feat = self.xyz_up_layer(pts_input[...,
                                               :self.rcnn_input_channel])
        rpn_feat = pts_input[..., self.rcnn_input_channel:]
        feats = self.merge_down_layer(torch.cat([xyz_feat, rpn_feat],
                                                dim=-1))
        for i in range(self.levels):
            xyz, feats = getattr(self, f"sa{i}")(xyz, feats)
        feat = feats[:, 0]  # group-all leaves one row
        return self.cls_blocks(feat), self.reg_blocks(feat)


class ProposalConfig:
    """The bin and NMS parameters of a head (the reference's
    ProposalLayer)."""

    def __init__(self, nms_pre=9000, nms_post=512, nms_thres=0.85,
                 nms_post_val=None, nms_thres_val=None, mean_size=[1.0],
                 loc_xz_fine=True, loc_scope=3.0, loc_bin_size=0.5,
                 num_head_bin=12, get_y_by_bin=False, get_ry_fine=False,
                 loc_y_scope=0.5, loc_y_bin_size=0.25, post_process=True):
        self.nms_pre = nms_pre
        self.nms_post = nms_post
        self.nms_thres = nms_thres
        self.nms_post_val = nms_post_val or nms_post
        self.nms_thres_val = nms_thres_val or nms_thres
        self.mean_size = mean_size
        self.loc_xz_fine = loc_xz_fine
        self.loc_scope = loc_scope
        self.loc_bin_size = loc_bin_size
        self.num_head_bin = num_head_bin
        self.get_y_by_bin = get_y_by_bin
        self.get_ry_fine = get_ry_fine
        self.loc_y_scope = loc_y_scope
        self.loc_y_bin_size = loc_y_bin_size
        self.post_process = post_process

    @property
    def reg_channels(self):
        per_loc = int(self.loc_scope / self.loc_bin_size) * 2
        loc_y_bins = int(self.loc_y_scope / self.loc_y_bin_size) * 2
        c = per_loc * 4 if self.loc_xz_fine else per_loc * 2
        c += self.num_head_bin * 2 + 3
        c += loc_y_bins * 2 if self.get_y_by_bin else 1
        return c

    def decode(self, roi_box3d, pred_reg, **override):
        """``decode_bbox_target`` with this head's bins."""
        kw = dict(get_xz_fine=self.loc_xz_fine,
                  get_y_by_bin=self.get_y_by_bin,
                  get_ry_fine=self.get_ry_fine, loc_y_scope=self.loc_y_scope,
                  loc_y_bin_size=self.loc_y_bin_size)
        kw.update(override)
        return decode_bbox_target(roi_box3d, pred_reg, self.loc_scope,
                                  self.loc_bin_size, self.num_head_bin,
                                  self.mean_size, **kw)


def _stable_top(scores, k):
    """The order of the k largest of scores [..., N], as ``lax.top_k``
    gives it: descending, the lower index first among equal values."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def proposal_layer(scores, reg, xyz, hc, training=False):
    """Decode and distance-bucketed rotated NMS of a batch's RPN outputs:
    scores [B, N], reg [B, N, C], xyz [B, N, 3] -> (boxes [B, P, 7],
    scores [B, P], valid [B, P]), P = the buckets' survivors (the near
    bucket's first: 0 <= z <= 40 m, 70% of ``nms_pre`` candidates and of
    ``nms_post`` survivors; then 40 < z <= 80 m, the rest). Both buckets
    go through one ``nms_bev`` call, padded to one size with invalid
    boxes. ``hc``: the RPN head's ``ProposalConfig``."""
    b, n = scores.shape
    boxes = hc.decode(xyz.reshape(-1, 3), reg.reshape(b * n, -1))
    boxes = boxes.reshape(b, n, 7)
    boxes = torch.cat([boxes[..., :1], boxes[..., 1:2] + boxes[..., 3:4] / 2,
                       boxes[..., 2:]], dim=-1)  # y at the bottom centre
    nms_post = hc.nms_post if training else hc.nms_post_val
    nms_thres = hc.nms_thres if training else hc.nms_thres_val
    nms_pre = min(hc.nms_pre, n)
    dist = boxes[..., 2]
    buckets = [((dist >= 0) & (dist <= 40.0), int(nms_pre * 0.7),
                int(nms_post * 0.7)),
               ((dist > 40.0) & (dist <= 80.0),
                nms_pre - int(nms_pre * 0.7),
                nms_post - int(nms_post * 0.7))]
    # caps can exceed the candidate count on tiny inputs
    buckets = [(m, p, min(q, p)) for m, p, q in buckets]
    width = max(p for _, p, _ in buckets)
    sel_b, sel_s = [], []
    for mask, pre_n, _ in buckets:
        sc = torch.where(mask, scores, -np.inf)
        top_i = _stable_top(sc, pre_n)
        top_s = torch.take_along_dim(sc, top_i, dim=1)
        bsel = torch.take_along_dim(boxes, top_i[..., None], dim=1)
        pad = width - pre_n
        sel_b.append(F.pad(bsel, (0, 0, 0, pad)))
        sel_s.append(F.pad(top_s, (0, pad), value=-np.inf))
    bsel = torch.stack(sel_b, dim=1)  # [B, 2, width, 7]
    top_s = torch.stack(sel_s, dim=1)
    bev = bsel[..., [0, 2, 5, 4, 6]]  # (x, z, l, w, ry)
    keep = nms_bev(bev, top_s, nms_thres, valid_mask=torch.isfinite(top_s))
    ksc = torch.where(keep, top_s, -np.inf)
    out_b, out_s = [], []
    for j, (_, _, post_n) in enumerate(buckets):
        post_i = _stable_top(ksc[:, j], post_n)
        out_b.append(torch.take_along_dim(bsel[:, j], post_i[..., None],
                                          dim=1))
        out_s.append(torch.take_along_dim(ksc[:, j], post_i, dim=1))
    out_s = torch.cat(out_s, dim=1)
    return torch.cat(out_b, dim=1), out_s, torch.isfinite(out_s)


class PointRCNNNet(nn.Module):
    """Both stages over a padded batch {"point": [B, N, 3]}, and in mode
    RCNN's training {"bboxes" [B, G, 7], "bbox_count" [B]} too.

    mode "RPN": {"cls", "reg", "xyz", "feats"}, the RPN's outputs; in
    train mode with BatchNorm's batch statistics and the heads' dropout.
    mode "RCNN": the RPN as in eval whatever the net's mode (``train``
    keeps it there; its outputs detached), the proposal layer (training's
    ``nms_post`` and ``nms_thres`` in train mode), then in eval
    ``roipool3d`` of the proposals and in train mode ``rcnn_targets`` on
    this step's draws (``draw``), and the RCNN net over every roi, its
    BatchNorm over all B * R rois, the slots not ok included: {"rois"
    [B, M, 7], "scores", "valid" [B, M], "cls" [B, R, 1], "reg"
    [B, R, C]} and in train mode the targets. The stages are methods of
    their own (``rpn``, ``proposals``, ``pool``, ``rcnn``), each timed
    alone where the stage split is measured.

    The state_dict of mode RPN holds the RPN only and its
    ``load_state_dict`` reads the RPN's entries only, as the JAX
    variables of mode RPN hold no rcnn subtree; mode RCNN's
    ``load_state_dict`` raises ``HANDOFF_FAULT`` on a state with no RCNN
    entries unless ``strict`` is false.
    """

    JAX_SCOPE = None  # the flax tree has no wrapper scope

    def __init__(self, rpn, rcnn, mode, rpn_head, target_cfg,
                 score_thres=0.3):
        super().__init__()
        self.rpn = rpn
        self.rcnn = rcnn
        self.mode = mode
        self.rpn_head = rpn_head
        self.target_cfg = dict(target_cfg)
        self.score_thres = score_thres
        self.manual_seed(0)

    def manual_seed(self, seed):
        """Seed the net's generators, each from one numpy generator of
        ``seed`` in turn: the dropout of each RPN head, then the roi
        sampling's (``draw``)."""
        rng = np.random.default_rng(seed)
        top = np.iinfo(np.int32).max
        for module in self.modules():
            if isinstance(module, Dropout):
                module.manual_seed(int(rng.integers(top)))
        self.sampling_seed = int(rng.integers(top))
        self._sampling = None

    def draw(self, b, m, device):
        """``draw_sampling`` from the net's sampling generator, made on
        ``device`` at first use there."""
        gen = self._sampling
        if gen is None or gen.device != torch.device(device):
            gen = torch.Generator(device=device).manual_seed(
                self.sampling_seed)
            self._sampling = gen
        return draw_sampling(gen, b, m, self.target_cfg, device)

    def train(self, mode=True):
        super().train(mode)
        if self.mode == "RCNN":
            self.rpn.train(False)  # stage 2 freezes the RPN
        return self

    def state_dict(self, *args, **kwargs):
        out = super().state_dict(*args, **kwargs)
        if self.mode == "RPN":
            for key in [k for k in out if k.startswith("rcnn.")]:
                del out[key]
        return out

    def load_state_dict(self, state_dict, strict=True, assign=False):
        if self.mode == "RPN":
            return self.rpn.load_state_dict(
                {k[len("rpn."):]: v for k, v in state_dict.items()
                 if k.startswith("rpn.")}, strict=strict, assign=assign)
        if strict and not any(k.startswith("rcnn.") for k in state_dict):
            raise KeyError(f"a state with no RCNN weights: {HANDOFF_FAULT}")
        return super().load_state_dict(state_dict, strict=strict,
                                       assign=assign)

    def proposals(self, cls, reg, xyz):
        return proposal_layer(cls[..., 0], reg, xyz, self.rpn_head,
                              self.training)

    def point_features(self, cls, xyz, feats):
        """The RCNN's per-point features [B, N, 2 + C]: the RPN's
        foreground mask at ``score_thres``, the depth / 70 m - 0.5, and
        the backbone's features."""
        seg_mask = (torch.sigmoid(cls[..., 0]) >
                    self.score_thres).to(feats.dtype)
        depth = torch.sqrt((xyz * xyz).sum(-1))
        return torch.cat([seg_mask[..., None],
                          (depth / 70.0 - 0.5)[..., None], feats], dim=-1)

    def pool(self, cls, xyz, feats, rois):
        """The rois' pooled points in their canonical frames:
        [B, R, P, 5 + C]."""
        pooled, _ = roipool3d(xyz, self.point_features(cls, xyz, feats),
                              rois, self.target_cfg["pool_extra_width"],
                              self.target_cfg["num_points"])
        return canonical(pooled, rois)

    def forward(self, inputs):
        points = inputs["point"]
        if self.mode == "RPN":
            cls, reg, xyz, feats = self.rpn(points)
            return {"cls": cls, "reg": reg, "xyz": xyz, "feats": feats}
        with torch.no_grad():
            cls, reg, xyz, feats = self.rpn(points)
        rois, roi_scores, roi_valid = self.proposals(cls, reg, xyz)
        out = {"rois": rois, "scores": roi_scores, "valid": roi_valid}
        if self.training:
            out.update(rcnn_targets(
                xyz, self.point_features(cls, xyz, feats), rois, roi_valid,
                inputs["bboxes"], inputs["bbox_count"],
                self.draw(rois.shape[0], rois.shape[1], points.device),
                self.target_cfg))
            pts_input = out["pts_input"]
        else:
            pts_input = self.pool(cls, xyz, feats, rois)
        b, r = pts_input.shape[:2]
        rcnn_cls, rcnn_reg = self.rcnn(pts_input.reshape(
            b * r, *pts_input.shape[2:]))
        out["cls"] = rcnn_cls.reshape(b, r, -1)
        out["reg"] = rcnn_reg.reshape(b, r, -1)
        return out


@MODEL.register_module()
class PointRCNN(ObjdetBaseModel):
    """PointRCNN: the host side of every split, the two-stage net, both
    stages' losses and optimizer, and the refined boxes."""

    def __init__(self,
                 name="PointRCNN",
                 classes=['Car'],
                 score_thres=0.3,
                 npoints=16384,
                 rpn={},
                 rcnn={},
                 mode="RCNN",
                 max_gt=24,
                 augment=None,
                 **kwargs):
        super().__init__(name=name, classes=classes, score_thres=score_thres,
                         npoints=npoints, rpn=rpn, rcnn=rcnn, mode=mode,
                         max_gt=max_gt, augment=augment, **kwargs)
        if mode not in ("RPN", "RCNN"):
            raise ValueError(f"PointRCNN mode {mode!r}: 'RPN' or 'RCNN'")
        self.mode = mode
        self.classes = classes
        self.name2lbl = {n: i for i, n in enumerate(classes)}
        self.lbl2name = {i: n for i, n in enumerate(classes)}
        self.npoints = npoints
        self.score_thres = score_thres
        self.max_gt = max_gt
        self.augmenter = ObjdetAugmentation(self.cfg.augment, seed=self.rng)

        rpn = dict(rpn or {})
        rcnn = dict(rcnn or {})
        self.rpn_head_cfg = ProposalConfig(**rpn.get("head", {}))
        self.rcnn_head_cfg = ProposalConfig(**rcnn.get("head", {
            "nms_pre": 100, "nms_post": 100, "get_ry_fine": True
        }))
        self.rpn_cfg = rpn
        self.rcnn_cfg = rcnn
        self.loss_cls = FocalLoss(**rpn.get("focal_loss", {}))
        self.loss_weight = rpn.get("loss_weight", [1.0, 1.0])
        target = dict(rcnn.get("target_head", {}) or {})
        self.pool_extra_width = target.get("pool_extra_width", 1.0)
        self.num_pooled_points = target.get("num_points", 512)

    def backbone_cfg(self):
        """The RPN backbone's ``Pointnet2MSG`` arguments."""
        backbone = dict(self.rpn_cfg.get("backbone", {}))
        # the reference config nests the multiscale spec under SA_config
        if "SA_config" in backbone:
            backbone = {**backbone, **dict(backbone["SA_config"])}
        return {
            "in_channels": backbone.get("in_channels", 0),
            "use_xyz": backbone.get("use_xyz", True),
            "sa_npoints": tuple(backbone.get(
                "npoints", [4096, 1024, 256, 64])),
            "sa_radii": tuple(map(tuple, backbone.get(
                "radius", [[0.1, 0.5], [0.5, 1.0], [1.0, 2.0],
                           [2.0, 4.0]]))),
            "sa_nsamples": tuple(map(tuple, backbone.get(
                "nsample", [[16, 32], [16, 32], [16, 32], [16, 32]]))),
            "sa_mlps": tuple(
                tuple(tuple(m) for m in lvl) for lvl in backbone.get(
                    "mlps", [[[16, 16, 32], [32, 32, 64]],
                             [[64, 64, 128], [64, 96, 128]],
                             [[128, 196, 256], [128, 196, 256]],
                             [[256, 256, 512], [256, 384, 512]]])),
            "fp_mlps": tuple(map(tuple, backbone.get(
                "fp_mlps", [[128, 128], [256, 256], [512, 512],
                            [512, 512]]))),
        }

    def get_net(self):
        rpn = self.rpn_cfg
        tc = dict(self.rcnn_cfg.get("target_head", {}) or {})
        return PointRCNNNet(
            rpn=RPNNet(self.backbone_cfg(),
                       cls_out_ch=tuple(rpn.get("cls_out_ch", [128])),
                       reg_out_ch=tuple(rpn.get("reg_out_ch", [128])),
                       reg_channels=self.rpn_head_cfg.reg_channels,
                       db_ratio=rpn.get("db_ratio", 0.5)),
            rcnn=self.get_rcnn_net(), mode=self.mode,
            rpn_head=self.rpn_head_cfg,
            target_cfg={
                "pool_extra_width": tc.get("pool_extra_width", 1.0),
                "num_points": tc.get("num_points", 512),
                "reg_fg_thresh": tc.get("reg_fg_thresh", 0.55),
                "cls_fg_thresh": tc.get("cls_fg_thresh", 0.6),
                "cls_bg_thresh": tc.get("cls_bg_thresh", 0.45),
                "cls_bg_thresh_lo": tc.get("cls_bg_thresh_lo", 0.05),
                "fg_ratio": tc.get("fg_ratio", 0.5),
                "roi_per_image": tc.get("roi_per_image", 64),
                "hard_bg_ratio": tc.get("hard_bg_ratio", 0.8),
                "roi_fg_aug_times": tc.get("roi_fg_aug_times", 10)},
            score_thres=self.score_thres)

    def get_rcnn_net(self):
        rcnn = self.rcnn_cfg
        sa = rcnn.get("SA_config", {
            "npoints": [128, 32, -1],
            "radius": [0.2, 0.4, 100],
            "nsample": [64, 64, 64],
            "mlps": [[128, 128, 128], [128, 128, 256], [256, 256, 512]],
        })
        return RCNNNet(
            num_classes=len(self.classes) + 1,
            sa_npoints=tuple(sa["npoints"]),
            sa_radius=tuple(sa["radius"]),
            sa_nsample=tuple(sa["nsample"]),
            sa_mlps=tuple(map(tuple, sa["mlps"])),
            xyz_up_layer=tuple(rcnn.get("xyz_up_layer", [128, 128])),
            cls_out_ch=tuple(rcnn.get("cls_out_ch", [256, 256])),
            reg_out_ch=tuple(rcnn.get("reg_out_ch", [256, 256])),
            reg_channels=self.rcnn_head_cfg.reg_channels,
            in_channels=self.backbone_cfg()["fp_mlps"][0][-1])

    def proposal_layer(self, rpn_scores, rpn_reg, xyz, training=False):
        """The proposal layer of one sample (rpn_scores [N], rpn_reg
        [N, C], xyz [N, 3]) or a batch ([B, ...]): (boxes [..., P, 7],
        scores [..., P], valid [..., P])."""
        single = rpn_scores.dim() == 1
        if single:
            rpn_scores, rpn_reg, xyz = rpn_scores[None], rpn_reg[None], \
                xyz[None]
        out = proposal_layer(rpn_scores, rpn_reg, xyz, self.rpn_head_cfg,
                             training)
        return tuple(t[0] for t in out) if single else out

    # ------------------------------------------------------------- host side

    def filter_objects(self, bbox_objs):
        return [bb for bb in bbox_objs if bb.label_class in self.classes]

    def preprocess(self, data, attr):
        """The points in the camera frame (``world2cam``), the calib, and
        but on the test split the boxes of the model's classes; the train
        split augments first."""
        if attr["split"] in ("train", "training"):
            data = self.augmenter.augment(dict(data), attr, seed=self.rng)
        data["bounding_boxes"] = self.filter_objects(
            data.get("bounding_boxes", []))
        points = np.array(data["point"][..., :3], dtype=np.float32)
        calib = data["calib"]
        points = DataProcessing.world2cam(points, calib["world_cam"])
        new_data = {"point": points, "calib": calib}
        if attr["split"] not in ("test", "testing"):
            new_data["bbox_objs"] = data["bounding_boxes"]
        return new_data

    @staticmethod
    def generate_rpn_training_labels(points, bboxes, bboxes_world,
                                     calib=None):
        """Per-point labels [N] (1 inside a box, -1 in the ring between a
        box and the box grown by 0.4 m, 0 elsewhere) and box targets
        [N, 7] (the box's centre minus the point, then h, w, l, ry) of
        camera-frame points [N, 3] for camera-frame boxes [M, 7] and the
        same boxes in the lidar frame [M, 7]; a later box overwrites an
        earlier one's points."""
        cls_label = np.zeros((points.shape[0]), dtype=np.int32)
        reg_label = np.zeros((points.shape[0], 7), dtype=np.float32)
        if len(bboxes) == 0:
            return cls_label, reg_label
        cam_world = DataProcessing.invT(calib["world_cam"])
        pts_idx = points_in_box(points.copy(), bboxes_world,
                                camera_frame=True, cam_world=cam_world)
        extended = bboxes_world.copy()
        extended[:, 3:6] += 0.4
        extended[:, 2] -= 0.2
        pts_idx_ext = points_in_box(points.copy(), extended,
                                    camera_frame=True, cam_world=cam_world)
        for k in range(bboxes.shape[0]):
            fg = pts_idx[:, k]
            cls_label[fg] = 1
            ignore = np.logical_xor(fg, pts_idx_ext[:, k])
            cls_label[ignore] = -1
            center3d = bboxes[k][0:3].copy()
            center3d[1] -= bboxes[k][3] / 2
            reg_label[fg, 0:3] = center3d - points[fg]
            reg_label[fg, 3] = bboxes[k][3]
            reg_label[fg, 4] = bboxes[k][4]
            reg_label[fg, 5] = bboxes[k][5]
            reg_label[fg, 6] = bboxes[k][6]
        return cls_label, reg_label

    def transform(self, data, attr, rng=None):
        """``npoints`` points drawn from the model's generator (the train
        and validation splits keep every point beyond 40 m when they can);
        on those splits, in mode RPN each point's label and box target
        (``generate_rpn_training_labels``), in mode RCNN the gt boxes
        padded to ``max_gt`` with their count."""
        rng = rng or self.rng
        points = data["point"]

        if attr["split"] not in ("test", "testing"):
            if self.npoints < len(points):
                depth = points[:, 2]
                near = np.where(depth < 40.0)[0]
                far = np.where(depth >= 40.0)[0]
                n_near = self.npoints - len(far)
                if n_near > 0 and len(near) >= n_near:
                    choice = np.concatenate(
                        [rng.choice(near, n_near, replace=False), far])
                else:
                    choice = rng.choice(len(points), self.npoints,
                                        replace=False)
                rng.shuffle(choice)
            else:
                choice = np.arange(len(points))
                if self.npoints > len(points):
                    extra = rng.choice(choice, self.npoints - len(points))
                    choice = np.concatenate([choice, extra])
                rng.shuffle(choice)
            points = points[choice, :]
        else:
            if self.npoints <= len(points):
                choice = rng.choice(len(points), self.npoints, replace=False)
            else:
                choice = np.concatenate([
                    np.arange(len(points)),
                    rng.choice(len(points), self.npoints - len(points))
                ])
            points = points[choice, :]

        t_data = {"point": points.astype(np.float32),
                  "calib": data["calib"]}
        if attr["split"] not in ("test", "testing"):
            bbox_objs = data.get("bbox_objs", [])
            bboxes = np.stack([bb.to_camera() for bb in bbox_objs]) \
                if bbox_objs else np.zeros((0, 7), np.float32)
            if self.mode == "RPN":
                bboxes_world = np.stack([bb.to_xyzwhlr()
                                         for bb in bbox_objs]) \
                    if bbox_objs else np.zeros((0, 7), np.float32)
                labels, reg = self.generate_rpn_training_labels(
                    points, bboxes, bboxes_world, data["calib"])
                t_data["labels"] = labels.astype(np.int32)
                t_data["bboxes"] = reg.astype(np.float32)
            else:
                g = self.max_gt
                padded = np.zeros((g, 7), np.float32)
                cnt = min(len(bboxes), g)
                padded[:cnt] = bboxes[:cnt]
                t_data["bboxes"] = padded
                t_data["bbox_count"] = np.int32(cnt)
                t_data["labels"] = np.zeros((g,), np.int32)
            t_data["bbox_objs"] = bbox_objs
        return t_data

    # ----------------------------------------------------------- device side

    def rpn_loss(self, results, inputs):
        """Stage 1's losses: {"cls": the focal loss of every point's score
        (the ignored ring weighs 0, the rest 1 / max(fg points, 1)),
        "reg": the bin loss of the foreground points' boxes
        (``get_reg_loss``: loc + angle + 3 * size)}, each times its
        ``loss_weight``."""
        hc = self.rpn_head_cfg
        rpn_cls = results["cls"].reshape(-1)
        rpn_reg = results["reg"].reshape(-1, hc.reg_channels)
        cls_label = inputs["labels"].reshape(-1)
        reg_label = inputs["bboxes"].reshape(-1, 7)

        pos = (cls_label > 0).to(torch.float32)
        neg = (cls_label == 0).to(torch.float32)
        cls_w = (pos + neg) / torch.clamp(pos.sum(), min=1.0)
        loss_cls = self.loss_cls(rpn_cls[:, None], pos[:, None],
                                 weight=cls_w[:, None], avg_factor=1.0)
        loss_loc, loss_angle, loss_size = get_reg_loss(
            rpn_reg, reg_label, hc.loc_scope, hc.loc_bin_size,
            hc.num_head_bin, hc.mean_size, pos,
            get_xz_fine=hc.loc_xz_fine, get_y_by_bin=False,
            get_ry_fine=False)
        loss_reg = loss_loc + loss_angle + 3 * loss_size
        return {"cls": loss_cls * self.loss_weight[0],
                "reg": loss_reg * self.loss_weight[1]}

    def rcnn_loss(self, results, inputs):
        """Stage 2's losses over the sampled rois: {"cls": the binary
        cross entropy of the rois labelled 0 or 1, "reg": the bin loss of
        the rois of ``reg_valid_mask`` against their canonical gt boxes
        (the fine heading; loc + angle + 3 * size)}."""
        hc = self.rcnn_head_cfg
        cls = results["cls"].reshape(-1)
        reg = results["reg"].reshape(-1, hc.reg_channels)
        label = results["cls_label"].reshape(-1)
        gt_ct = results["gt_of_rois"].reshape(-1, 7)

        valid = (label >= 0).to(torch.float32)
        p = torch.sigmoid(cls)
        bce = -(label * torch.log(p + 1e-7) +
                (1 - label) * torch.log(1 - p + 1e-7))
        loss_cls = torch.sum(bce * valid) / torch.clamp(valid.sum(), min=1.0)

        fg = results["reg_valid_mask"].reshape(-1).to(torch.float32)
        loss_loc, loss_angle, loss_size = get_reg_loss(
            reg, gt_ct, hc.loc_scope, hc.loc_bin_size, hc.num_head_bin,
            hc.mean_size, fg, get_xz_fine=True,
            get_y_by_bin=hc.get_y_by_bin, loc_y_scope=hc.loc_y_scope,
            loc_y_bin_size=hc.loc_y_bin_size, get_ry_fine=True)
        return {"cls": loss_cls,
                "reg": loss_loc + loss_angle + 3 * loss_size}

    def get_loss(self, results, inputs):
        """The loss dict of the model's mode: ``rpn_loss`` or
        ``rcnn_loss``."""
        if self.mode == "RPN":
            return self.rpn_loss(results, inputs)
        return self.rcnn_loss(results, inputs)

    def freeze_rpn_mask(self, net):
        """{parameter name: trainable} of ``net``: False on the RPN, which
        stage 2 freezes (the reference's point_rcnn.py:162-165)."""
        return {name: not name.startswith("rpn.")
                for name, _ in net.named_parameters()}

    def get_optimizer(self, cfg_pipeline, net):
        """(AdamW, None): the pipeline's ``optimizer`` lr (0.002), betas
        ((0.9, 0.99)) and weight_decay (0.001), eps 1e-8, a constant
        learning rate, as ``optax.adamw``, over the RPN's parameters in
        mode RPN (the JAX variables of mode RPN hold no others) and over
        those ``freeze_rpn_mask`` leaves trainable in mode RCNN: no step
        and no decay on the RPN, whose gradients ``stop_gradient`` zeroes
        in JAX. No gradient clipping: the JAX pipeline never reads
        ``grad_clip_norm``."""
        opt = dict(cfg_pipeline.get("optimizer") or {})
        betas = opt.get("betas", [0.9, 0.99])
        if self.mode == "RPN":
            params = list(net.rpn.parameters())
        else:
            mask = self.freeze_rpn_mask(net)
            params = [p for name, p in net.named_parameters() if mask[name]]
        optimizer = torch.optim.AdamW(
            params, lr=opt.get("lr", 0.002), betas=(betas[0], betas[1]),
            weight_decay=opt.get("weight_decay", 0.001), eps=1e-8)
        return optimizer, None

    def refine(self, results):
        """The RCNN's boxes around their rois, on the outputs' device:
        (boxes [B, R, 7], scores [B, R], valid [B, R]), valid the rois
        above ``score_thres`` that the refinement NMS keeps."""
        hc = self.rcnn_head_cfg
        rois = results["rois"]
        b, r = rois.shape[:2]
        boxes = hc.decode(rois.reshape(b * r, 7),
                          results["reg"].reshape(b * r, -1),
                          get_xz_fine=True, get_ry_fine=True)
        boxes = boxes.reshape(b, r, 7)
        scores = torch.sigmoid(results["cls"][..., 0])
        m = results["valid"] & (scores > self.score_thres)
        bev = boxes[..., [0, 2, 5, 4, 6]]
        keep = nms_bev(bev, torch.where(m, scores, -np.inf), hc.nms_thres,
                       valid_mask=m)
        return boxes, scores, keep & m

    def inference_end(self, results, inputs):
        """Network outputs -> one list of ``BEVBox3D`` a sample. Mode RPN
        gives empty lists; mode RCNN the refined boxes (``refine``) in the
        lidar frame where the batch has a calib."""
        if self.mode == "RPN":
            return [[] for _ in range(results["cls"].shape[0])]
        with torch.no_grad():
            refined = self.refine(results)
        boxes_b, scores_b, valid_b = (t.cpu().numpy() for t in refined)
        b = boxes_b.shape[0]
        calibs = inputs.get("calib")
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
            world_cam = calib.get("world_cam") if calib else None
            cam_img = calib.get("cam_img") if calib else None
            for box, score, ok in zip(boxes_b[i], scores_b[i], valid_b[i]):
                if not ok or score < self.score_thres:
                    continue
                pos = box[:3]
                dim = box[[4, 3, 5]]
                pos = DataProcessing.cam2world(pos.reshape((1, -1)),
                                               world_cam).flatten() \
                    if world_cam is not None else pos
                pos = pos + [0, 0, dim[1] / 2]
                yaw = box[-1]
                name = self.lbl2name.get(0, "ignore")
                out[-1].append(
                    BEVBox3D(pos, dim, yaw, name, float(score), world_cam,
                             cam_img))
        return out
