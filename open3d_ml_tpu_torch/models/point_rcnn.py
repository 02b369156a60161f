"""PointRCNN two-stage 3D object detection: serving.

Counterpart of ``open3d_ml_tpu/models/point_rcnn.py``, the eval half:
stage 1 (the RPN: the PointNet++ MSG backbone with a per-point
foreground score and a bin-based box regression) and stage 2 (the RCNN:
the proposals decoded and put through a rotated NMS per distance
bucket, the points of each proposal pooled into its canonical frame,
and the refinement net), and the host side of every split. Everything
runs in KITTI's camera frame (y down, a box's y at its bottom face), as
in JAX.

The JAX net vmaps the RPN over the samples and the RCNN over the rois of
a batch; the port runs each on the whole batch at once: the RPN on
[B, N, 3], the proposal layer on [B, N] with both buckets in one
``nms_bev`` call (the far bucket padded to the near one's size with
invalid boxes), and the RCNN on [B * rois, 512, 133]. At the shipped
config one frame of 16,384 points launches 14 ``knn_exact`` (8 RPN ball
queries at k = 16 and 32, 4 three-NN at k = 3, 2 RCNN ball queries at
k = 64), 6 ``fps`` and 1 ``nms_bev`` (the proposal layer's two buckets);
``inference_end`` launches one more ``nms_bev`` (the refined boxes).

Where ``jax.lax.top_k`` decides an output, its ties go to the lower
index: the port takes a stable descending sort there (the buckets'
candidates and survivors, whose ``-inf`` fills tie), and ``roipool3d``
orders its keys (index, or N + index outside the box) so that no two
tie.

Modes: ``mode="RPN"`` returns the RPN's outputs and ``inference_end``
empty lists (the shipped YAML's ``mode: RPN``, its first training
stage); ``mode="RCNN"`` serves boxes. Training is not ported:
``get_loss``, ``get_optimizer`` and the pipeline's ``run_train`` raise
``NotImplementedError``, naming ``TRAIN_QUEUE``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..datasets.augment import ObjdetAugmentation
from ..datasets.utils import BEVBox3D, DataProcessing
from ..ops.nms import nms_bev
from ..utils.registry import MODEL
from .base_model_objdet import ObjdetBaseModel
from .pointnet2 import (Pointnet2MSG, PointnetSAModule, SharedMLP2d,
                        gather_rows)

TRAIN_QUEUE = ("ROADMAP.md queue 1 item 6b (PointRCNN training: "
               "sample_rois_for_rcnn, aug_roi_by_noise, rcnn_targets, "
               "rpn_loss, rcnn_loss, generate_rpn_training_labels and the "
               "masked AdamW)")


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
    """Both stages over a padded batch {"point": [B, N, 3]}.

    mode "RPN": {"cls", "reg", "xyz", "feats"}, the RPN's outputs.
    mode "RCNN" (eval): the RPN, the proposal layer, ``roipool3d`` and the
    RCNN net: {"rois" [B, R, 7], "scores", "valid" [B, R], "cls"
    [B, R, 1], "reg" [B, R, C]}. The stages are methods of their own
    (``rpn``, ``proposals``, ``pool``, ``rcnn``), each timed alone where
    the stage split is measured. Training in mode RCNN is not ported.
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

    def proposals(self, cls, reg, xyz):
        return proposal_layer(cls[..., 0], reg, xyz, self.rpn_head,
                              self.training)

    def pool(self, cls, xyz, feats, rois):
        """The rois' pooled points in their canonical frames:
        [B, R, P, 5 + C]."""
        seg_mask = (torch.sigmoid(cls[..., 0]) >
                    self.score_thres).to(feats.dtype)
        depth = torch.sqrt((xyz * xyz).sum(-1))
        pts_feature = torch.cat([seg_mask[..., None],
                                 (depth / 70.0 - 0.5)[..., None], feats],
                                dim=-1)
        pooled, _ = roipool3d(xyz, pts_feature,
                              rois, self.target_cfg["pool_extra_width"],
                              self.target_cfg["num_points"])
        pts = pooled[..., 0:3] - rois[:, :, None, 0:3]
        ang = rois[..., 6:7].expand(pts.shape[:3])
        pts = rotate_pc_along_y(pts, ang)
        return torch.cat([pts, pooled[..., 3:]], dim=-1)

    def forward(self, inputs):
        points = inputs["point"]
        cls, reg, xyz, feats = self.rpn(points)
        if self.mode == "RPN":
            return {"cls": cls, "reg": reg, "xyz": xyz, "feats": feats}
        if self.training:
            raise NotImplementedError(
                f"PointRCNN's RCNN-mode training is not ported: "
                f"{TRAIN_QUEUE}")
        rois, roi_scores, roi_valid = self.proposals(cls, reg, xyz)
        pts_input = self.pool(cls, xyz, feats, rois)
        b, r = pts_input.shape[:2]
        rcnn_cls, rcnn_reg = self.rcnn(pts_input.reshape(
            b * r, *pts_input.shape[2:]))
        return {"rois": rois, "scores": roi_scores, "valid": roi_valid,
                "cls": rcnn_cls.reshape(b, r, -1),
                "reg": rcnn_reg.reshape(b, r, -1)}


@MODEL.register_module()
class PointRCNN(ObjdetBaseModel):
    """PointRCNN: the host side of every split, the two-stage net and the
    refined boxes. Serving only (``TRAIN_QUEUE``)."""

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
            target_cfg={"pool_extra_width": tc.get("pool_extra_width", 1.0),
                        "num_points": tc.get("num_points", 512)},
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

    def transform(self, data, attr, rng=None):
        """``npoints`` points drawn from the model's generator (the train
        and validation splits keep every point beyond 40 m when they can);
        in mode RCNN the gt boxes padded to ``max_gt`` with their count.
        Mode RPN's train-split labels are training's
        (``generate_rpn_training_labels``, ``TRAIN_QUEUE``)."""
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
            if self.mode == "RPN":
                raise NotImplementedError(
                    f"PointRCNN's RPN labels for the {attr['split']} split "
                    f"are training's: {TRAIN_QUEUE}")
            bboxes = np.stack([bb.to_camera() for bb in bbox_objs]) \
                if bbox_objs else np.zeros((0, 7), np.float32)
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

    def get_loss(self, results, inputs):
        raise NotImplementedError(f"PointRCNN's losses are not ported: "
                                  f"{TRAIN_QUEUE}")

    def get_optimizer(self, cfg_pipeline, net):
        raise NotImplementedError(f"PointRCNN's optimizer is not ported: "
                                  f"{TRAIN_QUEUE}")

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
