"""Anchors, box coding and BEV conversions of the detection heads.

Counterpart of ``open3d_ml_tpu/models/objdet_helper.py``:
``Anchor3DRangeGenerator`` makes the anchors as numpy constants (the
feature map's size is fixed by the config); ``BBoxCoder`` and the BEV
conversions and the axis-aligned ``bbox_overlaps`` of anchor assignment
work on torch tensors.
"""

import numpy as np
import torch


def limit_period(val, offset=0.5, period=np.pi):
    """Limit a tensor into [-offset * period, (1 - offset) * period)."""
    # a divisor on the tensor's device: CUDA multiplies by the reciprocal
    # of a host scalar, which can round differently from the division
    return val - torch.floor(val / val.new_full((), period) + offset) * period


def xywhr_to_xyxyr(boxes_xywhr):
    """Rotated boxes (cx, cy, w, h, r) [N, 5] -> (x1, y1, x2, y2, r)."""
    half_w = boxes_xywhr[:, 2] / 2
    half_h = boxes_xywhr[:, 3] / 2
    return torch.stack([
        boxes_xywhr[:, 0] - half_w, boxes_xywhr[:, 1] - half_h,
        boxes_xywhr[:, 0] + half_w, boxes_xywhr[:, 1] + half_h,
        boxes_xywhr[:, 4]
    ], dim=-1)


def box3d_to_bev(boxes3d):
    """(x, y, z, w, l, h, r) [..., 7] -> BEV (x, y, w, l, r) [..., 5]."""
    return boxes3d[..., [0, 1, 3, 4, 6]]


def box3d_to_bev2d(boxes3d):
    """(x, y, z, w, l, h, r) [..., 7] -> the nearest axis-aligned BEV box
    (x1, y1, x2, y2): w and l swap where the rotation, brought into
    [-pi/2, pi/2), exceeds pi/4 in size."""
    bev = box3d_to_bev(boxes3d)
    rot = torch.abs(limit_period(bev[..., -1], 0.5, np.pi))
    cond = (rot > np.pi / 4)[..., None]
    bboxes_xywh = torch.where(cond, bev[..., [0, 1, 3, 2]], bev[..., :4])
    centers = bboxes_xywh[..., :2]
    dims = bboxes_xywh[..., 2:]
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1)


def bbox_overlaps(bboxes1, bboxes2):
    """Axis-aligned IoU [..., m, n] of (x1, y1, x2, y2) boxes [..., m, 4]
    and [..., n, 4] (leading dims broadcast), the union clamped at 1e-6."""
    lt = torch.maximum(bboxes1[..., :, None, :2], bboxes2[..., None, :, :2])
    rb = torch.minimum(bboxes1[..., :, None, 2:], bboxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    overlap = wh[..., 0] * wh[..., 1]
    area1 = ((bboxes1[..., 2] - bboxes1[..., 0]) *
             (bboxes1[..., 3] - bboxes1[..., 1]))[..., :, None]
    area2 = ((bboxes2[..., 2] - bboxes2[..., 0]) *
             (bboxes2[..., 3] - bboxes2[..., 1]))[..., None, :]
    union = area1 + area2 - overlap
    return overlap / torch.clamp(union, min=1e-6)


class Anchor3DRangeGenerator:
    """Anchors on a grid over each anchor range (numpy)."""

    def __init__(self, ranges, sizes=[[1.6, 3.9, 1.56]],
                 rotations=[0, 1.5707963]):
        if len(sizes) != len(ranges):
            assert len(ranges) == 1
            ranges = ranges * len(sizes)
        assert len(ranges) == len(sizes)
        self.sizes = sizes
        self.ranges = ranges
        self.rotations = rotations

    @property
    def num_base_anchors(self):
        return len(self.rotations) * np.array(self.sizes).reshape(-1,
                                                                  3).shape[0]

    def grid_anchors(self, featmap_size):
        """Anchors [H, W, num_sizes, num_rots, 7] (z collapsed)."""
        mr_anchors = []
        for anchor_range, anchor_size in zip(self.ranges, self.sizes):
            mr_anchors.append(
                self.anchors_single_range(featmap_size, anchor_range,
                                          anchor_size, self.rotations))
        # one range per size: concatenate along the size axis
        return np.concatenate(mr_anchors, axis=-3)

    def anchors_single_range(self, feature_size, anchor_range, sizes,
                             rotations):
        """[H, W, num_sizes, num_rots, 7] anchors of one range."""
        if len(feature_size) == 2:
            feature_size = [1, feature_size[0], feature_size[1]]
        anchor_range = np.asarray(anchor_range, np.float32)
        z_centers = np.linspace(anchor_range[2], anchor_range[5],
                                feature_size[0], dtype=np.float32)
        y_centers = np.linspace(anchor_range[1], anchor_range[4],
                                feature_size[1], dtype=np.float32)
        x_centers = np.linspace(anchor_range[0], anchor_range[3],
                                feature_size[2], dtype=np.float32)
        sizes = np.asarray(sizes, np.float32).reshape(-1, 3)
        rotations = np.asarray(rotations, np.float32)

        # meshgrid in (x, y, z, rot) order, 'ij' indexing
        xg, yg, zg, rg = np.meshgrid(x_centers, y_centers, z_centers,
                                     rotations, indexing="ij")
        num_sizes = sizes.shape[0]
        shape = xg.shape  # (W, H, D, R)
        out = np.zeros(shape[:3] + (num_sizes, shape[3], 7), np.float32)
        for s in range(num_sizes):
            out[..., s, :, 0] = xg
            out[..., s, :, 1] = yg
            out[..., s, :, 2] = zg
            out[..., s, :, 3:6] = sizes[s]
            out[..., s, :, 6] = rg
        # (W, H, D, S, R, 7) -> (D, H, W, S, R, 7); D == 1
        out = out.transpose(2, 1, 0, 3, 4, 5)
        return out[0]


class BBoxCoder:
    """Deltas between anchors and boxes [..., 7] (x, y, z, w, l, h, r):
    x and y over the anchor's BEV diagonal, z over its height, the sizes
    as log ratios; z is moved to the box's middle while coding."""

    @staticmethod
    def encode(src_boxes, dst_boxes):
        xa, ya, za, wa, la, ha, ra = torch.split(src_boxes, 1, dim=-1)
        xg, yg, zg, wg, lg, hg, rg = torch.split(dst_boxes, 1, dim=-1)
        za = za + ha / 2
        zg = zg + hg / 2
        diagonal = torch.sqrt(la**2 + wa**2)
        xt = (xg - xa) / diagonal
        yt = (yg - ya) / diagonal
        zt = (zg - za) / ha
        lt = torch.log(lg / la)
        wt = torch.log(wg / wa)
        ht = torch.log(hg / ha)
        rt = rg - ra
        return torch.cat([xt, yt, zt, wt, lt, ht, rt], dim=-1)

    @staticmethod
    def decode(anchors, deltas):
        xa, ya, za, wa, la, ha, ra = torch.split(anchors, 1, dim=-1)
        xt, yt, zt, wt, lt, ht, rt = torch.split(deltas, 1, dim=-1)
        za = za + ha / 2
        diagonal = torch.sqrt(la**2 + wa**2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * ha + za
        lg = torch.exp(lt) * la
        wg = torch.exp(wt) * wa
        hg = torch.exp(ht) * ha
        rg = rt + ra
        zg = zg - hg / 2
        return torch.cat([xg, yg, zg, wg, lg, hg, rg], dim=-1)
