"""Rotated and axis-aligned box IoU, for numpy arrays and torch tensors.

Counterpart of ``open3d_ml_tpu/ops/iou.py``: the rotated-rectangle
intersection is computed without branches, from fixed candidate sets (the
16 edge intersections and the 8 corners of either box inside the other),
so one algorithm serves both array types. Each function takes numpy
arrays (the host's mAP, the same numpy operations in the same order as
the JAX package's numpy path, so the same bits) or torch tensors (the NMS
of the detection decode, on the tensors' device), and returns the same
type.

BEV box format: [x, y, w, h, angle]: center, extents, rotation (radians).
"""

import numpy as np
import torch

_EPS = 1e-8


class _Numpy:
    """The array operations the algorithm uses, on numpy arrays."""

    stack = staticmethod(np.stack)
    cat = staticmethod(np.concatenate)
    cos = staticmethod(np.cos)
    sin = staticmethod(np.sin)
    abs = staticmethod(np.abs)
    atan2 = staticmethod(np.arctan2)
    where = staticmethod(np.where)
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)
    broadcast = staticmethod(np.broadcast_arrays)
    broadcast_to = staticmethod(np.broadcast_to)
    take_along = staticmethod(np.take_along_axis)

    @staticmethod
    def roll(x, shift, axis):
        return np.roll(x, shift, axis=axis)

    @staticmethod
    def argsort(x, axis):
        return np.argsort(x, axis=axis)

    @staticmethod
    def sum(x, axis):
        return x.sum(axis=axis)

    @staticmethod
    def like(mask, x):
        return mask.astype(x.dtype)


class _Torch:
    """The same operations on torch tensors."""

    cos = staticmethod(torch.cos)
    sin = staticmethod(torch.sin)
    abs = staticmethod(torch.abs)
    atan2 = staticmethod(torch.atan2)
    where = staticmethod(torch.where)
    broadcast = staticmethod(torch.broadcast_tensors)
    broadcast_to = staticmethod(torch.broadcast_to)

    @staticmethod
    def stack(xs, axis):
        return torch.stack(xs, dim=axis)

    @staticmethod
    def cat(xs, axis):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def maximum(a, b):
        return torch.clamp(a, min=b) if isinstance(b, float) else \
            torch.maximum(a, b)

    @staticmethod
    def minimum(a, b):
        return torch.minimum(a, b)

    @staticmethod
    def take_along(x, idx, axis):
        return torch.take_along_dim(x, idx, dim=axis)

    @staticmethod
    def roll(x, shift, axis):
        return torch.roll(x, shift, dims=axis)

    @staticmethod
    def argsort(x, axis):
        return torch.argsort(x, dim=axis, stable=True)

    @staticmethod
    def sum(x, axis):
        return x.sum(dim=axis)

    @staticmethod
    def like(mask, x):
        return mask.to(x.dtype)


def _xp(a):
    return _Torch if isinstance(a, torch.Tensor) else _Numpy


def _box_corners(xp, boxes):
    """[..., 5] -> [..., 4, 2] corners in counter-clockwise order."""
    x, y, w, h, a = (boxes[..., i] for i in range(5))
    dx = xp.stack([w, w, -w, -w], axis=-1) * 0.5
    dy = xp.stack([-h, h, h, -h], axis=-1) * 0.5
    cos, sin = xp.cos(a)[..., None], xp.sin(a)[..., None]
    cx = x[..., None] + dx * cos - dy * sin
    cy = y[..., None] + dx * sin + dy * cos
    return xp.stack([cx, cy], axis=-1)


def _points_in_box(xp, pts, boxes):
    """pts [..., K, 2] inside the rotated rectangles boxes [..., 5] ->
    bool [..., K]."""
    x, y, w, h, a = (boxes[..., i] for i in range(5))
    cos, sin = xp.cos(a)[..., None], xp.sin(a)[..., None]
    px = pts[..., 0] - x[..., None]
    py = pts[..., 1] - y[..., None]
    lx = px * cos + py * sin
    ly = -px * sin + py * cos
    return (xp.abs(lx) <= w[..., None] * 0.5 + _EPS) & \
           (xp.abs(ly) <= h[..., None] * 0.5 + _EPS)


def _rotated_intersection_area(xp, boxes1, boxes2):
    """Intersection area of two rotated rectangles, elementwise over the
    leading dims of boxes1, boxes2 [..., 5] (of one shape)."""
    c1 = _box_corners(xp, boxes1)  # [..., 4, 2]
    c2 = _box_corners(xp, boxes2)

    # candidates: the corners of each box inside the other (8) ...
    in2 = _points_in_box(xp, c1, boxes2)  # [..., 4]
    in1 = _points_in_box(xp, c2, boxes1)

    # ... and the pairwise edge intersections (16)
    p1 = c1[..., :, None, :]  # [..., 4, 1, 2] edge starts of box 1
    p2 = xp.roll(c1, -1, axis=-2)[..., :, None, :]  # edge ends
    q1 = c2[..., None, :, :]  # [..., 1, 4, 2]
    q2 = xp.roll(c2, -1, axis=-2)[..., None, :, :]

    d1 = p2 - p1
    d2 = q2 - q1
    den = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]  # [..., 4, 4]
    diff = q1 - p1
    t_num = diff[..., 0] * d2[..., 1] - diff[..., 1] * d2[..., 0]
    s_num = diff[..., 0] * d1[..., 1] - diff[..., 1] * d1[..., 0]
    den_safe = xp.where(xp.abs(den) > _EPS, den, 1.0)
    t = t_num / den_safe
    s = s_num / den_safe
    hit = (xp.abs(den) > _EPS) & (t >= -_EPS) & (t <= 1 + _EPS) & \
          (s >= -_EPS) & (s <= 1 + _EPS)
    ipt = p1 + t[..., None] * d1  # [..., 4, 4, 2]

    lead = tuple(den.shape[:-2])
    cand = xp.cat([c1, c2, ipt.reshape(lead + (16, 2))], axis=-2)  # [..., 24, 2]
    mask = xp.cat([in2, in1, hit.reshape(lead + (16,))], axis=-1)

    cnt = xp.sum(mask, -1)
    maskf = xp.like(mask, cand)[..., None]
    center = xp.sum(cand * maskf, -2) / \
        xp.maximum(xp.sum(maskf, -2), 1.0)  # [..., 2]
    rel = cand - center[..., None, :]
    ang = xp.atan2(rel[..., 1], rel[..., 0])
    ang = xp.where(mask, ang, 1e9)
    order = xp.argsort(ang, -1)
    sorted_pts = xp.take_along(cand, order[..., None], -2)
    sorted_mask = xp.take_along(mask, order, -1)
    # invalid (trailing) points repeat the first one, so the shoelace sum
    # closes the polygon and their terms vanish
    first = sorted_pts[..., :1, :]
    poly = xp.where(sorted_mask[..., None], sorted_pts,
                    xp.broadcast_to(first, sorted_pts.shape))
    nxt = xp.roll(poly, -1, axis=-2)
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    area = 0.5 * xp.abs(xp.sum(cross, -1))
    return xp.where(cnt >= 3, area, 0.0)


def iou_bev(boxes1, boxes2):
    """Rotated BEV IoU matrix [..., N, M] of boxes [..., N, 5] and
    [..., M, 5] (x, y, w, h, ry); leading dims broadcast."""
    xp = _xp(boxes1)
    b1b, b2b = xp.broadcast(boxes1[..., :, None, :], boxes2[..., None, :, :])
    inter = _rotated_intersection_area(xp, b1b, b2b)
    a1 = (boxes1[..., 2] * boxes1[..., 3])[..., :, None]
    a2 = (boxes2[..., 2] * boxes2[..., 3])[..., None, :]
    union = a1 + a2 - inter
    return inter / xp.maximum(union, _EPS)


def iou_3d(boxes1, boxes2):
    """Rotated 3D IoU matrix [N, M] of boxes [N, 7] and [M, 7].

    Box format [x, y, z, w, h, l, ry], y the bottom of the box and h its
    vertical extent: KITTI's camera frame (``BEVBox3D.to_camera``), x and
    z spanning the horizontal plane.
    """
    xp = _xp(boxes1)
    bev1 = xp.stack([boxes1[:, 0], boxes1[:, 2], boxes1[:, 3], boxes1[:, 5],
                     boxes1[:, 6]], axis=-1)
    bev2 = xp.stack([boxes2[:, 0], boxes2[:, 2], boxes2[:, 3], boxes2[:, 5],
                     boxes2[:, 6]], axis=-1)
    inter_bev = _rotated_intersection_area(
        xp, *xp.broadcast(bev1[:, None, :], bev2[None, :, :]))
    # the vertical overlap of [y, y + h]
    ymin1, ymax1 = boxes1[:, 1], boxes1[:, 1] + boxes1[:, 4]
    ymin2, ymax2 = boxes2[:, 1], boxes2[:, 1] + boxes2[:, 4]
    overlap = xp.maximum(
        xp.minimum(ymax1[:, None], ymax2[None, :]) -
        xp.maximum(ymin1[:, None], ymin2[None, :]), 0.0)
    inter = inter_bev * overlap
    v1 = (boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])[:, None]
    v2 = (boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])[None, :]
    return inter / xp.maximum(v1 + v2 - inter, _EPS)


def iou_3d_elementwise(boxes1, boxes2):
    """Rotated 3D IoU of boxes1 [..., 7] and boxes2 [..., 7] pair by pair
    (leading dims of one shape) -> [...], in ``iou_3d``'s convention
    [x, y, z, w, h, l, ry]: one IoU a (candidate, gt) pair, as
    PointRCNN's roi sampling and jitter take them."""
    xp = _xp(boxes1)
    bev1 = xp.stack([boxes1[..., 0], boxes1[..., 2], boxes1[..., 3],
                     boxes1[..., 5], boxes1[..., 6]], axis=-1)
    bev2 = xp.stack([boxes2[..., 0], boxes2[..., 2], boxes2[..., 3],
                     boxes2[..., 5], boxes2[..., 6]], axis=-1)
    inter_bev = _rotated_intersection_area(xp, bev1, bev2)
    ymin1, ymax1 = boxes1[..., 1], boxes1[..., 1] + boxes1[..., 4]
    ymin2, ymax2 = boxes2[..., 1], boxes2[..., 1] + boxes2[..., 4]
    overlap = xp.maximum(
        xp.minimum(ymax1, ymax2) - xp.maximum(ymin1, ymin2), 0.0)
    inter = inter_bev * overlap
    v1 = boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5]
    v2 = boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5]
    return inter / xp.maximum(v1 + v2 - inter, _EPS)
