"""Greedy rotated-BEV NMS over a fixed number of boxes, on the device.

Counterpart of ``open3d_ml_tpu/ops/nms.py``. The candidates are few and
fixed in number (a decode keeps ``nms_pre`` of them), so the whole IoU
matrix is computed at once, in score order, for every row of a batch
(every sample and class) together.

Greedy NMS keeps box j (in score order) when it is valid and no kept box
before it suppresses it. That recurrence has one solution, and iterating
it on all boxes at once from "every valid box kept" reaches it: after t
rounds the first t boxes are settled, so it stops at a fixed point within
N + 1 rounds, mostly within a few (the longest chain of suppressions).
Each round is a few whole-matrix kernels and one host check, where
walking the boxes one by one would be three launches a box.
"""

import torch

from .iou import iou_bev


def nms_bev(boxes, scores, iou_threshold, *, valid_mask=None):
    """Greedy rotated-BEV NMS, batched over leading dims.

    Args:
        boxes: [..., N, 5] (x, y, w, h, angle).
        scores: [..., N].
        iou_threshold: a box is suppressed by a kept box of higher score
            (ties: the lower index first) that it overlaps by more.
        valid_mask: optional [..., N] bool; False boxes are suppressed
            from the start.

    Returns [..., N] bool, the surviving boxes in their original order.
    """
    n = boxes.shape[-2]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    sboxes = torch.take_along_dim(boxes, order[..., None], dim=-2)
    later = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    suppress = (iou_bev(sboxes, sboxes) > iou_threshold) & later
    valid = (torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
             if valid_mask is None else
             torch.take_along_dim(valid_mask, order, dim=-1))
    keep = valid
    for _ in range(n + 1):
        new = valid & ~(suppress & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros_like(keep).scatter_(-1, order, keep)


def multiclass_nms(boxes, scores, iou_threshold=0.25, score_threshold=0.0,
                   *, valid_mask=None):
    """Rotated NMS for each class column on its own.

    Args:
        boxes: [N, 5] BEV boxes shared by the classes.
        scores: [N, C] scores per class.

    Returns [N, C] bool: box n kept for class c.
    """
    m = scores > score_threshold
    if valid_mask is not None:
        m &= valid_mask[:, None]
    m = m.T
    keep = nms_bev(boxes.expand(m.shape[0], *boxes.shape),
                   torch.where(m, scores.T, float("-inf")), iou_threshold,
                   valid_mask=m)
    return keep.T
