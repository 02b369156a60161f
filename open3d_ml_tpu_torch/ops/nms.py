"""Greedy rotated-BEV NMS over a fixed number of boxes, on the device.

Counterpart of ``open3d_ml_tpu/ops/nms.py``: the boxes of every row of a
batch (every sample and class, or every proposal bucket) are put in score
order by one stable sort, the higher score first and the lower index
first among equal scores, as the JAX ``jnp.argsort(-scores)`` orders
them; the greedy pass over them is the ``nms_bev`` wrapper
(``ops/cuda/nms.py``): the plain version for CPU tensors, the CUDA kernels
for CUDA ones.
"""

import torch

from .cuda import nms as cnms


def nms_bev(boxes, scores, iou_threshold, *, valid_mask=None):
    """Greedy rotated-BEV NMS, batched over leading dims.

    Args:
        boxes: [..., N, 5] (x, y, w, h, angle).
        scores: [..., N].
        iou_threshold: a box is suppressed by a kept box of higher score
            (ties: the lower index first) that it overlaps by more.
        valid_mask: optional [..., N] bool; False boxes are suppressed
            from the start and suppress nothing.

    Returns [..., N] bool, the surviving boxes in their original order.
    """
    n = boxes.shape[-2]
    lead = scores.shape[:-1]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    sboxes = torch.take_along_dim(boxes, order[..., None], dim=-2)
    valid = (torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
             if valid_mask is None else
             torch.take_along_dim(valid_mask, order, dim=-1))
    keep = cnms.nms_bev(sboxes.reshape(-1, n, 5).contiguous(),
                        valid.reshape(-1, n).contiguous(),
                        iou_threshold).reshape(*lead, n)
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
