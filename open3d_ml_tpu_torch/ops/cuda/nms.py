"""Greedy rotated-BEV NMS over boxes in score order: the CUDA kernel, its
plain version and the wrapper that ``ops/nms.py`` calls.

The wrapper takes the plain version for tensors on the CPU and launches
the ``nms_bev`` kernels (``csrc/nms_bev.cu``: the suppression mask, then
the sweep) for tensors on a CUDA device; it has no other route.
``LAUNCHES`` counts the wrapper's launches, one a call (two kernels).

The contract is the JAX package's ``nms_bev`` (``open3d_ml_tpu/ops/nms.py``)
after its sort: boxes [R, N, 5] (x, y, w, h, angle) in score order, the
higher score first; box j is kept when it is valid and no kept box i < j
has a rotated BEV IoU with it above the threshold; an invalid box is never
kept and suppresses nothing. The IoU is ``ops/iou.py``'s
``_rotated_intersection_area`` over the union. The kernel computes every
step of it in the plain version's order with round-to-nearest intrinsics
and the same cosf, sinf and atan2f, but takes the centroid's and the
shoelace's sums over the candidates in one fixed order (slot order, then
sorted order), where torch's sums over 24 entries have none: its IoU may
differ from the plain version's in the last bits, so a keep decision may
differ only for a pair whose IoU lies within a few ulps of the threshold.
"""

import torch

from ..iou import iou_bev
from ._launch import check, raise_on, route, stream

LAUNCHES = {"nms_bev": 0}

WORD = 64  # boxes a suppression word of the kernel's mask
# pairs in one block of rows of the plain version's IoU matrix: about
# 2.6 kB of intermediates a pair (the whole matrix at N = 6,300 would take
# some 105 GB)
PLAIN_PAIRS = 1 << 16


def suppression_plain(boxes, iou_threshold):
    """[R, N, N] bool: IoU(i, j) > threshold for j > i, boxes [R, N, 5]
    in score order; the IoU matrix in blocks of rows of ``PLAIN_PAIRS``
    pairs."""
    r, n, _ = boxes.shape
    out = torch.empty((r, n, n), dtype=torch.bool, device=boxes.device)
    rows = max(1, PLAIN_PAIRS // (r * n))
    for s in range(0, n, rows):
        out[:, s:s + rows] = iou_bev(boxes[:, s:s + rows], boxes) > \
            iou_threshold
    later = torch.ones((n, n), dtype=torch.bool, device=boxes.device)
    return out & later.triu(1)


def greedy_plain(suppress, valid):
    """The greedy pass: keep [R, N] bool of a suppression matrix [R, N, N]
    (box i would suppress box j > i) and ``valid`` [R, N], in score order.

    Greedy NMS keeps box j when it is valid and no kept box before it
    suppresses it. That recurrence has one solution, and iterating it on
    all boxes at once from "every valid box kept" reaches it: after t
    rounds the first t boxes are settled, so it stops at a fixed point
    within N + 1 rounds, mostly within a few (the longest chain of
    suppressions)."""
    keep = valid
    for _ in range(valid.shape[-1] + 1):
        new = valid & ~(suppress & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_bev_plain(boxes, valid, iou_threshold):
    """Greedy NMS of boxes [R, N, 5] in score order with ``valid`` [R, N]
    bool -> keep [R, N] bool, in score order."""
    return greedy_plain(suppression_plain(boxes, iou_threshold), valid)


def nms_bev(boxes, valid, iou_threshold):
    """``nms_bev_plain``'s contract; on a CUDA device it launches the
    ``nms_bev`` kernels on boxes [R, N, 5] float32 and valid [R, N] bool,
    both contiguous, R <= 65,535."""
    dev = boxes.device
    r, n = valid.shape
    if boxes.shape != (r, n, 5):
        raise ValueError(f"boxes [R, N, 5] and valid [R, N]: got "
                         f"{tuple(boxes.shape)}, {tuple(valid.shape)}")
    if route(boxes, "nms_bev") == "plain":
        return nms_bev_plain(boxes, valid, iou_threshold)
    check(boxes, "boxes", torch.float32, 3, dev)
    check(valid, "valid", torch.bool, 2, dev)
    if not (1 <= r <= 65535 and n >= 1):
        raise ValueError(f"nms_bev needs 1 <= R <= 65535 and N >= 1: got "
                         f"R {r}, N {n}")
    from ._build import library
    words = -(-n // WORD)
    mask = torch.empty((r, n, words), dtype=torch.int64, device=dev)
    keep = torch.empty((r, n), dtype=torch.bool, device=dev)
    err = library().nms_bev_launch(boxes.data_ptr(), valid.data_ptr(),
                                   mask.data_ptr(), keep.data_ptr(), r, n,
                                   float(iou_threshold), stream())
    raise_on(err, "nms_bev")
    LAUNCHES["nms_bev"] += 1
    return keep
