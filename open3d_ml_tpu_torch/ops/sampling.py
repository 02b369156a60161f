"""Furthest point sampling.

Counterpart of ``open3d_ml_tpu/ops/sampling.py``
``furthest_point_sampling`` and ``furthest_point_sampling_batch`` (the
start index is always 0, as there by default): one cloud [N, 3] or a batch
[B, N, 3], each cloud sampled on its own, in one launch of the ``fps``
kernel (``ops/cuda/sampling.py``) per call on a card.
"""

from .cuda.sampling import fps


def furthest_point_sampling(points, k, *, points_mask=None):
    """Indices of ``k`` points of each cloud, chosen greedily from index 0,
    each the furthest from those chosen so far (the lowest index first
    among equal distances); points with ``points_mask`` False are never
    chosen while a valid point is left.

    points [N, 3] or [B, N, 3], points_mask [N] or [B, N] bool. Returns
    [k] or [B, k] int32.
    """
    single = points.dim() == 2
    if single:
        points = points[None]
        points_mask = None if points_mask is None else points_mask[None]
    mask = None if points_mask is None else points_mask.contiguous()
    idx = fps(points.float().contiguous(), k, points_mask=mask)
    return idx[0] if single else idx
