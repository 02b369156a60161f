"""3-NN inverse-distance interpolation and trilinear devoxelisation.

Counterpart of ``open3d_ml_tpu/ops/interpolation.py``: ``three_nn``,
``three_interpolate``, ``inverse_distance_weights``,
``trilinear_devoxelize`` and ``trilinear_voxelize_coords``. Each takes one
cloud as the JAX functions do, or a batch whose samples are searched,
gathered or interpolated on their own; the search is ``knn_search`` at
k = 3, the ``knn_exact`` kernel on a card. ``trilinear_devoxelize`` is the
plain version in the JAX layout (channels first), differentiable in both
arguments; PVCNN's path calls ``ops/cuda/devoxelize.py``
``trilinear_devoxelize`` on a channels-last grid, which launches the
kernel pair on a card.
"""

import torch

from .cuda import devoxelize as cdv
from .neighbors import knn_search


def three_nn(queries, points, *, points_mask=None):
    """The 3 nearest points of each query: (dist [..., Q, 3] float32, the
    euclidean distance sqrt(d2), idx [..., Q, 3] int32), ascending. queries
    [Q, 3] or [B, Q, 3], points [N, 3] or [B, N, 3]; k is cut to N."""
    idx, d2 = knn_search(points, queries, 3, points_mask=points_mask)
    return torch.sqrt(d2), idx


def three_interpolate(features, idx, weight):
    """sum_j weight[..., q, j] * features[..., idx[..., q, j], :]: features
    [N, C] or [B, N, C], idx and weight [..., Q, 3] -> [..., Q, C]."""
    if features.dim() == 2:
        gathered = features[idx.long()]
    else:
        rows = torch.arange(features.shape[0],
                            device=features.device)[:, None, None]
        gathered = features[rows, idx.long()]
    return (gathered * weight[..., None].to(gathered.dtype)).sum(-2)


def inverse_distance_weights(dist, eps=1e-8):
    """w_j = (1 / (d_j + eps)) / sum_i (1 / (d_i + eps)) over the last axis:
    a query on a point (d = 0) gives it the weight 1 / eps before the
    normalisation, as the JAX package does."""
    recip = 1.0 / (dist + eps)
    return recip / recip.sum(-1, keepdim=True)


def trilinear_devoxelize(grid, coords, resolution):
    """Trilinear interpolation of a dense grid at point locations, as the
    JAX function computes it: grid [C, R, R, R] or [B, C, R, R, R], coords
    [3, N] or [B, 3, N] in voxel units -> [C, N] or [B, C, N]. The plain
    version (``ops/cuda/devoxelize.py`` ``devoxelize_plain``) on any
    device, differentiable in both arguments."""
    if grid.shape[-1] != resolution:
        raise ValueError(f"grid {tuple(grid.shape)}: resolution "
                         f"{resolution}")
    single = grid.dim() == 4
    if single:
        grid, coords = grid[None], coords[None]
    out = cdv.devoxelize_plain(grid.permute(0, 2, 3, 4, 1),
                               coords.transpose(1, 2)).transpose(1, 2)
    return out[0] if single else out


def trilinear_voxelize_coords(points, resolution):
    """Points in the unit ball [..., N, 3] -> voxel-unit coordinates
    [..., 3, N] of an R^3 grid, (p + 1) / 2 * (R - 1), float32."""
    norm = (points.float() + 1.0) * 0.5 * (resolution - 1)
    return norm.transpose(-1, -2)

