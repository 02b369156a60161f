"""3-NN inverse-distance interpolation.

Counterpart of ``open3d_ml_tpu/ops/interpolation.py`` ``three_nn``,
``three_interpolate`` and ``inverse_distance_weights`` (the trilinear
devoxelisation there is not ported). Each takes one cloud as the JAX
functions do, or a batch whose samples are searched and gathered on their
own; the search is ``knn_search`` at k = 3, the ``knn_exact`` kernel on a
card.
"""

import torch

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
