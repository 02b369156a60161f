"""Exact neighbour search, fixed-radius search, ball query and the exact
k-NN pyramid.

Counterpart of ``open3d_ml_tpu/ops/neighbors.py`` ``knn_search`` (exact
only), ``radius_search``, ``ball_query`` and ``build_knn_pyramid``
(``method="exact"`` only): the ``approx``, ``grid`` and ``window``
methods are not ported. Each takes one cloud [N, 3] as the JAX functions
do, or a batch [B, N, 3] whose samples are searched independently, in one
kernel launch per call.
"""

import torch

from .cuda.knn import (knn_exact, masked_norms, pairwise_d2, query_chunk,
                       sq_norms)


def _nearest(points, queries, points_mask):
    """k = 1 over a batch: chunked distances, then the minimum, the lower
    index first among equal d2."""
    pn = masked_norms(points, points_mask)
    qn = sq_norms(queries)
    chunk = query_chunk(*points.shape[:2])
    idx, d2 = [], []
    for s in range(0, queries.shape[1], chunk):
        dist = pairwise_d2(queries[:, s:s + chunk], qn[:, s:s + chunk],
                           points, pn)
        if points_mask is not None:
            dist = dist.masked_fill(~points_mask[:, None], float("inf"))
        best = dist.min(dim=-1)
        idx.append(best.indices.int())
        d2.append(best.values)
    return torch.cat(idx, 1)[..., None], torch.cat(d2, 1)[..., None]


def knn_search(points, queries, k, *, points_mask=None):
    """Exact k-nearest-neighbour search.

    points [N, 3] or [B, N, 3], queries [Q, 3] or [B, Q, 3] alike,
    points_mask [N] or [B, N] bool (False entries are never neighbours).
    Returns (indices [..., Q, k] int32, d2 [..., Q, k] float32), ascending
    by d2 = max(|q|^2 + |p|^2 - 2 q.p, 0), the lower index first among
    equal d2; k is cut to N.

    k > 1 goes to the ``knn_exact`` wrapper for every N: the TPU kernel
    held all points in VMEM and so served N <= 200,000 only, while this
    one streams them. On a card the kernel is built for k = 3, 8, 16, 32
    and 64 (``KNN_KS``: the 3-NN, PointTransformer's groupings,
    RandLA-Net's 16, PointRCNN's ball queries), and any other k > 1
    raises; on the CPU the plain version takes any k.
    k = 1 is a chunked minimum in plain torch, as the JAX package's is
    plain XLA.
    """
    single = points.dim() == 2
    if single:
        points, queries = points[None], queries[None]
        points_mask = None if points_mask is None else points_mask[None]
    if points.shape[-1] != 3:
        raise NotImplementedError("knn_search is ported for 3-d points only")
    points = points.float().contiguous()
    queries = queries.float().contiguous()
    k = min(k, points.shape[1])
    if k == 1:
        idx, d2 = _nearest(points, queries, points_mask)
    else:
        mask = None if points_mask is None else points_mask.contiguous()
        idx, d2 = knn_exact(points, queries, k, points_mask=mask)
    return (idx[0], d2[0]) if single else (idx, d2)


def _squared(radius, device):
    """float32(radius) ** 2, squared in float32 as the JAX package does."""
    return torch.tensor(radius, dtype=torch.float32, device=device) ** 2


def _radius_count(points, queries, r2, points_mask):
    """[..., Q] int32: the points within d2 <= r2 of each query, d2 in the
    contract's order, masked points never."""
    pn = masked_norms(points, points_mask)
    qn = sq_norms(queries)
    chunk = query_chunk(*points.shape[:2])
    counts = []
    for s in range(0, queries.shape[1], chunk):
        dist = pairwise_d2(queries[:, s:s + chunk], qn[:, s:s + chunk],
                           points, pn)
        inside = dist <= r2
        if points_mask is not None:
            inside &= points_mask[:, None]
        counts.append(inside.sum(-1, dtype=torch.int32))
    return torch.cat(counts, 1)


def radius_search(points, queries, radius, max_k, *, points_mask=None):
    """Fixed-radius search as dense padded lists: the nearest min(max_k,
    N) points of each query (``knn_search``), with a mask of those within
    the radius and the count of all points within it.

    As the JAX function: d2 <= r2 with r2 = float32(radius) ** 2, the
    nearest first, the lower index first among equal d2. The JAX package
    takes its d2 from a matrix product, the port from the contract's
    fixed order (``ops/cuda/knn.py``), so a point within a few ulps of the
    radius, or of the max_k-th distance, may fall on the other side.

    points [N, 3] or [B, N, 3], queries [Q, 3] or [B, Q, 3] alike,
    points_mask [N] or [B, N] bool. Returns (indices [..., Q, k] int32,
    any point where the mask is False; mask [..., Q, k] bool; counts
    [..., Q] int32, not capped by max_k). The counts are plain torch on
    either device: nothing on a model's path reads them.
    """
    idx, d2 = knn_search(points, queries, max_k, points_mask=points_mask)
    r2 = _squared(radius, d2.device)
    single = points.dim() == 2
    if single:
        points, queries = points[None], queries[None]
        points_mask = None if points_mask is None else points_mask[None]
    counts = _radius_count(points.float(), queries.float(), r2, points_mask)
    return idx, d2 <= r2, counts[0] if single else counts


def ball_query(points, queries, radius, k, *, points_mask=None):
    """PointNet++'s ball query: the nearest min(k, N) points of each query
    (``knn_search``), the mask of those within the radius (d2 <= r2, r2 =
    float32(radius) ** 2), and the slots outside it filled with the
    query's nearest point, even where that lies outside the radius, as
    the JAX ``ball_query`` fills them; so every index is in bounds.

    points [N, 3] or [B, N, 3], queries [Q, 3] or [B, Q, 3] alike.
    Returns (indices [..., Q, k] int32, mask [..., Q, k] bool). One
    ``knn_exact`` launch on a card, at k = 16, 32 or 64 for PointRCNN.
    """
    idx, d2 = knn_search(points, queries, k, points_mask=points_mask)
    mask = d2 <= _squared(radius, d2.device)
    return torch.where(mask, idx, idx[..., :1]), mask


def build_knn_pyramid(points, k, sub_ratios, *, num_interp=1,
                      method="exact"):
    """Per-level (neighbours, pool, upsample) index pyramid.

    points [N, 3] or [B, N, 3] in random order: each level keeps the first
    N // ratio points, so the caller's order is the subsampling. Returns a
    dict of lists, one entry per level: coords [..., N_i, 3],
    neighbor_indices [..., N_i, k], sub_idx [..., N_{i+1}, k] (the kept
    points' neighbours) and interp_idx [..., N_i, num_interp] (the nearest
    kept points).
    """
    if method != "exact":
        raise NotImplementedError(
            f"build_knn_pyramid method={method!r} is not ported; the port "
            "runs 'exact'")
    coords, neighbors, pools, ups = [], [], [], []
    pc = points
    for ratio in sub_ratios:
        nbr, _ = knn_search(pc, pc, k)
        n_sub = pc.shape[-2] // ratio
        sub = pc[..., :n_sub, :]
        up, _ = knn_search(sub, pc, num_interp)
        coords.append(pc)
        neighbors.append(nbr)
        pools.append(nbr[..., :n_sub, :])
        ups.append(up)
        pc = sub
    return {"coords": coords, "neighbor_indices": neighbors,
            "sub_idx": pools, "interp_idx": ups}
