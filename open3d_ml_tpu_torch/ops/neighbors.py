"""Exact neighbour search and the exact k-NN pyramid.

Counterpart of ``open3d_ml_tpu/ops/neighbors.py`` ``knn_search`` (exact
only) and ``build_knn_pyramid`` (``method="exact"`` only): the
``approx``, ``grid`` and ``window`` methods are not ported. Both take one
cloud [N, 3] as the JAX functions do, or a batch [B, N, 3] whose samples
are searched independently, in one kernel launch per call.
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

    k > 1 goes to the ``knn_exact`` kernel for every N: the TPU kernel held
    all points in VMEM and so served N <= 200,000 only, while this one
    streams them. k = 1 is a chunked minimum in plain torch, as the JAX
    package's is plain XLA.
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
