"""Exact brute-force k-NN: the CUDA kernel, its plain version and the
wrapper that ``ops/neighbors.py`` calls.

The wrapper takes the plain version for tensors on the CPU and launches
the ``knn_exact`` kernel (``csrc/knn_exact.cu``) for tensors on a CUDA
device; it has no other route. ``LAUNCHES`` counts the kernel launches.

The contract is the TPU kernel's: d2 = max(|q|^2 + |p|^2 - 2 q.p, 0),
masked points carry |p|^2 = 1e30, and the k results come ascending by d2,
the lower point index first among equal d2. Every sum has one fixed order,
|x|^2 = (x0*x0 + x1*x1) + x2*x2 and q.p = (q0*p0 + q1*p1) + q2*p2, written
here as separate elementwise ops so that no fused multiply-add can form;
the kernel computes the same with explicit round-to-nearest intrinsics, so
its d2 equals the plain version's bit for bit.
"""

import torch

from ._launch import check, raise_on, route, stream

LAUNCHES = {"knn_exact": 0}

KNN_K = 16  # the one k the kernel is built for
BIG = 1e30  # |p|^2 of a masked point
# elements of one [B, chunk, N] distance block of the plain versions
CHUNK_ELEMS = 1 << 24


def sq_norms(x):
    """[..., 3] -> [...]: (x0*x0 + x1*x1) + x2*x2."""
    return ((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) +
            x[..., 2] * x[..., 2])


def pairwise_d2(queries, qn, points, pn):
    """queries [B, c, 3] with norms qn [B, c], points [B, N, 3] with norms
    pn [B, N] -> d2 [B, c, N] in the contract's order."""
    q = queries[..., None, :]
    p = points[:, None]
    cross = ((q[..., 0] * p[..., 0] + q[..., 1] * p[..., 1]) +
             q[..., 2] * p[..., 2])
    return ((qn[..., None] + pn[:, None]) - 2 * cross).clamp_min(0)


def masked_norms(points, points_mask):
    """|p|^2 of points [B, N, 3], BIG where ``points_mask`` [B, N] is
    False."""
    pn = sq_norms(points)
    return pn if points_mask is None else torch.where(points_mask, pn, BIG)


def query_chunk(b, n):
    """Queries per distance block of ``CHUNK_ELEMS`` elements."""
    return max(1, CHUNK_ELEMS // (b * n))


def knn_exact_plain(points, queries, k, *, points_mask=None):
    """Exact k-NN of each query among the points of its sample.

    points [B, N, 3] and queries [B, Q, 3] float32, points_mask [B, N] bool
    or None. Returns (idx [B, Q, k] int32, d2 [B, Q, k] float32), ascending
    by d2, the lower index first among equal d2.

    d2 >= 0, so its int32 bit pattern orders as d2 does: the int64 key
    (bits << 32) | index is unique per row, and its k smallest give the
    exact order.
    """
    b, n, _ = points.shape
    pn = masked_norms(points, points_mask)
    qn = sq_norms(queries)
    index = torch.arange(n, device=points.device)
    chunk = query_chunk(b, n)
    idx, d2 = [], []
    for s in range(0, queries.shape[1], chunk):
        dist = pairwise_d2(queries[:, s:s + chunk], qn[:, s:s + chunk],
                           points, pn)
        key = (dist.view(torch.int32).long() << 32) | index
        top = torch.topk(key, k, dim=-1, largest=False).values
        idx.append((top & 0xFFFFFFFF).int())
        d2.append((top >> 32).int().view(torch.float32))
    return torch.cat(idx, 1), torch.cat(d2, 1)


def knn_exact(points, queries, k, *, points_mask=None):
    """``knn_exact_plain``'s contract, checked for both routes; on a CUDA
    device it launches the ``knn_exact`` kernel, which is built for
    k = 16 only."""
    dev = points.device
    check(points, "points", torch.float32, 3, dev)
    check(queries, "queries", torch.float32, 3, dev)
    b, n, _ = points.shape
    q = queries.shape[1]
    if points.shape[2] != 3 or queries.shape[::2] != (b, 3):
        raise ValueError("points [B,N,3], queries [B,Q,3]: got "
                         f"{tuple(points.shape)}, {tuple(queries.shape)}")
    if points_mask is not None:
        check(points_mask, "points_mask", torch.bool, 2, dev)
        if points_mask.shape != (b, n):
            raise ValueError(f"points_mask {tuple(points_mask.shape)}, "
                             f"expected {(b, n)}")
    if not (b >= 1 and q >= 1 and 1 <= k <= n):
        raise ValueError(f"knn_exact needs B, Q >= 1 and 1 <= k <= N: got "
                         f"B {b}, N {n}, Q {q}, k {k}")
    if route(points, "knn_exact") == "plain":
        return knn_exact_plain(points, queries, k, points_mask=points_mask)
    if k != KNN_K:
        raise ValueError(f"the knn_exact kernel is built for k={KNN_K}, "
                         f"not {k}")
    from ._build import library
    idx = torch.empty((b, q, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, q, k), dtype=torch.float32, device=dev)
    mask_ptr = None if points_mask is None else points_mask.data_ptr()
    err = library().knn_exact_launch(
        points.data_ptr(), queries.data_ptr(), mask_ptr, idx.data_ptr(),
        d2.data_ptr(), b, n, q, k, stream())
    raise_on(err, "knn_exact")
    LAUNCHES["knn_exact"] += 1
    return idx, d2
