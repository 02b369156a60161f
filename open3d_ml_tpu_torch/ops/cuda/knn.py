"""Exact brute-force k-NN: the CUDA kernel, its plain version and the
wrapper that ``ops/neighbors.py`` calls.

The wrapper takes the plain version for tensors on the CPU and launches
the ``knn_exact`` kernel (``csrc/knn_exact.cu``) for tensors on a CUDA
device; it has no other route. ``LAUNCHES`` counts the kernel launches,
one a call. ``exact_plan`` sizes a call.

The contract is the TPU kernel's: d2 = max(|q|^2 + |p|^2 - 2 q.p, 0),
masked points carry |p|^2 = 1e30, and the k results come ascending by d2,
the lower point index first among equal d2. Every sum has one fixed order,
|x|^2 = (x0*x0 + x1*x1) + x2*x2 and q.p = (q0*p0 + q1*p1) + q2*p2, written
here as separate elementwise ops so that no fused multiply-add can form;
the kernel computes the same with explicit round-to-nearest intrinsics, so
its d2 equals the plain version's bit for bit.
"""

import torch

from ._launch import check, ptr, raise_on, route, sm_count, stream

LAUNCHES = {"knn_exact": 0}

KNN_K = 16  # the one k the kernel is built for
# the kernel's plan: warps a block (a power of two up to MAX_WARPS) and
# tile entries a warp (up to MAX_CHUNK, whole batches of 32)
MAX_WARPS = 8
MAX_CHUNK = 128
BATCH = 32
# warps per SM the plan fills before it stops adding slices: more slices
# mean more lists to fill and merge (on the H100, 12 picked the fastest
# warps a block of a sweep at eval levels 0-2)
WARPS_PER_SM = 12
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


def exact_plan(b, n, q, *, sms):
    """How the ``knn_exact`` kernel runs a call: {"qpt": queries a thread,
    2 where the query groups of 64 alone give every SM (``sms`` of them)
    four blocks, else 1: each tile entry read from shared memory
    then serves two distances, which paid at the eval pyramid's level 0 on
    the H100 and not where it leaves fewer warps; "warps": warps a block,
    one block a query group of 32 * qpt, each warp a slice of the N
    candidates, warp w taking entries [w * chunk, (w + 1) * chunk) of each
    tile of warps * chunk; "chunk"}.

    warps doubles while the grid stays within ``WARPS_PER_SM`` warps per
    SM and each warp keeps two batches a tile. A query's slices each keep
    a list, merged at the end, so they are no more than the card needs;
    at the small levels, where the query groups leave SMs idle, a block
    takes the most warps."""
    qpt = 2 if b * -(-q // (2 * BATCH)) >= 4 * sms else 1
    qgroups = b * -(-q // (BATCH * qpt))
    warps = 1
    while (warps < MAX_WARPS and
           qgroups * warps * 2 <= WARPS_PER_SM * sms and
           n >= 2 * warps * 2 * BATCH):
        warps *= 2
    chunk = min(MAX_CHUNK, BATCH * -(-n // (BATCH * warps)))
    return {"qpt": qpt, "warps": warps, "chunk": chunk}


def knn_exact(points, queries, k, *, points_mask=None):
    """``knn_exact_plain``'s contract, checked for both routes; on a CUDA
    device it launches the ``knn_exact`` kernel, which is built for
    k = 16 only, as ``exact_plan`` sizes it."""
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
    plan = exact_plan(b, n, q, sms=sm_count(dev.index))
    idx = torch.empty((b, q, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, q, k), dtype=torch.float32, device=dev)
    err = library().knn_exact_launch(
        points.data_ptr(), queries.data_ptr(), ptr(points_mask),
        idx.data_ptr(), d2.data_ptr(), b, n, q, k, plan["qpt"],
        plan["warps"], plan["chunk"], stream())
    raise_on(err, "knn_exact")
    LAUNCHES["knn_exact"] += 1
    return idx, d2
