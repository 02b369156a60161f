"""The bucket KNN, the bucket gather and its backward: CUDA kernels, their
plain versions, and the wrappers the pyramid and the model call.

A wrapper takes the plain version for tensors on the CPU and launches its
kernel (``csrc/bucket_knn.cu``, ``csrc/bucket_gather.cu``,
``csrc/bucket_gather_bwd.cu``) for tensors on a CUDA device; it has no
other route. ``LAUNCHES`` counts the kernel launches each wrapper made, so
a run can show that it went through them. ``BucketGather`` is the gather
with its gradient: its forward is ``gather_bucket`` and its backward
``gather_bucket_bwd``, on either route.

The gather and its backward each have two kernel variants, chosen per call
by ``float4_units``: 16-byte units where C is a multiple of 4 and the
row-strided tensors are 16-byte aligned, 4-byte units otherwise.
"""

import torch

from ._launch import (check, fits, partials, ptr, raise_on, route, sm_count,
                      stream)

LAUNCHES = {"bucket_knn": 0, "bucket_gather": 0, "bucket_gather_bwd": 0}

# what bucket_knn is built for: k 1 or 16, seg a power of two, a table of
# S * seg points that fits one block's shared memory (the kernel library's
# ``bucket_knn_shared``), and at most 512 threads a block
KNN_KS = (1, 16)
KNN_MAX_THREADS = 512  # threads a block: 128 registers a thread
KNN_BATCH = 32  # table rows per hit mask, the least rows a block scans
# the most blocks a query block's table is split over: the last of them to
# finish merges the others' lists one after another (on the H100, 8 and
# 11 tied at level 3's pool search and 16 lost)
KNN_MAX_GROUPS = 8
# the gather kernels index rows and value rows with 32-bit integers
GATHER_MAX_ROWS = 2**31 - 1


# ----------------------------------------------------------------- bucket KNN

def knn_bucket_plain(points, queries, seg_ids, k, *, seg, qblock):
    """Exact k-NN of each query inside its block's candidate table.

    points [B, Npad, 3] float32 (Npad a multiple of ``seg``, pad rows far
    away), queries [B, Q, 3] float32, seg_ids [B, nqb, S] int32 with
    nqb = ceil(Q / qblock). The table of block i is the S segments
    ``seg_ids[b, i]`` of ``seg`` rows each, in that order.

    Returns (rel [B, Q, k] int32 table positions, d2 [B, Q, k] float32),
    ascending by d2 = dx*dx + dy*dy + dz*dz, the lower table position first
    among equal distances.
    """
    b, q, _ = queries.shape
    nqb, s = seg_ids.shape[1:]
    offs = torch.arange(seg, device=points.device)
    cand = (seg_ids.long()[..., None] * seg + offs).reshape(b, -1)
    tab = torch.gather(points, 1, cand[..., None].expand(-1, -1, 3))
    tab = tab.reshape(b, nqb, 1, s * seg, 3)
    qs = torch.nn.functional.pad(queries, (0, 0, 0, nqb * qblock - q))
    qs = qs.reshape(b, nqb, qblock, 1, 3)
    dx, dy, dz = (qs[..., i] - tab[..., i] for i in range(3))
    d2 = dx * dx + dy * dy + dz * dz
    best = torch.sort(d2, dim=-1, stable=True)
    rel = best.indices[..., :k].to(torch.int32).reshape(b, -1, k)
    d2 = best.values[..., :k].reshape(b, -1, k)
    return rel[:, :q].contiguous(), d2[:, :q].contiguous()


def knn_bucket_plan(b, q, s, seg, qblock, *, sms):
    """How the ``bucket_knn`` kernel runs a call: {"qpt": queries a
    thread, 1, or 2 where qblock passes ``KNN_MAX_THREADS`` (two a thread
    halve the block's warps, which its shared-memory table already caps:
    slower on the H100 at every fused level); "threads": a block's,
    32 * ceil(qblock / qpt / 32); "groups":
    blocks per query block, block g scanning table positions [g * span,
    (g + 1) * span); "span"; "shared": the block's shared memory, as the
    kernel library computes it (``bucket_knn_shared``)}. Raises where the
    whole table of S * seg points would not fit one block.

    groups is the most, up to ``KNN_MAX_GROUPS``, that keeps the grid
    within one block per SM (``sms`` of them) and gives each block a batch
    of rows: only the deep levels' few query blocks are split, and a grid
    that would take more than one wave is not (on the H100 a second wave
    cost more than the split saved)."""
    from ._build import library
    lib = library()
    rows = s * seg
    fits("bucket_knn", lib.bucket_knn_shared(rows))
    qpt = -(-qblock // KNN_MAX_THREADS)
    nqb = -(-q // qblock)
    groups = max(1, min(KNN_MAX_GROUPS, sms // (b * nqb), rows // KNN_BATCH))
    span = -(-rows // groups)
    return {"qpt": qpt, "threads": 32 * -(-qblock // (32 * qpt)),
            "groups": -(-rows // span), "span": span,
            "shared": fits("bucket_knn", lib.bucket_knn_shared(span))}


def knn_bucket(points, queries, seg_ids, k, *, seg, qblock):
    """``knn_bucket_plain``'s contract, checked for both routes; on a CUDA
    device it launches the ``bucket_knn`` kernel, as ``knn_bucket_plan``
    sizes it: k must be 1 or 16, seg a power of two, qblock at most 1024
    and the table fit one block's shared memory there."""
    dev = points.device
    check(points, "points", torch.float32, 3, dev)
    check(queries, "queries", torch.float32, 3, dev)
    check(seg_ids, "seg_ids", torch.int32, 3, dev)
    b, npad, _ = points.shape
    q = queries.shape[1]
    nqb, s = seg_ids.shape[1:]
    if (points.shape[2] != 3 or queries.shape[:1] != (b,) or
            queries.shape[2] != 3 or seg_ids.shape[0] != b):
        raise ValueError("points [B,Npad,3], queries [B,Q,3], seg_ids "
                         f"[B,nqb,S]: got {tuple(points.shape)}, "
                         f"{tuple(queries.shape)}, {tuple(seg_ids.shape)}")
    if npad % seg or nqb != -(-q // qblock) or s * seg < k:
        raise ValueError(f"bad bucket shapes: npad {npad}, seg {seg}, Q {q}, "
                         f"qblock {qblock}, nqb {nqb}, S {s}, k {k}")
    if route(points, "bucket") == "plain":
        return knn_bucket_plain(points, queries, seg_ids, k, seg=seg,
                                qblock=qblock)
    if k not in KNN_KS:
        raise ValueError(f"bucket_knn is built for k in {KNN_KS}, not {k}")
    if seg & (seg - 1):
        raise ValueError(f"bucket_knn is built for seg a power of two, not "
                         f"{seg}")
    if not 0 < qblock <= 1024:
        raise ValueError(f"qblock {qblock} must be in (0, 1024]")
    from ._build import library
    plan = knn_bucket_plan(b, q, s, seg, qblock, sms=sm_count(dev.index))
    rel = torch.empty((b, q, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, q, k), dtype=torch.float32, device=dev)
    part_i, part_d, tickets = partials(plan["groups"], (b, q, k), b * nqb,
                                       dev)
    err = library().bucket_knn_launch(
        points.data_ptr(), queries.data_ptr(), seg_ids.data_ptr(),
        rel.data_ptr(), d2.data_ptr(), ptr(part_i), ptr(part_d), ptr(tickets),
        b, npad, q, nqb, s, seg.bit_length() - 1, qblock, k, plan["qpt"],
        plan["threads"], plan["groups"], plan["span"], plan["shared"],
        stream())
    raise_on(err, "bucket_knn")
    LAUNCHES["bucket_knn"] += 1
    return rel, d2


# -------------------------------------------------------------- bucket gather

def _bucket_rows(seg_ids, rel, *, seg, qblock):
    """[B, Q, K] int64 value rows read by a gather: seg_ids[b, i // qblock,
    rel // seg] * seg + rel % seg."""
    b, q, _ = rel.shape
    blk = (torch.arange(q, device=rel.device) // qblock)[None, :, None]
    bidx = torch.arange(b, device=rel.device)[:, None, None]
    return (seg_ids[bidx, blk, torch.div(rel, seg, rounding_mode="floor")]
            .long() * seg + rel % seg)


def gather_bucket_plain(values, seg_ids, rel, *, seg, qblock, round_bf16):
    """out[b, i, j] = values[b, seg_ids[b, i // qblock, rel // seg] * seg
    + rel % seg] with rel = rel[b, i, j].

    values [B, Npad, C] float32 (Npad a multiple of ``seg``), seg_ids
    [B, nqb, S] int32 with nqb * qblock >= Q, rel [B, Q, K] int32.
    Returns [B, Q, K, C] float32, each value rounded to bfloat16 when
    ``round_bf16`` is set.
    """
    b, q, k = rel.shape
    c = values.shape[2]
    glob = _bucket_rows(seg_ids, rel, seg=seg, qblock=qblock)
    out = torch.gather(values, 1, glob.reshape(b, -1, 1).expand(-1, -1, c))
    if round_bf16:
        out = out.bfloat16().float()
    return out.reshape(b, q, k, c)


def _check_gather(values_shape, seg_ids, rel, seg, qblock):
    b, npad = values_shape[:2]
    q = rel.shape[1]
    nqb = seg_ids.shape[1]
    if seg_ids.shape[0] != b or rel.shape[0] != b:
        raise ValueError("batch sizes differ: values "
                         f"{tuple(values_shape)}, seg_ids "
                         f"{tuple(seg_ids.shape)}, rel {tuple(rel.shape)}")
    if npad % seg or nqb * qblock < q:
        raise ValueError(f"bad bucket shapes: npad {npad}, seg {seg}, Q {q}, "
                         f"qblock {qblock}, nqb {nqb}")
    if max(rel.numel(), b * npad) > GATHER_MAX_ROWS:
        raise ValueError(f"{rel.numel()} gathered rows or {b * npad} value "
                         f"rows: more than {GATHER_MAX_ROWS}")


def float4_units(c, *tensors):
    """Whether the gather kernels move rows of ``c`` float32 channels in
    16-byte units: ``c`` a multiple of 4 and every tensor's data 16-byte
    aligned (a view at a storage offset may not be). Otherwise they move
    4-byte units."""
    return c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def gather_bucket(values, seg_ids, rel, *, seg, qblock, round_bf16):
    """``gather_bucket_plain``'s contract, checked for both routes; on a
    CUDA device it launches the ``bucket_gather`` kernel. Values that need
    a gradient go through ``BucketGather``, whose forward this is."""
    if values.requires_grad and torch.is_grad_enabled():
        return BucketGather.apply(values, seg_ids, rel, seg, qblock,
                                  round_bf16)
    dev = values.device
    check(values, "values", torch.float32, 3, dev)
    check(seg_ids, "seg_ids", torch.int32, 3, dev)
    check(rel, "rel", torch.int32, 3, dev)
    _check_gather(values.shape, seg_ids, rel, seg, qblock)
    if route(values, "bucket") == "plain":
        return gather_bucket_plain(values, seg_ids, rel, seg=seg,
                                   qblock=qblock, round_bf16=round_bf16)
    b, npad, c = values.shape
    q, k = rel.shape[1:]
    nqb, s = seg_ids.shape[1:]
    from ._build import library
    out = torch.empty((b, q, k, c), dtype=torch.float32, device=dev)
    err = library().bucket_gather_launch(
        values.data_ptr(), seg_ids.data_ptr(), rel.data_ptr(),
        out.data_ptr(), b, npad, q, k, c, nqb, s, seg, qblock,
        int(round_bf16), int(float4_units(c, values, out)), stream())
    raise_on(err, "bucket_gather")
    LAUNCHES["bucket_gather"] += 1
    return out


# ----------------------------------------------------- bucket gather backward

def gather_bucket_bwd_plain(g, seg_ids, rel, npad, *, seg, qblock,
                            round_bf16):
    """The gather's gradient with respect to its values: dvalues
    [B, npad, C] float32, where each value row is the float32 sum of the
    cotangent rows g[b, i, j] that read it (the row ``gather_bucket_plain``
    names for rel[b, i, j]).

    g [B, Q, K, C] float32; seg_ids and rel as for the gather. With
    ``round_bf16`` each g value is rounded to bfloat16 before the sum, as
    the TPU kernel's bf16 product rounded it; the sum stays float32.
    """
    b, q, k, c = g.shape
    glob = _bucket_rows(seg_ids, rel, seg=seg, qblock=qblock)
    rows = g.reshape(b, q * k, c)
    if round_bf16:
        rows = rows.bfloat16().float()
    # float32 for float32 g (float64 g gives a float64 reference)
    dv = torch.zeros((b, npad, c), dtype=rows.dtype, device=g.device)
    return dv.scatter_add_(1, glob.reshape(b, -1, 1).expand(-1, -1, c), rows)


def gather_bucket_bwd(g, seg_ids, rel, npad, *, seg, qblock, round_bf16):
    """``gather_bucket_bwd_plain``'s contract, checked for both routes; on
    a CUDA device it launches the ``bucket_gather_bwd`` kernel, whose sums
    are taken in a run-dependent order."""
    dev = g.device
    check(g, "g", torch.float32, 4, dev)
    check(seg_ids, "seg_ids", torch.int32, 3, dev)
    check(rel, "rel", torch.int32, 3, dev)
    b, q, k, c = g.shape
    if tuple(rel.shape) != (b, q, k):
        raise ValueError(f"g {tuple(g.shape)} does not match rel "
                         f"{tuple(rel.shape)}")
    _check_gather((b, npad, c), seg_ids, rel, seg, qblock)
    if route(g, "bucket") == "plain":
        return gather_bucket_bwd_plain(g, seg_ids, rel, npad, seg=seg,
                                       qblock=qblock, round_bf16=round_bf16)
    nqb, s = seg_ids.shape[1:]
    from ._build import library
    dvalues = torch.zeros((b, npad, c), dtype=torch.float32, device=dev)
    err = library().bucket_gather_bwd_launch(
        g.data_ptr(), seg_ids.data_ptr(), rel.data_ptr(), dvalues.data_ptr(),
        b, npad, q, k, c, nqb, s, seg, qblock, int(round_bf16),
        int(float4_units(c, g, dvalues)), stream())
    raise_on(err, "bucket_gather_bwd")
    LAUNCHES["bucket_gather_bwd"] += 1
    return dvalues


class BucketGather(torch.autograd.Function):
    """``gather_bucket`` with its gradient ``gather_bucket_bwd``:
    ``BucketGather.apply(values, seg_ids, rel, seg, qblock, round_bf16)``.
    The tables carry no gradient. With ``round_bf16`` the backward rounds
    the cotangents to bfloat16 as the forward rounds the values. (The
    forward runs with gradients off, so its ``gather_bucket`` launches the
    kernel or takes the plain version.)"""

    @staticmethod
    def forward(ctx, values, seg_ids, rel, seg, qblock, round_bf16):
        ctx.save_for_backward(seg_ids, rel)
        ctx.meta = (values.shape[1], seg, qblock, round_bf16)
        return gather_bucket(values, seg_ids, rel, seg=seg, qblock=qblock,
                             round_bf16=round_bf16)

    @staticmethod
    def backward(ctx, g):
        seg_ids, rel = ctx.saved_tensors
        npad, seg, qblock, round_bf16 = ctx.meta
        dvalues = gather_bucket_bwd(g.contiguous(), seg_ids, rel, npad,
                                    seg=seg, qblock=qblock,
                                    round_bf16=round_bf16)
        return dvalues, None, None, None, None, None
