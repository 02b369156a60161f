"""The bucket KNN and bucket gather: CUDA kernels, their plain versions,
and the wrappers the pyramid and the model call.

A wrapper takes the plain version for tensors on the CPU and launches its
kernel (``csrc/bucket_knn.cu``, ``csrc/bucket_gather.cu``) for tensors on a
CUDA device; it has no other route. ``LAUNCHES`` counts the kernel
launches each wrapper made, so a run can show that it went through them.
"""

import torch

from ._launch import check, raise_on, route, stream

LAUNCHES = {"bucket_knn": 0, "bucket_gather": 0}

KNN_KS = (1, 16)


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


def knn_bucket(points, queries, seg_ids, k, *, seg, qblock):
    """``knn_bucket_plain``'s contract, checked for both routes; on a CUDA
    device it launches the ``bucket_knn`` kernel (k must be 1 or 16 and
    qblock at most 1024 there)."""
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
    if not 0 < qblock <= 1024:
        raise ValueError(f"qblock {qblock} must be in (0, 1024]")
    from ._build import library
    rel = torch.empty((b, q, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((b, q, k), dtype=torch.float32, device=dev)
    err = library().bucket_knn_launch(
        points.data_ptr(), queries.data_ptr(), seg_ids.data_ptr(),
        rel.data_ptr(), d2.data_ptr(), b, npad, q, nqb, s, seg, qblock, k,
        stream())
    raise_on(err, "bucket_knn")
    LAUNCHES["bucket_knn"] += 1
    return rel, d2


# -------------------------------------------------------------- bucket gather

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
    blk = (torch.arange(q, device=rel.device) // qblock)[None, :, None]
    bidx = torch.arange(b, device=rel.device)[:, None, None]
    glob = (seg_ids[bidx, blk, torch.div(rel, seg, rounding_mode="floor")]
            .long() * seg + rel % seg)
    out = torch.gather(values, 1, glob.reshape(b, -1, 1).expand(-1, -1, c))
    if round_bf16:
        out = out.bfloat16().float()
    return out.reshape(b, q, k, c)


def gather_bucket(values, seg_ids, rel, *, seg, qblock, round_bf16):
    """``gather_bucket_plain``'s contract, checked for both routes; on a
    CUDA device it launches the ``bucket_gather`` kernel."""
    dev = values.device
    check(values, "values", torch.float32, 3, dev)
    check(seg_ids, "seg_ids", torch.int32, 3, dev)
    check(rel, "rel", torch.int32, 3, dev)
    b, npad, c = values.shape
    q, k = rel.shape[1:]
    nqb, s = seg_ids.shape[1:]
    if seg_ids.shape[0] != b or rel.shape[0] != b:
        raise ValueError("batch sizes differ: values "
                         f"{tuple(values.shape)}, seg_ids "
                         f"{tuple(seg_ids.shape)}, rel {tuple(rel.shape)}")
    if npad % seg or nqb * qblock < q:
        raise ValueError(f"bad bucket shapes: npad {npad}, seg {seg}, Q {q}, "
                         f"qblock {qblock}, nqb {nqb}")
    if route(values, "bucket") == "plain":
        return gather_bucket_plain(values, seg_ids, rel, seg=seg,
                                   qblock=qblock, round_bf16=round_bf16)
    if values.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("bucket_gather has no backward kernel yet")
    from ._build import library
    out = torch.empty((b, q, k, c), dtype=torch.float32, device=dev)
    err = library().bucket_gather_launch(
        values.data_ptr(), seg_ids.data_ptr(), rel.data_ptr(),
        out.data_ptr(), b, npad, q, k, c, nqb, s, seg, qblock,
        int(round_bf16), stream())
    raise_on(err, "bucket_gather")
    LAUNCHES["bucket_gather"] += 1
    return out
