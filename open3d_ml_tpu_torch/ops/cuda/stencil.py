"""The stencil convolution of SparseConvUnet: its CUDA kernel, its plain
version and the wrapper the network calls.

``stencil_conv`` takes the plain version for tensors on the CPU and
launches ``csrc/stencil_conv.cu`` for tensors on a CUDA device; it has no
other route. ``LAUNCHES["stencil_conv"]`` counts its kernel launches.
"""

import torch

from ._launch import check, raise_on, route, stream

LAUNCHES = {"stencil_conv": 0}

_I32MAX = torch.iinfo(torch.int32).max
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# what the kernel is built for: a query block of 32, 64 or 128 rows, at
# most 32 taps, a candidate table of at most 1024 rows and a
# qblock * K rulebook of at most 4096 entries, so that its shared memory
# stays within the 48 KB a block gets without opting in
KERNEL_QBLOCKS = (32, 64, 128)
KERNEL_MAX_TAPS = 32
KERNEL_MAX_TABLE = 1024
KERNEL_MAX_TAP_ROWS = 4096


def _pad_keys(keys, seg):
    """Pad [B, V] keys to a multiple of ``seg`` rows with INT32_MAX."""
    pad = (-keys.shape[1]) % seg
    if not pad:
        return keys
    return torch.nn.functional.pad(keys, (0, pad), value=_I32MAX)


def stencil_rows(keys, qkeys, seg_ids, *, seg, qblock):
    """The rulebook of the stencil convolution: [B, Q, K] int64 support row
    whose key equals each tap key within the tap's block table, and [B, Q,
    K] found. A tap key that no row of the table holds is a miss, even
    where a row outside the table holds it. keys [B, Vp] (Vp a multiple of
    ``seg``), qkeys [B, Q, K], seg_ids [B, nqb, S] with nqb * qblock >= Q.

    For each block the table's keys are sorted with their positions and
    the block's tap keys are looked up with ``searchsorted``: O(nqb * table)
    memory. A key is held by one row at most (valid keys are distinct, pad
    keys INT32_MAX and misses -1 never match), so the match is unique.
    """
    b, q, k = qkeys.shape
    nqb, s = seg_ids.shape[1:]
    offs = torch.arange(seg, device=keys.device)
    cand = (seg_ids.long()[..., None] * seg + offs).reshape(b, nqb, s * seg)
    tabk = torch.gather(keys, 1, cand.reshape(b, -1)).reshape(cand.shape)
    tabk, order = torch.sort(tabk, dim=-1, stable=True)
    qk = torch.nn.functional.pad(qkeys, (0, 0, 0, nqb * qblock - q),
                                 value=-1).reshape(b, nqb, qblock * k)
    pos = torch.searchsorted(tabk, qk).clamp(max=s * seg - 1)
    found = torch.gather(tabk, 2, pos) == qk
    rows = torch.gather(cand, 2, torch.gather(order, 2, pos))
    return (rows.reshape(b, -1, k)[:, :q], found.reshape(b, -1, k)[:, :q])


def stencil_conv_plain(values, keys, qkeys, seg_ids, w, *, seg, qblock,
                       compute_dtype):
    """out[b, i] = sum_k values[b, row(qkeys[b, i, k])] @ w[k], row(.) the
    row of the tap's block table (``stencil_rows``) whose key equals the
    tap key; a miss contributes 0.

    values [B, V, Cin] float32, keys [B, V] int32 Morton keys (INT32_MAX
    for invalid rows), qkeys [B, Q, K] int32 (misses -1), seg_ids [B, nqb,
    S] int32, w [K, Cin, Cout] float32. With ``compute_dtype`` bfloat16 the
    values and the weights are rounded to bfloat16 first; the products and
    sums are taken in the values' type (float32; float64 values give a
    float64 reference). Returns [B, Q, Cout].
    """
    b, q, k = qkeys.shape
    cin = values.shape[2]
    rows, found = stencil_rows(_pad_keys(keys, seg), qkeys, seg_ids, seg=seg,
                               qblock=qblock)
    rows = torch.where(found, rows, 0)  # any row: a miss is masked below
    dtype = values.dtype
    if compute_dtype == torch.bfloat16:
        values = values.bfloat16().to(dtype)
        w = w.bfloat16()
    g = torch.gather(values, 1, rows.reshape(b, -1, 1).expand(-1, -1, cin))
    g = g * found.reshape(b, -1, 1).to(dtype)
    return g.reshape(b, q, k * cin) @ w.to(dtype).reshape(k * cin, -1)


def stencil_conv(values, keys, qkeys, seg_ids, w, *, seg, qblock,
                 compute_dtype):
    """``stencil_conv_plain``'s contract, checked for both routes; on a
    CUDA device it launches the ``stencil_conv`` kernel (float32 values
    there)."""
    dev = values.device
    check(values, "values", torch.float32, 3, dev)
    check(keys, "keys", torch.int32, 2, dev)
    check(qkeys, "qkeys", torch.int32, 3, dev)
    check(seg_ids, "seg_ids", torch.int32, 3, dev)
    check(w, "w", torch.float32, 3, dev)
    b, v, cin = values.shape
    q, k = qkeys.shape[1:]
    nqb, s = seg_ids.shape[1:]
    cout = w.shape[2]
    if (tuple(keys.shape) != (b, v) or qkeys.shape[0] != b or
            seg_ids.shape[0] != b or tuple(w.shape[:2]) != (k, cin)):
        raise ValueError(
            "values [B,V,Cin], keys [B,V], qkeys [B,Q,K], seg_ids [B,nqb,S], "
            f"w [K,Cin,Cout]: got {tuple(values.shape)}, {tuple(keys.shape)}, "
            f"{tuple(qkeys.shape)}, {tuple(seg_ids.shape)}, {tuple(w.shape)}")
    if nqb != -(-q // qblock) or s > -(-v // seg):
        raise ValueError(f"bad table shapes: V {v}, seg {seg}, Q {q}, qblock "
                         f"{qblock}, nqb {nqb}, S {s}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype} not in "
                         f"{COMPUTE_DTYPES}")
    if route(values, "stencil") == "plain":
        return stencil_conv_plain(values, keys, qkeys, seg_ids, w, seg=seg,
                                  qblock=qblock, compute_dtype=compute_dtype)
    if (qblock not in KERNEL_QBLOCKS or k > KERNEL_MAX_TAPS or
            s * seg > KERNEL_MAX_TABLE or qblock * k > KERNEL_MAX_TAP_ROWS):
        raise ValueError(f"stencil_conv kernel: qblock {qblock} not in "
                         f"{KERNEL_QBLOCKS}, or K {k} > {KERNEL_MAX_TAPS}, or "
                         f"table {s * seg} > {KERNEL_MAX_TABLE}, or qblock * "
                         f"K {qblock * k} > {KERNEL_MAX_TAP_ROWS}")
    from ._build import library
    keys = _pad_keys(keys, seg)
    out = torch.empty((b, q, cout), dtype=torch.float32, device=dev)
    err = library().stencil_conv_launch(
        values.data_ptr(), keys.data_ptr(), qkeys.data_ptr(),
        seg_ids.data_ptr(), w.data_ptr(), out.data_ptr(), b, v,
        keys.shape[1], q, k, cin, cout, nqb, s, seg, qblock,
        int(compute_dtype == torch.bfloat16), stream())
    raise_on(err, "stencil_conv")
    LAUNCHES["stencil_conv"] += 1
    return out
