"""The stencil convolution of SparseConvUnet and its rulebook: CUDA
kernels, their plain versions, the wrappers the network calls, and the
convolution's gradient.

``stencil_conv`` takes the plain version for tensors on the CPU and
launches ``csrc/stencil_conv.cu`` for tensors on a CUDA device;
``stencil_match`` does the same with ``csrc/stencil_match.cu``. Neither
has another route. ``LAUNCHES`` counts their kernel launches.
``StencilConv`` is the convolution with its gradient, the port of the JAX
package's custom VJP: its backward recomputes the rulebook with
``stencil_match`` and runs the bucket gather and its backward
(``ops/cuda/bucket.py``) around two matrix products, on either route.
``stencil_conv`` hands values or weights that need a gradient to it.
"""

import torch

from ._launch import SMEM_LIMIT, check, raise_on, route, stream
from ._launch import fits as _fits
from ._launch import sm_count as _sm_count
from .bucket import gather_bucket, gather_bucket_bwd

LAUNCHES = {"stencil_conv": 0, "stencil_match": 0}

_I32MAX = torch.iinfo(torch.int32).max
BIGPOS = 0x7F000000  # the rulebook's miss: past any table position
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# what the kernels are built for: a query block of 32, 64 or 128 rows and
# at most 32 taps; their shared memory (the table of S * seg keys, the
# tiles) is what the kernel library's ``stencil_*_shared`` give for a
# launch (``match_shared``, ``conv_plan``) and may reach the H100's opt-in
# limit
KERNEL_QBLOCKS = (32, 64, 128)
KERNEL_MAX_TAPS = 32
_SMEM_HALF_SM = 115_712  # the most each of two blocks on one SM may have
_ROWS = 32  # queries per row tile of the bf16 convolution kernel


def _pad_keys(keys, seg):
    """Pad [B, V] keys to a multiple of ``seg`` rows with INT32_MAX."""
    pad = (-keys.shape[1]) % seg
    if not pad:
        return keys
    return torch.nn.functional.pad(keys, (0, pad), value=_I32MAX)


def _table_match(keys, qkeys, seg_ids, *, seg, qblock):
    """(table position [B, nqb, qblock * K] int64 of each tap's match, its
    found mask, the tables' value rows [B, nqb, S * seg] int64), the taps
    of block i in row i, padded queries missing.

    For each block the table's keys are sorted with their positions and
    the block's tap keys are looked up with ``searchsorted``: O(nqb * table)
    memory. The sort is stable, so where a key sits at several positions
    (a segment twice in a table) the least one is found.
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
    return torch.gather(order, 2, pos), found, cand


def stencil_rows(keys, qkeys, seg_ids, *, seg, qblock):
    """The rulebook of the stencil convolution: [B, Q, K] int64 support row
    whose key equals each tap key within the tap's block table, and [B, Q,
    K] found. A tap key that no row of the table holds is a miss, even
    where a row outside the table holds it. keys [B, Vp] (Vp a multiple of
    ``seg``), qkeys [B, Q, K], seg_ids [B, nqb, S] with nqb * qblock >= Q.
    A key is held by one row at most (valid keys are distinct, pad keys
    INT32_MAX and misses -1 never match), so the match is unique."""
    b, q, k = qkeys.shape
    pos, found, cand = _table_match(keys, qkeys, seg_ids, seg=seg,
                                    qblock=qblock)
    rows = torch.gather(cand, 2, pos)
    return (rows.reshape(b, -1, k)[:, :q], found.reshape(b, -1, k)[:, :q])


def stencil_match_plain(keys, qkeys, seg_ids, *, seg, qblock):
    """The rulebook as table positions: (rel [B, Q, K] int32, the least
    position (slot * seg + row) of the tap's block table whose key equals
    the tap key, ``BIGPOS`` where none does; found [B, Q, K] bool).

    keys [B, Vp] int32 (Vp a multiple of ``seg``; pad rows INT32_MAX),
    qkeys [B, Q, K] int32 (misses -1), seg_ids [B, nqb, S] int32 with
    nqb * qblock >= Q. ``stencil_match_pallas``'s contract.
    """
    b, q, k = qkeys.shape
    pos, found, _ = _table_match(keys, qkeys, seg_ids, seg=seg,
                                 qblock=qblock)
    rel = torch.where(found, pos, BIGPOS).to(torch.int32)
    return (rel.reshape(b, -1, k)[:, :q].contiguous(),
            found.reshape(b, -1, k)[:, :q].contiguous())


def _check_tables(b, v, seg, q, qblock, seg_ids):
    nqb, s = seg_ids.shape[1:]
    if seg_ids.shape[0] != b or nqb != -(-q // qblock) or s > -(-v // seg):
        raise ValueError(f"bad table shapes: B {b}, V {v}, seg {seg}, Q {q}, "
                         f"qblock {qblock}, seg_ids {tuple(seg_ids.shape)}")


def match_shared(s, seg):
    """Shared memory of the ``stencil_match`` kernel in bytes, as the
    kernel library computes it (``stencil_match_shared``: its sorted table
    and the sorted place of each slot); raises past ``SMEM_LIMIT``, naming
    the size."""
    from ._build import library
    return _fits("stencil_match", library().stencil_match_shared(s, seg))


def conv_plan(b, q, k, cin, cout, s, seg, qblock, *, bf16, sms):
    """How the ``stencil_conv`` kernel runs one call: {"route": 1 for the
    bf16 tensor-core kernel, 0 for the float32 FMA kernel; "ct": output
    channels per block; "mw": row tiles of 32 queries per block and
    "stages": the depth of its copy ring (bf16); "shared": its shared
    memory in bytes, as the kernel library computes it for the plan
    (``stencil_conv_shared``)}. Raises past ``SMEM_LIMIT``.

    ct is 32 where Cout <= 32, else 64. At bf16, mw is the largest of 4
    and 2 that still gives two blocks per SM (``sms`` of them; the weight
    tiles are shared by more rows), else 1, where the block's 4 warps
    split the taps; where even that leaves SMs without a block, ct falls
    to 32. The ring has 3 stages where two blocks fit on an SM, else 2:
    a deeper ring did not help on the H100 (the copies' issue, not their
    latency, sets the pace), a second block on the SM does."""
    from ._build import library
    lib = library()

    def size(route, ct, mw, stages):
        return lib.stencil_conv_shared(route, ct, mw, stages, qblock, k, s,
                                       seg)

    ct = 32 if cout <= 32 else 64
    if not bf16:
        return {"route": 0, "ct": ct, "mw": 1, "stages": 0,
                "shared": _fits("stencil_conv", size(0, ct, 1, 0))}

    def blocks(mw, ct):
        return -(-(-(-q // _ROWS)) // mw) * b * -(-cout // ct)

    mw = next((m for m in (4, 2) if blocks(m, ct) >= 2 * sms), 1)
    if mw == 1 and blocks(1, ct) < sms:
        ct = 32
    stages = 3 if size(1, ct, mw, 3) <= _SMEM_HALF_SM else 2
    return {"route": 1, "ct": ct, "mw": mw, "stages": stages,
            "shared": _fits("stencil_conv", size(1, ct, mw, stages))}


def stencil_match(keys, qkeys, seg_ids, *, seg, qblock):
    """``stencil_match_plain``'s contract, checked for both routes; on a
    CUDA device it launches the ``stencil_match`` kernel.

    The kernel's precondition: the keys of each batch row ascend (pad keys
    INT32_MAX at the end), as ``sort_sites`` and ``bucket_downsample``
    leave them on every path, so that a table's segments in the order of
    their ids form one sorted array; where they do not, its matches are
    wrong (it still reads and writes only inside its arrays). The plain
    version does not need it. Its table of S * seg keys must fit the
    shared memory (``match_shared``)."""
    dev = keys.device
    check(keys, "keys", torch.int32, 2, dev)
    check(qkeys, "qkeys", torch.int32, 3, dev)
    check(seg_ids, "seg_ids", torch.int32, 3, dev)
    b, vp = keys.shape
    q, k = qkeys.shape[1:]
    nqb, s = seg_ids.shape[1:]
    if qkeys.shape[0] != b or vp % seg:
        raise ValueError(f"keys [B, Vp] with Vp a multiple of seg {seg}, "
                         f"qkeys [B, Q, K]: got {tuple(keys.shape)}, "
                         f"{tuple(qkeys.shape)}")
    _check_tables(b, vp, seg, q, qblock, seg_ids)
    if route(keys, "stencil") == "plain":
        return stencil_match_plain(keys, qkeys, seg_ids, seg=seg,
                                   qblock=qblock)
    shared = match_shared(s, seg)
    from ._build import library
    rel = torch.empty((b, q, k), dtype=torch.int32, device=dev)
    found = torch.empty((b, q, k), dtype=torch.bool, device=dev)
    err = library().stencil_match_launch(
        keys.data_ptr(), qkeys.data_ptr(), seg_ids.data_ptr(), rel.data_ptr(),
        found.data_ptr(), b, vp, q, k, nqb, s, seg, qblock, shared, stream())
    raise_on(err, "stencil_match")
    LAUNCHES["stencil_match"] += 1
    return rel, found


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
    there): at ``compute_dtype`` bfloat16 its tensor-core route, at
    float32 its FMA route, sized by ``conv_plan``. Its precondition is
    ``stencil_match``'s: the keys of each batch row ascend. Values or
    weights that need a gradient go through ``StencilConv``, whose forward
    this is."""
    if (values.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        return StencilConv.apply(values, keys, qkeys, seg_ids, w, seg, qblock,
                                 compute_dtype)
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
            tuple(w.shape[:2]) != (k, cin)):
        raise ValueError(
            "values [B,V,Cin], keys [B,V], qkeys [B,Q,K], seg_ids [B,nqb,S], "
            f"w [K,Cin,Cout]: got {tuple(values.shape)}, {tuple(keys.shape)}, "
            f"{tuple(qkeys.shape)}, {tuple(seg_ids.shape)}, {tuple(w.shape)}")
    _check_tables(b, v, seg, q, qblock, seg_ids)
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype} not in "
                         f"{COMPUTE_DTYPES}")
    if route(values, "stencil") == "plain":
        return stencil_conv_plain(values, keys, qkeys, seg_ids, w, seg=seg,
                                  qblock=qblock, compute_dtype=compute_dtype)
    if qblock not in KERNEL_QBLOCKS or k > KERNEL_MAX_TAPS:
        raise ValueError(f"stencil_conv kernel: qblock {qblock} not in "
                         f"{KERNEL_QBLOCKS}, or K {k} > {KERNEL_MAX_TAPS}")
    plan = conv_plan(b, q, k, cin, cout, s, seg, qblock,
                     bf16=compute_dtype == torch.bfloat16,
                     sms=_sm_count(dev.index))
    from ._build import library
    keys = _pad_keys(keys, seg)
    out = torch.empty((b, q, cout), dtype=torch.float32, device=dev)
    err = library().stencil_conv_launch(
        values.data_ptr(), keys.data_ptr(), qkeys.data_ptr(),
        seg_ids.data_ptr(), w.data_ptr(), out.data_ptr(), b, v,
        keys.shape[1], q, k, cin, cout, nqb, s, seg, qblock, plan["route"],
        plan["ct"], plan["mw"], plan["stages"], plan["shared"], stream())
    raise_on(err, "stencil_conv")
    LAUNCHES["stencil_conv"] += 1
    return out


def _round(x, bf16):
    return x.bfloat16().float() if bf16 else x


def stencil_conv_bwd(g, values, keys, qkeys, seg_ids, w, *, seg, qblock,
                     compute_dtype, need=(True, True)):
    """The gradients (dvalues [B, V, Cin], dw [K, Cin, Cout]) of
    ``stencil_conv`` for the cotangent g [B, Q, Cout], each None where
    ``need`` says so, as ``stencil_conv_pallas``'s custom VJP computes
    them: the rulebook again (``stencil_match``; a miss reads position 0
    and is masked), G = the gathered rows of the values (``gather_bucket``)
    times found, dw = G^T g and dG = g w^T (float32 sums), and dvalues =
    the scatter-add of dG times found into the value rows
    (``gather_bucket_bwd``). With ``compute_dtype`` bfloat16, as JAX's
    transposes of the bf16 product round them, G and w are rounded to
    bfloat16 before the products and dw and dG once after them; g is not
    rounded, and the scatter-add's own rounding of dG changes nothing.
    """
    b, v, cin = values.shape
    q, k = qkeys.shape[1:]
    cout = w.shape[2]
    bf16 = compute_dtype == torch.bfloat16
    tabs = dict(seg=seg, qblock=qblock)
    rel, found = stencil_match(_pad_keys(keys, seg), qkeys, seg_ids, **tabs)
    rel = torch.where(found, rel, 0)
    hit = found[..., None].float()
    g2 = g.reshape(b * q, cout)
    dvalues = dw = None
    if need[1]:
        vals = torch.nn.functional.pad(values.detach(),
                                       (0, 0, 0, (-v) % seg))
        rows = gather_bucket(vals, seg_ids, rel, round_bf16=bf16, **tabs)
        dw = rows.mul_(hit).reshape(b * q, k * cin).T @ g2
        dw = _round(dw, bf16).reshape(k, cin, cout)
    if need[0]:
        dg = g2 @ _round(w.detach(), bf16).reshape(k * cin, cout).T
        dg = _round(dg, bf16).reshape(b, q, k, cin).mul_(hit)
        dvalues = gather_bucket_bwd(dg, seg_ids, rel, v + (-v) % seg,
                                    round_bf16=bf16, **tabs)[:, :v]
    return dvalues, dw


class StencilConv(torch.autograd.Function):
    """``stencil_conv`` with its gradient ``stencil_conv_bwd``:
    ``StencilConv.apply(values, keys, qkeys, seg_ids, w, seg, qblock,
    compute_dtype)``. The keys and tables carry no gradient. (The forward
    runs with gradients off, so its ``stencil_conv`` launches the kernel or
    takes the plain version.)"""

    @staticmethod
    def forward(ctx, values, keys, qkeys, seg_ids, w, seg, qblock,
                compute_dtype):
        ctx.save_for_backward(values, keys, qkeys, seg_ids, w)
        ctx.meta = (seg, qblock, compute_dtype)
        return stencil_conv(values, keys, qkeys, seg_ids, w, seg=seg,
                            qblock=qblock, compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, g):
        values, keys, qkeys, seg_ids, w = ctx.saved_tensors
        seg, qblock, compute_dtype = ctx.meta
        dvalues, dw = stencil_conv_bwd(
            g.contiguous(), values, keys, qkeys, seg_ids, w, seg=seg,
            qblock=qblock, compute_dtype=compute_dtype,
            need=(ctx.needs_input_grad[0], ctx.needs_input_grad[4]))
        return dvalues, None, None, None, dw, None, None, None
