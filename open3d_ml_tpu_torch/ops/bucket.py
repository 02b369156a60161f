"""Segment-bucketed neighbour pyramid over Hilbert-sorted point batches.

Counterpart of ``open3d_ml_tpu/ops/bucket.py`` on the paths RandLA-Net's
and PointTransformer's fused nets take (``build_bucket_pyramid``,
``build_pt_pyramid``): sort each cloud along the Hilbert curve, cut the
sorted order into segments of ``seg`` points, give every block of
``qblock`` queries a candidate table of the S segments nearest to it
(``select_segments``), search the table exactly (the bucket KNN kernel),
shrink the tables to the slots the search hit (``compact_tables``), and
read RandLA-Net's upsample tables off the fine search
(``derive_up_tables``) or search PointTransformer's 3-NN ones.

The JAX package built these stages from one-hot matmuls and ``top_k``
because row gathers and scatters were slow on its TPU. Here they are
integer gathers, scatters and stable sorts, which give the same integers:
``jax.lax.top_k`` puts the lower index first among equal values, and a
stable sort does the same.
"""

import torch

from .cuda.bucket import knn_bucket
from .morton import hilbert_sort

_FAR = 3e38


def pad_seg(x, seg, fill=0.0):
    """Pad the rows of [B, N, C] up to a multiple of ``seg`` with ``fill``."""
    pad = (-x.shape[1]) % seg
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0, 0, pad), value=fill)


def _summaries(pts, seg, nseg):
    """Per-segment bounding boxes of [B, N, 3]: (lo, hi), each
    [B, nseg, 3]. Rows past N are left out of the min and max."""
    lo = pad_seg(pts, seg, _FAR).reshape(pts.shape[0], nseg, seg, 3)
    hi = pad_seg(pts, seg, -_FAR).reshape(pts.shape[0], nseg, seg, 3)
    return lo.amin(dim=2), hi.amax(dim=2)


def _norm3(v):
    """Euclidean norm over the last axis of size 3, summed in index order."""
    sq = v * v
    return torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])


def _smallest(x, s):
    """Indices of the ``s`` smallest entries along the last axis, lower
    index first among equals (``jax.lax.top_k`` of ``-x``)."""
    return torch.sort(x, dim=-1, stable=True).indices[..., :s]


def select_segments(points, queries, *, seg, qblock, num_segs, sub=4):
    """Top-S candidate segments per query block, best first.

    Segments are scored per query sub-block (``qblock // sub`` queries) by
    the bounding-box lower bound on point-pair distance, tie-broken by the
    box-centre distance, then merged across a block's sub-blocks by best
    rank (the ``merge="rank"`` path of the JAX package).

    points [B, N, 3] and queries [B, Q, 3] are curve-sorted float32.
    Returns seg_ids [B, nqb, S] int32.
    """
    b, n, _ = points.shape
    q = queries.shape[1]
    nseg = -(-n // seg)
    nqb = -(-q // qblock)
    s = min(num_segs, nseg)
    sq = max(qblock // sub, 1)
    nsb = -(-q // sq)

    plo, phi = _summaries(points, seg, nseg)
    qlo, qhi = _summaries(queries, sq, nsb)
    gap = torch.clamp(torch.maximum(qlo[:, :, None] - phi[:, None],
                                    plo[:, None] - qhi[:, :, None]), min=0.0)
    lb = _norm3(gap)
    cd = _norm3((qlo + qhi)[:, :, None] - (plo + phi)[:, None]) * 0.5
    score = lb * 1e4 + cd                                   # [B, nsb, nseg]

    # A segment in the merged top-S is in the top-S of some sub-block, so
    # each sub-block's top-S plus a scatter-min of rank-major keys into a
    # per-block grid is exact.
    order = torch.sort(score, dim=-1, stable=True)
    ids, best = order.indices[..., :s], order.values[..., :s]
    key = (torch.arange(s, dtype=torch.float32, device=points.device) * 1e6 +
           torch.clamp(best, max=1e5))
    blk = torch.arange(nsb, device=points.device) // sub
    flat = (blk[None, :, None] * nseg + ids).reshape(b, -1)
    grid = torch.full((b, nqb * nseg), _FAR, dtype=torch.float32,
                      device=points.device)
    grid.scatter_reduce_(1, flat, key.reshape(b, -1), reduce="amin")
    return _smallest(grid.reshape(b, nqb, nseg), s).to(torch.int32)


def compact_tables(seg_ids, rel, gather_segs, *, seg, qblock):
    """Shrink each block's candidate table to the ``gather_segs`` slots its
    neighbours hit most, and re-express ``rel`` in the compact table.

    A neighbour in a dropped slot becomes a copy of its query's nearest kept
    neighbour. seg_ids [B, nqb, S] and rel [B, Q, k] (rows ascending by
    distance) in, (seg_ids [B, nqb, S'], rel [B, Q, k]) out.
    """
    b, nqb, s = seg_ids.shape
    q, k = rel.shape[1:]
    sp = min(gather_segs, s)
    qpad = nqb * qblock - q
    relp = torch.nn.functional.pad(rel, (0, 0, 0, qpad), value=-1)
    relp = relp.reshape(b, nqb, qblock * k)
    slot = torch.div(relp, seg, rounding_mode="floor")     # -1 on pad rows
    # hits per slot; pad entries land in the extra column s and are dropped
    hist = torch.zeros((b, nqb, s + 1), dtype=torch.float32,
                       device=rel.device)
    hist.scatter_add_(2, torch.where(slot < 0, s, slot).long(),
                      torch.ones_like(slot, dtype=torch.float32))
    bias = torch.arange(s, dtype=torch.float32, device=rel.device) * 1e-3
    keep = torch.sort(hist[..., :s] - bias, dim=-1, descending=True,
                      stable=True).indices[..., :sp]
    new_sids = torch.gather(seg_ids, 2, keep)
    # old slot -> compact slot, -1 where the slot was dropped
    inv = torch.full((b, nqb, s), -1, dtype=torch.int32, device=rel.device)
    inv.scatter_(2, keep, torch.arange(sp, dtype=torch.int32,
                                       device=rel.device).expand(b, nqb, sp))
    new_slot = torch.gather(inv, 2, slot.clamp(min=0).long())
    new_rel = (new_slot * seg + relp % seg).reshape(b, nqb * qblock, k)
    first_kept = (new_rel >= 0).to(torch.int32).argmax(dim=-1, keepdim=True)
    fb = torch.gather(new_rel, 2, first_kept).clamp(min=0)
    new_rel = torch.where(new_rel < 0, fb, new_rel)
    return new_sids, new_rel[:, :q].contiguous()


def derive_up_tables(seg_ids, rel, ratio, *, seg):
    """Upsample tables read off the fine k-NN, with no search.

    The sub level is the stride-``ratio`` slice of the fine sorted order, so
    a fine table entry ``sid * seg + r`` is a sub point iff
    ``r % ratio == 0``; its sub segment is ``sid // ratio``. Each query's
    first such entry (rows ascend by distance) is its nearest sub point
    among its k fine neighbours; a query with none falls back to the parent
    of its nearest fine neighbour.

    seg_ids [B, nqb, S] and rel [B, Q, K] in; (up_seg_ids [B, nqb, S'],
    up_rel [B, Q, 1]) out, with S' = min(S // ratio + 8, S).

    The queries are blocked by ``ceil(Q / nqb)``, as in the JAX package,
    which is not the search's ``qblock`` when Q is not a multiple of it.
    """
    if seg % ratio:
        raise ValueError(f"seg {seg} is not a multiple of ratio {ratio}")
    b, nqb, s = seg_ids.shape
    q, k = rel.shape[1:]
    qblock = -(-q // nqb)
    sp = min(s // ratio + 8, s)
    dev = rel.device

    vals = torch.div(seg_ids, ratio, rounding_mode="floor")
    # best-first dedup: first_idx[j] = first slot holding vals[j]
    eq = vals[..., :, None] == vals[..., None, :]
    first_idx = eq.to(torch.int32).argmax(dim=-1)
    first_occ = first_idx == torch.arange(s, device=dev)
    csum = torch.cumsum(first_occ.to(torch.int32), dim=-1, dtype=torch.int32)
    slot_map = torch.gather(csum, 2, first_idx) - 1
    # compact sub table; slots past the unique count repeat the best one
    dest = torch.where(first_occ & (slot_map < sp), slot_map, sp).long()
    up_sids = vals[..., :1].expand(b, nqb, sp + 1).clone()
    up_sids.scatter_(2, dest, vals)
    up_sids = up_sids[..., :sp]

    relp = torch.nn.functional.pad(rel, (0, 0, 0, nqb * qblock - q))
    relg = relp.reshape(b, nqb, qblock, k)
    hit = (relg % seg) % ratio == 0
    j_star = hit.to(torch.int32).argmax(dim=-1, keepdim=True)
    e = torch.gather(relg, 3, j_star)[..., 0]               # [B, nqb, qb]
    s_idx = torch.div(e, seg, rounding_mode="floor").long()
    slot = torch.gather(slot_map, 2, s_idx).clamp(max=sp - 1)
    mod = torch.gather(seg_ids % ratio, 2, s_idx)
    up_rel = slot * seg + mod * (seg // ratio) + torch.div(
        e % seg, ratio, rounding_mode="floor")
    return up_sids.contiguous(), up_rel.reshape(b, -1, 1)[:, :q].contiguous()


def build_bucket_pyramid(points, k, sub_ratios, *, seg, qblock, num_segs,
                         gather_segs=0):
    """The per-level KNN / pool / upsample tables of RandLA-Net's fused
    path, for a [B, N, 3] batch in the caller's order.

    Counterpart of ``build_bucket_pyramid_tpu`` at ``curve="hilbert"``,
    ``presorted=False`` and ``up_mode="derive"``. Each level's sub level is
    the stride-``ratio`` slice of its sorted points. Returns a dict of
    per-level lists (``coords``, ``{nbr,pool,up}_{seg_ids,rel,qblock}``)
    plus ``perm`` [B, N].
    """
    perm, pc = hilbert_sort(points)
    out = {"perm": perm, "coords": []}
    for name in ("nbr", "pool", "up"):
        for part in ("seg_ids", "rel", "qblock"):
            out[f"{name}_{part}"] = []
    for ratio in sub_ratios:
        if seg % ratio:
            raise NotImplementedError(
                "the searched upsample (seg % ratio != 0) is not ported")
        n = pc.shape[1]
        s_here = min(num_segs, -(-n // seg))
        pcp = pad_seg(pc, seg, fill=1e9)
        sids = select_segments(pc, pc, seg=seg, qblock=qblock,
                               num_segs=s_here)
        rel, _ = knn_bucket(pcp, pc, sids, min(k, n), seg=seg, qblock=qblock)
        if gather_segs and gather_segs < s_here:
            sids, rel = compact_tables(sids, rel, gather_segs, seg=seg,
                                       qblock=qblock)
        sub = pc[:, ::ratio][:, :n // ratio].contiguous()
        if qblock % ratio == 0 and n % qblock == 0:
            # the sub points are rows of pc, so their k-NN are rows ::ratio
            # of rel against the same tables
            psids, pool_qb = sids, qblock // ratio
            prel = rel[:, ::ratio].contiguous()
        else:
            psids = select_segments(pc, sub, seg=seg, qblock=qblock,
                                    num_segs=s_here)
            prel, _ = knn_bucket(pcp, sub, psids, k, seg=seg, qblock=qblock)
            pool_qb = qblock
        usids, urel = derive_up_tables(sids, rel, ratio, seg=seg)
        for name, value in (("coords", pc), ("nbr_seg_ids", sids),
                            ("nbr_rel", rel), ("nbr_qblock", qblock),
                            ("pool_seg_ids", psids), ("pool_rel", prel),
                            ("pool_qblock", pool_qb), ("up_seg_ids", usids),
                            ("up_rel", urel), ("up_qblock", qblock)):
            out[name].append(value)
        pc = sub
    return out


def build_pt_pyramid(points, nsamples, sub_ratios, *, seg, qblock, num_segs,
                     gather_segs, up_k=3):
    """The per-level attention, grouping and upsample tables of
    PointTransformer's fused path, for a [B, N, 3] batch in the caller's
    order.

    Counterpart of ``build_pt_pyramid_tpu`` at ``curve="hilbert"`` and
    ``presorted=False``. It has one level more than ``sub_ratios``, each
    level's points the stride-``ratio`` slice of the level above in
    Hilbert order. Level i's attention tables hold each point's
    ``nsamples[i]`` nearest points of the level (cut to its point count),
    its grouping (``pool``) tables each point of level i + 1's
    ``nsamples[i + 1]`` nearest points of level i, its upsample tables
    each point of level i's ``up_k`` nearest points of level i + 1. A
    level of fewer than ``qblock`` points is one query block of at least
    8. Attention and grouping tables are compacted to ``gather_segs``
    slots where they have more; the grouping search reuses the attention
    tables (rows ::ratio) only with ``gather_segs`` 0. Returns a dict of
    per-level lists (``coords``, ``{nbr,pool,up}_{seg_ids,rel,qblock}``)
    plus ``perm`` [B, N].
    """
    perm, pc = hilbert_sort(points)
    out = {"perm": perm, "coords": []}
    for name in ("nbr", "pool", "up"):
        for part in ("seg_ids", "rel", "qblock"):
            out[f"{name}_{part}"] = []
    for i in range(len(sub_ratios) + 1):
        n = pc.shape[1]
        s_here = min(num_segs, -(-n // seg))
        qb = min(qblock, max(8, n))
        pcp = pad_seg(pc, seg, fill=1e9)
        sids = select_segments(pc, pc, seg=seg, qblock=qb, num_segs=s_here)
        # k cut to the level's points: past them the table holds pad rows
        k_here = min(nsamples[i], n)
        rel, _ = knn_bucket(pcp, pc, sids, k_here, seg=seg, qblock=qb)
        if gather_segs and gather_segs < s_here:
            sids, rel = compact_tables(sids, rel, gather_segs, seg=seg,
                                       qblock=qb)
        for name, value in (("coords", pc), ("nbr_seg_ids", sids),
                            ("nbr_rel", rel), ("nbr_qblock", qb)):
            out[name].append(value)
        if i == len(sub_ratios):
            break
        ratio = sub_ratios[i]
        sub = pc[:, ::ratio][:, :n // ratio].contiguous()
        k_dn = min(nsamples[i + 1], n)
        if (k_dn == k_here and qb % ratio == 0 and n % qb == 0 and
                not gather_segs):
            # the sub points are rows ::ratio of pc, searched against the
            # same tables
            psids, prel, pool_qb = sids, rel[:, ::ratio].contiguous(), \
                qb // ratio
        else:
            psids = select_segments(pc, sub, seg=seg, qblock=qb,
                                    num_segs=s_here)
            prel, _ = knn_bucket(pcp, sub, psids, k_dn, seg=seg, qblock=qb)
            pool_qb = qb
            if gather_segs and gather_segs < s_here:
                psids, prel = compact_tables(psids, prel, gather_segs,
                                             seg=seg, qblock=qb)
        s_up = min(max(2, num_segs // 2), -(-sub.shape[1] // seg))
        usids = select_segments(sub, pc, seg=seg, qblock=qb, num_segs=s_up)
        urel, _ = knn_bucket(pad_seg(sub, seg, fill=1e9), pc, usids,
                             min(up_k, sub.shape[1]), seg=seg, qblock=qb)
        for name, value in (("pool_seg_ids", psids), ("pool_rel", prel),
                            ("pool_qblock", pool_qb), ("up_seg_ids", usids),
                            ("up_rel", urel), ("up_qblock", qb)):
            out[name].append(value)
        pc = sub
    return out
