"""Block tables for the stencil convolutions of SparseConvUnet.

Counterpart of ``open3d_ml_tpu/ops/sparse_bucket.py`` for the fused path:

1. The active sites are sorted once by their 30-bit Morton key. A parent's
   key is its child's key >> 3, so stride-2 downsampling keeps the order:
   every deeper level dedups a sorted array by its runs, with no sort.
2. The sorted sites are cut into segments of ``seg`` rows; for each block
   of ``qblock`` consecutive query sites the segments are ranked by the
   bbox-to-bbox lower bound and the best S kept: the block's candidate
   table. It is exact whenever the segments in reach number S or fewer;
   the shortfall is counted (``overflow``; 0 means exact).
3. Each stencil tap is a Morton key (``stencil_query_keys``, or the child
   codes of the down and up convolutions), matched against the table by
   key equality inside the stencil-conv kernel (``ops/cuda/stencil.py``).

The unfused composition of the JAX package (``match_stencil``,
``gather_taps``, ``BucketCtx``) is not ported.
"""

from typing import Any, NamedTuple

import torch

from .morton import _spread_bits

_I32MAX = torch.iinfo(torch.int32).max
_FAR = 1e9  # padded support rows


def morton_key_int(coords, mask=None):
    """[..., 3] int32 coords (each in [0, 1024)) -> 30-bit Morton key, z in
    the high bit of each triplet: key & 7 == z0*4 + y0*2 + x0 is the child's
    place in its 2^3 parent block, key >> 3 the parent's key. Sites out of
    range or masked key to INT32_MAX."""
    x = _spread_bits(coords[..., 0])
    y = _spread_bits(coords[..., 1])
    z = _spread_bits(coords[..., 2])
    key = (z << 2) | (y << 1) | x
    in_range = ((coords >= 0) & (coords < 1024)).all(-1)
    if mask is not None:
        in_range &= mask
    return torch.where(in_range, key, _I32MAX)


def sort_sites(coords, mask):
    """Morton-sort padded sites [B, V, 3] int32 with [B, V] masks.

    Invalid rows key to INT32_MAX and stay a suffix, in their order (a
    stable sort). Returns (coords, mask, key, inv_perm), the first three
    in sorted order; inv_perm [B, V] int32 maps an original row to its
    sorted position.
    """
    key = morton_key_int(coords, mask)
    perm = torch.sort(key, dim=-1, stable=True).indices
    scoords = torch.gather(coords, 1, perm[..., None].expand(-1, -1, 3))
    smask = torch.gather(mask, 1, perm)
    skey = torch.gather(key, 1, perm)
    pos = torch.arange(coords.shape[1], dtype=torch.int32,
                       device=coords.device).expand_as(perm).contiguous()
    inv_perm = torch.empty_like(pos).scatter_(1, perm, pos)
    return scoords, smask, skey, inv_perm


def support_points(coords, mask, seg):
    """[B, V, 3] sites -> [B, Vp, 3] float32 support rows: valid coords,
    1e9 for invalid and pad rows, Vp the next multiple of ``seg``."""
    pts = torch.where(mask[..., None], coords.float(), _FAR)
    pad = (-pts.shape[-2]) % seg
    if pad:
        pts = torch.nn.functional.pad(pts, (0, 0, 0, pad), value=_FAR)
    return pts


def _masked_bboxes(pts, num_valid, rows):
    """[B, nc, 3] (lo, hi) bboxes of chunks of ``rows`` consecutive rows of
    [B, n, 3], over each cloud's valid prefix ``num_valid`` [B]; an empty
    chunk gets lo +3e38 and hi -3e38."""
    b, n, _ = pts.shape
    nc = -(-n // rows)
    p = torch.nn.functional.pad(pts, (0, 0, 0, nc * rows - n))
    m = (torch.arange(nc * rows, device=pts.device)[None] <
         num_valid[:, None]).reshape(b, nc, rows, 1)
    p = p.reshape(b, nc, rows, 3)
    big = 3e38
    lo = torch.where(m, p, big).amin(2)
    hi = torch.where(m, p, -big).amax(2)
    return lo, hi


def rank_site_segments(support_f, num_support, sites_f, num_sites, *, seg,
                       qblock, num_segs, reach):
    """Candidate segment table of each site block, and its overflow.

    Each block ranks the segments by score = lb * 1e4 + min(cd, 1e3), lb
    the exact lower bound on the distance between the two bboxes and cd
    half the distance between their centres, and keeps the s = min(S,
    number of segments) lowest, the lower index first among equal scores
    (as ``jax.lax.top_k`` keeps it). A padded segment's bbox is +-3e38, so
    its lb overflows to inf. Segments with lb <= reach + 0.2 beyond s are
    counted: overflow 0 certifies every table exact.

    support_f [B, Vp, 3] (1e9 pad rows) with valid prefix num_support [B];
    sites_f [B, V, 3] with valid prefix num_sites [B]. Returns (seg_ids
    [B, nqb, s] int32 best first, overflow [B] int32).
    """
    nseg = support_f.shape[1] // seg
    s = min(num_segs, nseg)
    plo, phi = _masked_bboxes(support_f, num_support, seg)
    qlo, qhi = _masked_bboxes(sites_f, num_sites, qblock)
    gap = torch.clamp(torch.maximum(qlo[:, :, None] - phi[:, None],
                                    plo[:, None] - qhi[:, :, None]), min=0.0)
    lb = torch.sqrt((gap * gap).sum(-1))  # [B, nqb, nseg]
    diff = (qlo + qhi)[:, :, None] - (plo + phi)[:, None]
    cd = torch.sqrt((diff * diff).sum(-1)) * 0.5
    score = lb * 1e4 + torch.clamp(cd, max=1e3)
    seg_ids = torch.sort(score, dim=-1, stable=True).indices[..., :s]
    in_reach = (lb <= reach + 0.2).sum(-1)
    overflow = torch.clamp(in_reach - s, min=0).sum(-1)
    return seg_ids.to(torch.int32).contiguous(), overflow.to(torch.int32)


class StencilCtx(NamedTuple):
    """One level's context for the stencil convolutions: its candidate
    tables, the per-tap query keys and the support keys."""
    seg_ids: Any  # [B, nqb, S] int32
    qkeys: Any    # [B, Q, K] int32 per-tap query keys, misses -1
    keys: Any     # [B, V] int32 support Morton keys, invalid INT32_MAX
    seg: int
    qblock: int


def stencil_query_keys(coords, mask, stencil):
    """[B, V, K] int32 Morton keys of the taps of an integer stencil [K, 3]
    around sites [B, V, 3]; a tap that cannot exist (invalid site, target
    outside the 1024^3 domain) is -1, which equals no valid key (>= 0) and
    no pad key (INT32_MAX)."""
    offs = torch.as_tensor(stencil, dtype=torch.int32, device=coords.device)
    q = coords[:, :, None, :] + offs[None, None]  # [B, V, K, 3]
    k = morton_key_int(q, mask[:, :, None].expand(q.shape[:-1]))
    return torch.where(k == _I32MAX, -1, k)


def bucket_downsample(coords, mask, mkey, cap):
    """Stride-2 parents of Morton-sorted sites, still Morton-sorted.

    A parent's key is its child's key >> 3, non-decreasing along the sorted
    children, so the parents are the runs of equal parent keys: a cumsum,
    no sort. coords [B, V, 3], mask [B, V] and mkey [B, V] (INT32_MAX for
    invalid rows) are sorted by mkey. Returns (pcoords [B, cap, 3], pmask
    [B, cap], pkey [B, cap], off_idx [B, V] the child's place in [0, 8),
    dropped [B] children whose parent fell beyond the cap).
    """
    b = coords.shape[0]
    dev = coords.device
    pk = torch.where(mask, mkey >> 3, _I32MAX)
    prev = torch.cat([pk.new_full((b, 1), -1), pk[:, :-1]], 1)
    valid = pk != _I32MAX
    new_run = (pk != prev) & valid
    rank = torch.cumsum(new_run.to(torch.int32), 1, dtype=torch.int32) - 1
    rank_c = torch.where(valid & (rank < cap), rank, cap).long()
    # all children of a parent carry its coordinates and key: duplicate
    # targets write identical values (column cap is the dump)
    pcoords = torch.zeros((b, cap + 1, 3), dtype=torch.int32, device=dev)
    pcoords.scatter_(1, rank_c[..., None].expand(-1, -1, 3), coords >> 1)
    pmask = torch.zeros((b, cap + 1), dtype=torch.bool, device=dev)
    pmask.scatter_(1, rank_c, True)
    pkey = torch.full((b, cap + 1), _I32MAX, dtype=torch.int32, device=dev)
    pkey.scatter_(1, rank_c, pk)
    off_idx = torch.where(mask, mkey & 7, 0)
    dropped = (mask & (rank >= cap)).sum(1).to(torch.int32)
    return (pcoords[:, :cap].contiguous(), pmask[:, :cap].contiguous(),
            pkey[:, :cap].contiguous(), off_idx, dropped)
