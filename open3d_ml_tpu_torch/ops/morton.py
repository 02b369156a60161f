"""Hilbert-curve codes and the curve sort of a point batch.

Counterpart of ``open3d_ml_tpu/ops/morton.py`` (``_quantize``,
``hilbert_codes``) and of the sort in ``build_bucket_pyramid_tpu``
(``open3d_ml_tpu/ops/bucket.py``). The codes equal the JAX package's bit
for bit, and the sort is stable as ``jnp.argsort`` is, so the port walks
the points in the same order.
"""

import torch


def _spread_bits(v):
    """Spread the low 10 bits of int32 ``v`` so two zero bits sit between
    every data bit (Morton bit dilation)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _quantize(pts, levels):
    """[..., N, 3] float32 points -> int32 grid coords in [0, levels) over
    each cloud's bounding box."""
    lo = pts.amin(dim=-2, keepdim=True)
    hi = pts.amax(dim=-2, keepdim=True)
    top = float(levels - 1)
    # a true division: ``float / tensor`` would multiply by a reciprocal
    # and round differently from the JAX package
    scale = torch.div(torch.full_like(lo, top), torch.clamp(hi - lo, min=1e-6))
    return torch.clamp((pts - lo) * scale, 0.0, top).to(torch.int32)


def hilbert_codes(pts, bits=10):
    """30-bit Hilbert codes of [..., N, 3] float32 points (10 bits per axis,
    Skilling's transpose algorithm), each cloud normalised to its own
    bounding box. Returns [..., N] int32."""
    x = _quantize(pts, 1 << bits)
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    for qbit in range(bits - 1, 0, -1):
        qv = 1 << qbit
        pv = qv - 1
        x0 = torch.where((x0 & qv) != 0, x0 ^ pv, x0)
        for axis in (1, 2):
            xin = x1 if axis == 1 else x2
            cond = (xin & qv) != 0
            x0_inv = torch.where(cond, x0 ^ pv, x0)
            t = torch.where(cond, 0, (x0_inv ^ xin) & pv)
            x0 = x0_inv ^ t
            if axis == 1:
                x1 = xin ^ t
            else:
                x2 = xin ^ t
    # Gray encode
    x1 = x1 ^ x0
    x2 = x2 ^ x1
    t = torch.zeros_like(x0)
    for qbit in range(bits - 1, 0, -1):
        qv = 1 << qbit
        t = torch.where((x2 & qv) != 0, t ^ (qv - 1), t)
    x0, x1, x2 = x0 ^ t, x1 ^ t, x2 ^ t
    return ((_spread_bits(x0) << 2) | (_spread_bits(x1) << 1) |
            _spread_bits(x2))


def hilbert_sort(points):
    """Sort each cloud of [B, N, 3] along the Hilbert curve.

    Returns (perm [B, N] int32, sorted points [B, N, 3]); ``perm`` maps a
    sorted position to the caller's index. Equal codes keep the caller's
    order (stable sort), as ``jnp.argsort`` does.
    """
    codes = hilbert_codes(points)
    perm = torch.argsort(codes, dim=1, stable=True)
    sorted_pts = torch.gather(points, 1, perm[..., None].expand(-1, -1, 3))
    return perm.to(torch.int32), sorted_pts
