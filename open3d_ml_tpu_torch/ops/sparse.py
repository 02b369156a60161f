"""Sparse (submanifold) convolution over active sites by hashing: the exact
twin of the stencil path.

Counterpart of ``open3d_ml_tpu/ops/sparse.py``. Active voxel sites are
padded [V, 3] int32 coordinate arrays with masks. The rulebook is a dense
[V, K] matrix of neighbour indices, found by a sort of the sites' linear
keys and a ``searchsorted`` of the tap keys; a convolution is a row gather
and one [V, K * Cin] x [K * Cin, Cout] product. Plain PyTorch; no kernel.

Coordinates are rebased to >= 0 with an extent below 2^10 per axis, so
linear keys fit int32.
"""

import numpy as np
import torch

_EXTENT = 1 << 10
_I32MAX = torch.iinfo(torch.int32).max


def linearize(coords, mask=None):
    """[..., 3] int32 coords -> int32 keys; masked or out-of-range sites
    key to INT32_MAX."""
    key = (coords[..., 2] * _EXTENT + coords[..., 1]) * _EXTENT + \
        coords[..., 0]
    in_range = ((coords >= 0) & (coords < _EXTENT)).all(-1)
    if mask is not None:
        in_range &= mask
    return torch.where(in_range, key, _I32MAX)


class SiteHash:
    """Sorted-key lookup table over the active sites of one sample."""

    def __init__(self, coords, mask):
        self.num_sites = coords.shape[0]
        key = linearize(coords, mask)
        self.order = torch.sort(key, stable=True).indices
        self.sorted_key = key[self.order]

    def lookup(self, query_coords, query_mask=None):
        """([Q] int64 site index, num_sites where missing; [Q] found)."""
        qkey = linearize(query_coords, query_mask)
        pos = torch.searchsorted(self.sorted_key, qkey)
        pos = pos.clamp(0, self.num_sites - 1)
        found = (self.sorted_key[pos] == qkey) & (qkey != _I32MAX)
        return torch.where(found, self.order[pos], self.num_sites), found


def kernel_offsets(kernel_size=3, centered=True):
    """[K, 3] numpy int32 offsets, x fastest: this order fixes the layout
    of every stencil weight [K, Cin, Cout]."""
    rng = (range(-(kernel_size // 2), kernel_size // 2 + 1) if centered
           else range(kernel_size))
    return np.asarray([(x, y, z) for z in rng for y in rng for x in rng],
                      np.int32)


def build_rulebook(coords, mask, offsets, *, site_hash=None):
    """[V, K] int64 index of the site at each (site, offset), V where that
    site is not active."""
    sh = site_hash or SiteHash(coords, mask)
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=coords.device)
    q = coords[:, None, :] + offs[None]  # [V, K, 3]
    idx, _ = sh.lookup(q.reshape(-1, 3),
                       mask[:, None].expand(-1, offs.shape[0]).reshape(-1))
    return idx.reshape(coords.shape[0], offs.shape[0])


def _cast(features, weights, compute_dtype):
    """(features, weights) rounded to ``compute_dtype`` where given, and
    the type the product sums in: float32, or float64 for float64
    features."""
    acc = torch.promote_types(features.dtype, torch.float32)
    if compute_dtype is None:
        return features, weights, acc
    return features.to(compute_dtype), weights.to(compute_dtype), acc


def apply_sparse_conv(features, rulebook, weights, *, out_mask=None,
                      normalize=False, compute_dtype=None):
    """Gather-GEMM sparse convolution: [V_out, Cout] float32 (float64 for
    float64 features) from features [V_in, Cin], the rulebook [V_out, K]
    (V_in = missing) and weights [K, Cin, Cout]. ``compute_dtype`` rounds
    features and weights to it before the product, whose sums stay
    float32; ``normalize`` divides by the count of present taps;
    ``out_mask`` zeroes padded rows."""
    v_in = features.shape[0]
    k, cin, cout = weights.shape
    features, weights, acc = _cast(features, weights, compute_dtype)
    feats = torch.cat([features, features.new_zeros((1, cin))]).to(acc)
    gathered = feats[rulebook]  # [V_out, K, Cin]
    out = gathered.reshape(-1, k * cin) @ weights.to(acc).reshape(k * cin,
                                                                  cout)
    if normalize:
        cnt = (rulebook < v_in).sum(1, keepdim=True)
        out = out / cnt.clamp(min=1).to(out.dtype)
    if out_mask is not None:
        out = torch.where(out_mask[:, None], out, 0.0)
    return out


def unique_sites(coords, mask, cap):
    """Unique rows of [V, 3] coords, padded to ``cap``, in ascending linear
    key order: (coords [cap, 3], mask [cap], inverse [V] int64 rank of each
    input row's site, ``cap`` where masked or beyond the cap)."""
    v = coords.shape[0]
    key = linearize(coords, mask)
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    svalid = skey != _I32MAX
    prev = torch.cat([skey.new_full((1,), -1), skey[:-1]])
    new_run = (skey != prev) & svalid
    rank = torch.cumsum(new_run.long(), 0) - 1
    rank = torch.where(svalid & (rank < cap), rank, cap)
    # rows with one rank have one coordinate triple: duplicate targets
    # write identical values (row cap is the dump, sliced off)
    ucoords = coords.new_zeros((cap + 1, 3))
    ucoords[rank] = coords[order]
    umask = torch.zeros((cap + 1,), dtype=torch.bool, device=coords.device)
    umask[rank] = True
    inverse = torch.empty((v,), dtype=torch.int64, device=coords.device)
    inverse[order] = rank
    return ucoords[:cap], umask[:cap], inverse


def downsample_sites(coords, mask, cap):
    """Stride-2 parents, unique(coords // 2): (parent coords [cap, 3],
    parent mask [cap], parent index [V] of each site, cap where dropped;
    child offset [V] in [0, 8), x fastest)."""
    parent = torch.div(coords, 2, rounding_mode="floor")
    pcoords, pmask, inverse = unique_sites(parent, mask, cap)
    rem = coords - parent * 2
    off_idx = (rem[:, 2] * 2 + rem[:, 1]) * 2 + rem[:, 0]
    return pcoords, pmask, inverse, off_idx


def apply_sparse_conv_transpose(coarse_features, parent_idx, child_off_idx,
                                weights, *, out_mask=None,
                                compute_dtype=None):
    """Stride-2 kernel-2 transpose convolution: each fine site reads its
    parent's row (``parent_idx``, V_coarse = missing) through the weight
    slice ``weights[child_off_idx]``. [V_fine, Cout] float32 (float64 for
    float64 features)."""
    cin = coarse_features.shape[1]
    k, _, cout = weights.shape
    coarse_features, weights, acc = _cast(coarse_features, weights,
                                          compute_dtype)
    feats = torch.cat([coarse_features,
                       coarse_features.new_zeros((1, cin))]).to(acc)
    gathered = feats[parent_idx]  # [V_fine, Cin]
    outs = torch.einsum("vc,kco->vko", gathered, weights.to(acc))
    out = torch.gather(outs, 1, child_off_idx.long()[:, None, None].expand(
        -1, 1, cout))[:, 0]
    if out_mask is not None:
        out = torch.where(out_mask[:, None], out, 0.0)
    return out
