"""Ragged rows as (values, row_splits) pairs, and segment reductions.

Counterpart of ``open3d_ml_tpu/ops/ragged.py``: the same names,
signatures and results, written as plain functions on tensors
(``searchsorted``, ``index_add_``, ``index_put_`` and ``scatter_reduce_``
with ``include_self=False``). Each runs on its tensors' device. As in
JAX, a segment id outside [0, num_segments) is dropped by the segment
reductions; an empty segment sums to 0, averages to 0 and has the
dtype's lowest value (-inf for floats) as its maximum, and
``segment_max`` never reads ``initial`` (nor does JAX's).
``segment_ids_to_row_splits`` counts as ``jnp.bincount`` does: a negative
id in row 0, an id past the last row nowhere.
"""

from typing import NamedTuple

import torch


class RaggedArray(NamedTuple):
    """A batch of variable-length rows: values[T, ...], row_splits[R+1].

    Entries at positions >= row_splits[-1] are padding; row_splits is
    int32, non-decreasing, and starts at 0.
    """
    values: torch.Tensor
    row_splits: torch.Tensor

    @property
    def num_rows(self):
        return self.row_splits.shape[0] - 1

    def row_lengths(self):
        return self.row_splits[1:] - self.row_splits[:-1]


def row_splits_to_segment_ids(row_splits, total):
    """The row of each of ``total`` positions, int32; a position past
    row_splits[-1] (padding) gets num_rows."""
    pos = torch.arange(total, dtype=row_splits.dtype,
                       device=row_splits.device)
    ids = torch.searchsorted(row_splits, pos, right=True)
    return ids.to(torch.int32) - 1


def segment_ids_to_row_splits(segment_ids, num_rows):
    """The inverse of ``row_splits_to_segment_ids``: rows' counts, then
    their running sum after a 0, int32."""
    ids = segment_ids.long().clamp(min=0)
    ids = ids[ids < num_rows]
    counts = torch.zeros(num_rows, dtype=torch.int64,
                         device=segment_ids.device)
    counts.index_add_(0, ids, torch.ones_like(ids))
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0)]).to(torch.int32)


def ragged_to_dense(values, row_splits, num_rows, num_cols, default_value=0):
    """Ragged ``values`` as a dense [num_rows, num_cols, ...] tensor: rows
    longer than num_cols are cut, shorter ones padded with
    ``default_value``."""
    total = values.shape[0]
    seg = row_splits_to_segment_ids(row_splits, total).long()
    col = torch.arange(total, device=values.device) - row_splits.long()[seg]
    valid = (seg >= 0) & (seg < num_rows) & (col < num_cols)
    out = torch.full((num_rows, num_cols) + tuple(values.shape[1:]),
                     default_value, dtype=values.dtype, device=values.device)
    out[seg[valid], col[valid]] = values[valid]
    return out


def dense_to_ragged_mask(row_lengths, num_cols):
    """Boolean mask [R, num_cols] of each row's valid entries."""
    col = torch.arange(num_cols, dtype=torch.int32,
                       device=row_lengths.device)[None, :]
    return col < row_lengths[:, None]


def reduce_subarrays_sum(values, row_splits):
    """The sum of each row of ragged ``values``; padding is dropped."""
    seg = row_splits_to_segment_ids(row_splits, values.shape[0])
    return segment_sum(values, seg, row_splits.shape[0] - 1)


def _kept(values, segment_ids, num_segments):
    """The rows of ``values`` whose id lies in [0, num_segments), and
    those ids as int64."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    return values[keep], ids[keep]


def segment_sum(values, segment_ids, num_segments):
    values, ids = _kept(values, segment_ids, num_segments)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids, values)


def segment_mean(values, segment_ids, num_segments):
    s = segment_sum(values, segment_ids, num_segments)
    ones = torch.ones((values.shape[0],) + (1,) * (values.ndim - 1),
                      dtype=values.dtype, device=values.device)
    n = segment_sum(ones, segment_ids, num_segments)
    return s / torch.clamp(n, min=1)


def segment_max(values, segment_ids, num_segments, initial=None):
    values, ids = _kept(values, segment_ids, num_segments)
    lowest = (-torch.inf if values.dtype.is_floating_point else
              torch.iinfo(values.dtype).min)
    out = torch.full((num_segments,) + tuple(values.shape[1:]), lowest,
                     dtype=values.dtype, device=values.device)
    index = ids.reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    return out.scatter_reduce_(0, index, values, "amax", include_self=False)


def masked_max(values, mask, axis, initial=-torch.inf):
    """Max over ``axis`` of the entries where ``mask`` is True;
    ``initial`` where none is."""
    fill = torch.tensor(initial, dtype=values.dtype, device=values.device)
    return torch.amax(torch.where(mask, values, fill), dim=axis)


def masked_mean(values, mask, axis):
    mask_f = mask.to(values.dtype)
    s = torch.sum(values * mask_f, dim=axis)
    n = torch.clamp(torch.sum(mask_f, dim=axis), min=1)
    return s / n
