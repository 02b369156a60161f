"""Voxelization on the device: quantise, sort by voxel key, cut the runs.

Counterpart of ``open3d_ml_tpu/ops/voxelize.py`` ``VoxelData`` and
``voxelize``: the points of one cloud are hashed to voxels and grouped per
voxel, with the caps ``max_voxels`` and ``max_points_per_voxel``. Outputs
are dense and padded, with masks. Voxels come in ascending key order and
the first ``max_voxels`` are kept; within a voxel the points keep their
input order (a stable sort) and the first ``max_points_per_voxel`` are
kept. Where the JAX package scatters with ``mode="drop"``, the port
scatters into a buffer with one dump row (or column) more and slices it
off.
"""

from typing import NamedTuple

import numpy as np
import torch

_I32MAX = torch.iinfo(torch.int32).max


class VoxelData(NamedTuple):
    """Dense padded voxelization of one cloud.

    coords: [max_voxels, 3] int32 voxel coordinates (x, y, z); pad rows 0.
    point_indices: [max_voxels, max_points] int32 indices into the input
        points; pad entries 0 (mask with ``point_mask``).
    point_mask: [max_voxels, max_points] bool.
    num_points_per_voxel: [max_voxels] int32 (capped at max_points).
    voxel_mask: [max_voxels] bool, True for real voxels.
    num_voxels: [] int32.
    point_to_voxel: [N] int32 voxel slot of each input point in input
        order; ``max_voxels`` for a dropped point (out of range, or beyond
        either cap).
    """
    coords: torch.Tensor
    point_indices: torch.Tensor
    point_mask: torch.Tensor
    num_points_per_voxel: torch.Tensor
    voxel_mask: torch.Tensor
    num_voxels: torch.Tensor
    point_to_voxel: torch.Tensor


def voxelize(points, voxel_size, points_range_min, points_range_max,
             max_voxels, max_points_per_voxel, *, points_mask=None):
    """Voxelize one cloud.

    points [N, 3] float32; voxel_size and the range bounds are (3,)
    numbers; points outside [min, max) are dropped, as are points whose
    ``points_mask`` entry is False. Returns ``VoxelData``.
    """
    dev = points.device
    n = points.shape[0]
    vsize_np = np.asarray(voxel_size, np.float64)
    rmin_np = np.asarray(points_range_min, np.float64)
    rmax_np = np.asarray(points_range_max, np.float64)
    grid_np = np.maximum(
        np.floor((rmax_np - rmin_np) / vsize_np + 0.5).astype(np.int64), 1)
    if int(np.prod(grid_np)) >= 2**31 - 1:
        raise ValueError(f"grid {grid_np.tolist()} does not fit int32 keys")

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    rmin, rmax = f32(rmin_np), f32(rmax_np)
    grid = torch.tensor(grid_np, dtype=torch.int32, device=dev)
    coords = torch.floor((points - rmin) / f32(vsize_np)).to(torch.int32)
    in_range = ((coords >= 0) & (coords < grid)).all(1)
    in_range &= (points >= rmin).all(1) & (points < rmax).all(1)
    if points_mask is not None:
        in_range &= points_mask

    key = (coords[:, 2] * grid[1] + coords[:, 1]) * grid[0] + coords[:, 0]
    key = torch.where(in_range, key, _I32MAX)
    order = torch.sort(key, stable=True).indices
    skey = key[order]
    svalid = skey != _I32MAX

    # runs of equal keys along the sorted order
    prev = torch.cat([skey.new_full((1,), -1), skey[:-1]])
    new_run = (skey != prev) & svalid
    voxel_rank = torch.cumsum(new_run.to(torch.int32), 0,
                              dtype=torch.int32) - 1
    num_voxels_total = (new_run.sum().to(torch.int32) if n else
                        torch.zeros((), dtype=torch.int32, device=dev))

    # column of each point inside its voxel: its distance from the run's
    # first position (the segment minimum; row max_voxels is the dump of
    # every rank at or past the cap)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    rank_c = torch.where(svalid, voxel_rank, max_voxels).long()
    starts = torch.full((max_voxels + 1,), n, dtype=torch.int32, device=dev)
    starts.scatter_reduce_(0, rank_c.clamp(max=max_voxels),
                           torch.where(svalid, pos, n), "amin")
    col = pos - starts[:max_voxels][rank_c.clamp(0, max_voxels - 1)]

    keep = svalid & (rank_c < max_voxels) & (col < max_points_per_voxel)
    rank_s = torch.where(keep, rank_c, max_voxels)
    col_s = torch.where(keep, col.long(), max_points_per_voxel)

    shape = (max_voxels + 1, max_points_per_voxel + 1)
    point_indices = torch.zeros(shape, dtype=torch.int32, device=dev)
    point_indices[rank_s, col_s] = order.to(torch.int32)
    point_mask = torch.zeros(shape, dtype=torch.bool, device=dev)
    point_mask[rank_s, col_s] = True
    point_indices = point_indices[:max_voxels, :max_points_per_voxel]
    point_mask = point_mask[:max_voxels, :max_points_per_voxel]

    counts = point_mask.sum(1).to(torch.int32)
    num_voxels = torch.clamp(num_voxels_total, max=max_voxels)
    voxel_mask = torch.arange(max_voxels, device=dev) < num_voxels

    # every point of a run has the same coordinates, so the duplicate
    # targets of this scatter write identical values and the order in
    # which a CUDA index_put_ applies them does not matter
    vox_coords = torch.zeros((max_voxels + 1, 3), dtype=torch.int32,
                             device=dev)
    vox_coords[rank_s] = coords[order]
    vox_coords = vox_coords[:max_voxels]

    # order is a permutation: each point's slot is written once
    point_to_voxel = torch.empty((n,), dtype=torch.int32, device=dev)
    point_to_voxel[order] = rank_s.to(torch.int32)

    return VoxelData(vox_coords, point_indices, point_mask, counts,
                     voxel_mask, num_voxels, point_to_voxel)
