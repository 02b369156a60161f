"""Trilinear devoxelisation: the CUDA kernel pair, their plain versions and
the wrappers that PVCNN's voxel branch calls.

The wrappers take the plain versions for tensors on the CPU and launch
the kernels of ``csrc/trilinear_devoxelize.cu`` for tensors on a CUDA
device; they have no other route. ``LAUNCHES`` counts the kernel
launches: ``trilinear_devoxelize`` one a forward,
``trilinear_devoxelize_bwd`` one a backward.

The contract is the JAX package's ``trilinear_devoxelize``
(``open3d_ml_tpu/ops/interpolation.py``) on a batch, with the grid
channels-last: grid [B, r, r, r, C] (``grid[b, x, y, z]`` the cell of
voxel (x, y, z); flax's NDHWC, and a ``Conv3d`` output in
``torch.channels_last_3d`` viewed through ``permute(0, 2, 3, 4, 1)``),
coords [B, N, 3] in voxel units -> [B, N, C]. Each coordinate is clipped
to [0, r - 1], lo = clamp(floor(c), 0, r - 2), f = c - lo, and the 8
corners are summed in the order dx, dy, dz = 000, 001, 010, ..., 111 as
out = out + vals * w from 0, with w = (wx * wy) * wz and wx = f or 1 - f.
The plain version writes each product and sum as its own elementwise op
and the kernel computes the same with explicit round-to-nearest
intrinsics, so the forwards agree bit for bit. The gradient goes to the
grid only: the coordinates carry none (PVCNN stops it before the op, as
the JAX net does), and a call whose coordinates require one raises.
"""

import torch

from ._launch import check, raise_on, route, stream

LAUNCHES = {"trilinear_devoxelize": 0, "trilinear_devoxelize_bwd": 0}

# the corners (dx, dy, dz) in the order of the sum
CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                for dz in (0, 1))


def corner_weights(coords, r):
    """(flat cell rows [B, N] with b * r^3 added, weights [B, N]) of each
    corner in ``CORNERS`` order, for coords [B, N, 3] in voxel units of an
    r^3 grid."""
    c = torch.clamp(coords, 0.0, float(r - 1))
    lo = torch.clamp(torch.floor(c).long(), max=r - 2).clamp(min=0)
    frac = c - lo.to(c.dtype)
    base = torch.arange(coords.shape[0], device=coords.device)[:, None] * r**3
    out = []
    for corner in CORNERS:
        idx = [lo[..., k] + corner[k] for k in range(3)]
        w = [frac[..., k] if corner[k] else 1.0 - frac[..., k]
             for k in range(3)]
        out.append((base + (idx[0] * r + idx[1]) * r + idx[2],
                    (w[0] * w[1]) * w[2]))
    return out


def devoxelize_plain(grid, coords):
    """grid [B, r, r, r, C] (any strides), coords [B, N, 3] -> [B, N, C],
    differentiable in both by autograd."""
    b, r, c = grid.shape[0], grid.shape[1], grid.shape[-1]
    flat = grid.reshape(b * r**3, c)
    out = torch.zeros((*coords.shape[:2], c), dtype=grid.dtype,
                      device=grid.device)
    for rows, w in corner_weights(coords, r):
        out = out + flat[rows] * w[..., None]
    return out


def devoxelize_grad_plain(g, coords, r):
    """The grid's gradient: g [B, N, C], coords [B, N, 3] -> dgrid
    [B, r, r, r, C], each g[b, n] * w added into the 8 cells it read
    (``index_add_``, in ``CORNERS`` order)."""
    b, c = g.shape[0], g.shape[-1]
    dgrid = torch.zeros((b * r**3, c), dtype=g.dtype, device=g.device)
    for rows, w in corner_weights(coords, r):
        dgrid.index_add_(0, rows.reshape(-1),
                         (g * w[..., None]).reshape(-1, c))
    return dgrid.reshape(b, r, r, r, c)


def _check(grid, coords):
    """Raise unless grid is a [B, r, r, r, C] channels-last grid (its dense
    memory order, r >= 2) and coords a contiguous [B, N, 3] tensor of the
    same type and device that needs no gradient: float32 (float64 too on
    the CPU, for the plain version); returns (B, N, r, C)."""
    dev = grid.device
    types = ((torch.float32,) if dev.type == "cuda" else
             (torch.float32, torch.float64))
    if grid.dtype not in types or grid.dim() != 5:
        raise ValueError(f"grid: expected a 5-d tensor [B, r, r, r, C] of "
                         f"{types}, got {grid.dim()}-d {grid.dtype}")
    b, r, ry, rz, c = grid.shape
    if not r == ry == rz or r < 2:
        raise ValueError(f"grid [B, r, r, r, C] with r >= 2: got "
                         f"{tuple(grid.shape)}")
    if not grid.is_contiguous():
        raise ValueError(f"grid must be channels-last [B, r, r, r, C] in "
                         f"memory (a channels_last_3d Conv3d output, "
                         f"permuted): strides {grid.stride()}")
    check(coords, "coords", grid.dtype, 3, dev)
    if coords.shape[0] != b or coords.shape[2] != 3:
        raise ValueError(f"coords [B, N, 3] with B = {b}: got "
                         f"{tuple(coords.shape)}")
    if coords.requires_grad:
        raise ValueError("trilinear_devoxelize takes no gradient to the "
                         "coordinates: detach them")
    return b, coords.shape[1], r, c


def _units(*tensors):
    """Raise unless the kernels can read ``tensors`` in float4 units: C a
    multiple of 4 and every tensor 16-byte aligned."""
    for t in tensors:
        if t.shape[-1] % 4 or t.data_ptr() % 16:
            raise ValueError(f"the trilinear_devoxelize kernels take C a "
                             f"multiple of 4 and 16-byte aligned tensors: C "
                             f"{t.shape[-1]}, address {t.data_ptr():#x}")


def _forward(grid, coords):
    """Launch the forward kernel on a grid and coordinates ``_check``
    took."""
    from ._build import library
    b, r, c, n = grid.shape[0], grid.shape[1], grid.shape[4], coords.shape[1]
    out = torch.empty((b, n, c), dtype=torch.float32, device=grid.device)
    _units(grid, out)
    err = library().trilinear_devoxelize_launch(
        grid.data_ptr(), coords.data_ptr(), out.data_ptr(), b, n, r, c,
        stream())
    raise_on(err, "trilinear_devoxelize")
    LAUNCHES["trilinear_devoxelize"] += 1
    return out


def devoxelize_grad(g, coords, r):
    """``devoxelize_grad_plain``'s contract, checked for both routes; on a
    CUDA device it zeroes dgrid and launches the backward kernel, which
    takes C a multiple of 4 and 16-byte aligned tensors (``_units``)."""
    check(g, "g", torch.float32 if g.is_cuda else g.dtype, 3, g.device)
    check(coords, "coords", g.dtype, 3, g.device)
    b, n, c = g.shape
    if tuple(coords.shape) != (b, n, 3) or r < 2:
        raise ValueError(f"g [B, N, C] {tuple(g.shape)}, coords "
                         f"{tuple(coords.shape)}, r {r}")
    if route(g, "trilinear_devoxelize") == "plain":
        return devoxelize_grad_plain(g, coords, r)
    from ._build import library
    dgrid = torch.zeros((b, r, r, r, c), dtype=torch.float32,
                        device=g.device)
    _units(g, dgrid)
    err = library().trilinear_devoxelize_bwd_launch(
        g.data_ptr(), coords.data_ptr(), dgrid.data_ptr(), b, n, r, c,
        stream())
    raise_on(err, "trilinear_devoxelize_bwd")
    LAUNCHES["trilinear_devoxelize_bwd"] += 1
    return dgrid


class TrilinearDevoxelize(torch.autograd.Function):
    """The kernel pair under autograd: ``TrilinearDevoxelize.apply(grid,
    coords)``; the backward returns the grid's gradient only."""

    @staticmethod
    def forward(ctx, grid, coords):
        ctx.save_for_backward(coords)
        ctx.r = grid.shape[1]
        return _forward(grid, coords)

    @staticmethod
    def backward(ctx, g):
        (coords,) = ctx.saved_tensors
        return devoxelize_grad(g.contiguous(), coords, ctx.r), None


def trilinear_devoxelize(grid, coords):
    """``devoxelize_plain``'s contract on a channels-last grid, checked for
    both routes (``_check``); on a CUDA device it launches the forward
    kernel, under ``TrilinearDevoxelize`` where the grid needs a
    gradient, and raises unless C is a multiple of 4 and the tensors are
    16-byte aligned (``_units``: the kernels read float4 units)."""
    _check(grid, coords)
    if route(grid, "trilinear_devoxelize") == "plain":
        return devoxelize_plain(grid, coords)
    if grid.requires_grad and torch.is_grad_enabled():
        return TrilinearDevoxelize.apply(grid, coords)
    return _forward(grid, coords)
