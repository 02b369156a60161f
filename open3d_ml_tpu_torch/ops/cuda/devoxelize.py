"""Trilinear devoxelisation: the CUDA kernels (a plan, the forward and the
grid backward), their plain versions and the wrappers that PVCNN's voxel
branch calls.

The wrappers take the plain versions for tensors on the CPU and launch
the kernels of ``csrc/trilinear_devoxelize.cu`` for tensors on a CUDA
device; they have no other route. ``LAUNCHES`` counts the launches:
``trilinear_devoxelize`` one a forward, ``trilinear_devoxelize_bwd`` one
a backward, ``trilinear_devoxelize_plan`` one a plan built (its memset
and five kernels).

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

The kernels read the points cell by cell through a ``DevoxelizePlan``
(``devoxelize_plan``): each point's lo cell, the points sorted by it
(stable), the CSR offsets of the B r^3 cells and each sorted point's 8
corner weights, built once per coordinates and resolution and shared by
the blocks that read them (in PVCNN the three r = 32 blocks). The
wrappers take the plan as an argument; on the CPU ``devoxelize_plan``
gives None, since the plain versions read the coordinates, and
``devoxelize_plan_plain`` builds the same plan for the tests. The
forward walks the points in plan order, where neighbours share corner
rows. The backward is owner-computes: each cell sums, corner by corner
in ``CORNERS`` order, the products g * w of the points of lo cell
(cell - corner) in ascending point index, from +0, and writes its row
once: no atomics, no zero fill. That is the order in which
``devoxelize_grad_plain``'s per-corner ``index_add_`` sums on the CPU
(each row's sources in ascending index), so the backward equals the
plain version run on the CPU bit for bit, on any input, in every run.
Bound: device memory (the grid rows some point reads, or the whole
dgrid written, and the [B, N, C] side); ``csrc/trilinear_devoxelize.cu``
says how far each kernel stands from it and why.
"""

from typing import NamedTuple

import torch

from ._launch import check, raise_on, route, stream

LAUNCHES = {"trilinear_devoxelize": 0, "trilinear_devoxelize_bwd": 0,
            "trilinear_devoxelize_plan": 0}

# the corners (dx, dy, dz) in the order of the sum
CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                for dz in (0, 1))
SCAN_CHUNK = 4096  # cells a block of the plan's scan sums


class DevoxelizePlan(NamedTuple):
    """The points of ``coords`` [B, N, 3] cell by cell on an r^3 grid:
    ``cell`` [B N] the flat lo cell b r^3 + (x r + y) r + z of each point,
    ``perm`` [B N] the flat point indices sorted by lo cell (ascending
    within a cell), ``offsets`` [B r^3 + 1] the CSR offsets of the cells
    into ``perm``, all int32; ``weights`` [B N, 8] the corner weights of
    point ``perm[j]`` in ``CORNERS`` order at row j, of the coordinates'
    type."""
    coords: torch.Tensor
    r: int
    cell: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor


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


def devoxelize_plan_plain(coords, r):
    """``DevoxelizePlan`` of coords [B, N, 3] on an r^3 grid by a stable
    sort, a count (``index_add_``, which unlike ``bincount`` needs no
    host sync on a card), ``cumsum`` and ``corner_weights``."""
    b = coords.shape[0]
    corners = corner_weights(coords, r)
    cell = corners[0][0].reshape(-1)  # corner 000 is the lo cell
    counts = cell.new_zeros(b * r**3 + 1).index_add_(
        0, cell + 1, torch.ones_like(cell))
    perm = torch.sort(cell, stable=True).indices
    weights = torch.stack([w for _, w in corners], -1).reshape(-1, 8)
    return DevoxelizePlan(coords, r, cell.int(), perm.int(),
                          torch.cumsum(counts, 0).int(), weights[perm])


def devoxelize_plan(coords, r):
    """The plan the kernels read, of coords [B, N, 3] (contiguous, float32,
    no gradient) on an r^3 grid, r >= 2: on a CUDA device built by the
    plan kernels, the same bits as ``devoxelize_plan_plain``'s; None for
    coordinates on the CPU, whose plain versions read the coordinates."""
    dev = coords.device
    check(coords, "coords", torch.float32 if coords.is_cuda else coords.dtype,
          3, dev)
    if coords.shape[2] != 3 or r < 2 or coords.requires_grad:
        raise ValueError(f"devoxelize_plan takes coords [B, N, 3] that need "
                         f"no gradient and r >= 2: {tuple(coords.shape)}, "
                         f"r {r}, requires_grad {coords.requires_grad}")
    if route(coords, "trilinear_devoxelize") == "plain":
        return None
    from ._build import library
    b, n = coords.shape[:2]
    m = b * r**3

    def ints(size):
        return torch.empty(size, dtype=torch.int32, device=dev)

    cell, perm, offsets = ints(b * n), ints(b * n), ints(m + 1)
    weights = torch.empty((b * n, 8), dtype=torch.float32, device=dev)
    # the scratch lives until the launch is queued: a tensor freed before
    # it would hand its block to the next one allocated
    scratch = ints(m), ints(b * n), ints(-(-m // SCAN_CHUNK))
    err = library().trilinear_devoxelize_plan_launch(
        coords.data_ptr(), cell.data_ptr(), perm.data_ptr(),
        offsets.data_ptr(), weights.data_ptr(),
        *(t.data_ptr() for t in scratch), b, n, r, stream())
    raise_on(err, "trilinear_devoxelize_plan")
    LAUNCHES["trilinear_devoxelize_plan"] += 1
    return DevoxelizePlan(coords, r, cell, perm, offsets, weights)


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


def _check_plan(plan, coords, r):
    """Raise unless ``plan`` was made for ``coords`` (the same shape and
    memory) on an r^3 grid, its tensors of its shapes and types on the
    coordinates' device."""
    b, n = coords.shape[:2]
    if plan is None:
        raise ValueError(f"the devoxelisation kernels read a plan: got none "
                         f"for coordinates {tuple(coords.shape)} at r {r} "
                         f"(devoxelize_plan builds one)")
    shapes = ((plan.cell, (b * n,), torch.int32),
              (plan.perm, (b * n,), torch.int32),
              (plan.offsets, (b * r**3 + 1,), torch.int32),
              (plan.weights, (b * n, 8), coords.dtype))
    if (plan.r != r or plan.coords.shape != coords.shape or
            plan.coords.data_ptr() != coords.data_ptr() or any(
                t.dtype != dtype or t.shape != shape or
                t.device != coords.device or not t.is_contiguous()
                for t, shape, dtype in shapes)):
        raise ValueError(f"the devoxelisation plan is not one of these "
                         f"coordinates {tuple(coords.shape)} at r {r}: it "
                         f"has coords {tuple(plan.coords.shape)}, r "
                         f"{plan.r}, perm {tuple(plan.perm.shape)}, offsets "
                         f"{tuple(plan.offsets.shape)}")


def _units(*tensors):
    """Raise unless the kernels can read ``tensors`` in float4 units: C a
    multiple of 4 and every tensor 16-byte aligned."""
    for t in tensors:
        if t.shape[-1] % 4 or t.data_ptr() % 16:
            raise ValueError(f"the trilinear_devoxelize kernels take C a "
                             f"multiple of 4 and 16-byte aligned tensors: C "
                             f"{t.shape[-1]}, address {t.data_ptr():#x}")


def _forward(grid, plan):
    """Launch the forward kernel on a grid and plan that ``_check`` and
    ``_check_plan`` took."""
    from ._build import library
    b, r, c, n = (grid.shape[0], grid.shape[1], grid.shape[4],
                  plan.coords.shape[1])
    out = torch.empty((b, n, c), dtype=torch.float32, device=grid.device)
    _units(grid, out)
    err = library().trilinear_devoxelize_launch(
        grid.data_ptr(), plan.coords.data_ptr(), plan.perm.data_ptr(),
        plan.cell.data_ptr(), out.data_ptr(), b, n, r, c, stream())
    raise_on(err, "trilinear_devoxelize")
    LAUNCHES["trilinear_devoxelize"] += 1
    return out


def devoxelize_grad(g, coords, r, plan):
    """``devoxelize_grad_plain``'s contract, checked for both routes; on a
    CUDA device it launches the backward kernel through ``plan``
    (``devoxelize_plan(coords, r)``), which writes every row of dgrid and
    takes C a multiple of 4 and 16-byte aligned tensors (``_units``). The
    CPU takes the plain version, which reads no plan."""
    check(g, "g", torch.float32 if g.is_cuda else g.dtype, 3, g.device)
    check(coords, "coords", g.dtype, 3, g.device)
    b, n, c = g.shape
    if tuple(coords.shape) != (b, n, 3) or r < 2:
        raise ValueError(f"g [B, N, C] {tuple(g.shape)}, coords "
                         f"{tuple(coords.shape)}, r {r}")
    if route(g, "trilinear_devoxelize") == "plain":
        return devoxelize_grad_plain(g, coords, r)
    _check_plan(plan, coords, r)
    _units(g)
    from ._build import library
    dgrid = torch.empty((b, r, r, r, c), dtype=torch.float32,
                        device=g.device)
    err = library().trilinear_devoxelize_bwd_launch(
        g.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
        plan.weights.data_ptr(), dgrid.data_ptr(), b, r, c, stream())
    raise_on(err, "trilinear_devoxelize_bwd")
    LAUNCHES["trilinear_devoxelize_bwd"] += 1
    return dgrid


class TrilinearDevoxelize(torch.autograd.Function):
    """The kernel pair under autograd: ``TrilinearDevoxelize.apply(grid,
    plan)``; the backward returns the grid's gradient only, through the
    plan the forward read."""

    @staticmethod
    def forward(ctx, grid, plan):
        ctx.plan = plan
        return _forward(grid, plan)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        return (devoxelize_grad(g.contiguous(), plan.coords, plan.r, plan),
                None)


def trilinear_devoxelize(grid, coords, plan):
    """``devoxelize_plain``'s contract on a channels-last grid, checked for
    both routes (``_check``). The CPU takes the plain version, which reads
    no plan (``devoxelize_plan`` gives None there); on a CUDA device it
    launches the forward kernel through ``plan``, which must be
    ``devoxelize_plan(coords, r)`` (``_check_plan``), under
    ``TrilinearDevoxelize`` where the grid needs a gradient, and raises
    unless C is a multiple of 4 and the tensors are 16-byte aligned
    (``_units``: the kernels read float4 units)."""
    r = _check(grid, coords)[2]
    if route(grid, "trilinear_devoxelize") == "plain":
        return devoxelize_plain(grid, coords)
    _check_plan(plan, coords, r)
    _units(grid)
    if grid.requires_grad and torch.is_grad_enabled():
        return TrilinearDevoxelize.apply(grid, plan)
    return _forward(grid, plan)
