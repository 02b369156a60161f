"""The port's PVCNN (``open3d_ml_tpu_torch``) against the JAX package: the
trilinear devoxelisation, the voxelisation, the modules, the net in eval
mode, the converters, the host side and the configuration.

Inputs are made with numpy from a seed and go through both packages. The
JAX net runs one sample at a time under ``nn.vmap`` with BatchNorm over
the batch axis; the port's net takes the batch at once. The modules and
the net run on weights the JAX modules initialise (BN statistics drawn
with numpy so that BN is not the identity), carried into the port with
``load_jax_variables``, at a small config: width multiplier 0.125 and
voxel resolution multiplier 0.25 (grids of 8^3 and 4^3), B = 2, N = 512.
Float32 outputs within 1e-5 relative L2 (``TOL``). The devoxelisation
kernels run only on a card (``chip_smoke.py``); here their wrappers are
driven through a stand-in library.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from open3d_ml_tpu.datasets.augment import SemsegAugmentation as JaxAugment
from open3d_ml_tpu.models import pvcnn as jpv
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxLoss
from open3d_ml_tpu.ops import interpolation as jint
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu.utils.convert_torch import (
    convert_pvcnn as jax_convert_pvcnn)
from open3d_ml_tpu_torch import MODEL
from open3d_ml_tpu_torch.models import PVCNN
from open3d_ml_tpu_torch.models import pvcnn as tpv
from open3d_ml_tpu_torch.models.common import BatchNorm
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.ops import interpolation as tint
from open3d_ml_tpu_torch.ops.cuda import devoxelize as cdv
from open3d_ml_tpu_torch.utils import load_jax_variables, state_dict_to_jax
from open3d_ml_tpu_torch.utils.convert_jax import jax_to_state_dict
from open3d_ml_tpu_torch.utils.convert_torch import convert_pvcnn
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PV_YML = REPO / "open3d_ml_tpu_torch/configs/pvcnn_s3dis.yml"
TOL = 1e-5  # float32 relative L2
B, N = 2, 512
SMALL = dict(num_points=N, width_multiplier=0.125,
             voxel_resolution_multiplier=0.25)
# an augmentation list for the host-side tests (the shipped YAML has none)
AUGMENT = Config.load_from_file(
    REPO / "open3d_ml_tpu/configs/pointtransformer_s3dis.yml").model.augment


def shape_variables(module, *args, seed=0, **kwargs):
    """Flax variables of ``module`` on the shapes ``jax.eval_shape`` gives
    its init (nothing compiles), drawn with numpy: kernels N(0, 1 /
    fan-in), biases N(0, 0.1), BN means N(0, 0.2), scales and variances
    U(0.5, 1.5)."""
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda *a: module.init(key, *a, **kwargs), *args)
    rng = np.random.default_rng(seed)

    def draw(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = draw(x)
                continue
            if k == "kernel":
                v = rng.standard_normal(x.shape) / np.sqrt(
                    np.prod(x.shape[:-1]))
            elif k in ("bias", "mean"):
                v = rng.normal(0.0, 0.1 if k == "bias" else 0.2, x.shape)
            else:  # scale, var
                v = rng.uniform(0.5, 1.5, x.shape)
            out[k] = v.astype(np.float32)
        return out

    return {c: draw(v) for c, v in dict(shapes).items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _cloud(seed, b=B, n=N, c=9):
    """(points [b, n, 3] uniform in a 3 x 2 x 1.5 m box, features [b, n,
    c]) as float32 numpy."""
    rng = np.random.default_rng(seed)
    pts = (rng.uniform(0, 1, (b, n, 3)) * [3.0, 2.0, 1.5]).astype(
        np.float32)
    return pts, rng.normal(0, 1, (b, n, c)).astype(np.float32)


# ----------------------------------------------------------- devoxelisation

def _devox_inputs(seed, r, c=5, b=B, n=300):
    """A grid [b, c, r, r, r], coords [b, 3, n] over [-0.5, r - 0.5] (some
    clipped, some exactly r - 1) and a cotangent [b, c, n]."""
    rng = np.random.default_rng(seed)
    grid = rng.normal(0, 1, (b, c, r, r, r)).astype(np.float32)
    coords = rng.uniform(-0.5, r - 0.5, (b, 3, n)).astype(np.float32)
    coords[:, :, ::17] = r - 1
    g = rng.normal(0, 1, (b, c, n)).astype(np.float32)
    return grid, coords, g


@pytest.mark.parametrize("r", [2, 4, 8])
def test_trilinear_devoxelize_and_grid_vjp_equal_jax(r):
    """The forward and the grid's VJP against ``jax.vjp`` of the JAX op,
    sample by sample, within 1e-6 relative L2: the JAX-layout plain
    version, the path's channels-last ``devoxelize`` (with its autograd
    gradient) and the explicit plain backward."""
    grid, coords, g = _devox_inputs(r, r)
    got = tint.trilinear_devoxelize(torch.from_numpy(grid),
                                    torch.from_numpy(coords), r).numpy()
    cl = torch.from_numpy(np.ascontiguousarray(
        grid.transpose(0, 2, 3, 4, 1))).requires_grad_(True)
    ct = torch.from_numpy(np.ascontiguousarray(coords.transpose(0, 2, 1)))
    path = cdv.trilinear_devoxelize(cl, ct, cdv.devoxelize_plan(ct, r))
    path.backward(torch.from_numpy(np.ascontiguousarray(
        g.transpose(0, 2, 1))))
    explicit = cdv.devoxelize_grad_plain(
        torch.from_numpy(np.ascontiguousarray(g.transpose(0, 2, 1))), ct, r)
    for b in range(B):
        want, vjp = jax.vjp(lambda v: jint.trilinear_devoxelize(
            v, jnp.asarray(coords[b]), r), jnp.asarray(grid[b]))
        (dgrid,) = vjp(jnp.asarray(g[b]))
        want, dgrid = np.asarray(want), np.asarray(dgrid).transpose(1, 2, 3, 0)
        assert _rel(got[b], want) <= 1e-6
        assert _rel(path[b].detach().numpy().T, want) <= 1e-6
        assert _rel(cl.grad[b].numpy(), dgrid) <= 1e-6
        assert _rel(explicit[b].numpy(), dgrid) <= 1e-6
    single = tint.trilinear_devoxelize(torch.from_numpy(grid[0]),
                                       torch.from_numpy(coords[0]), r)
    np.testing.assert_array_equal(single.numpy(), got[0])


def test_devoxelize_plain_backward_bit_equal_on_dyadic_inputs():
    """On coordinates of the 1/8 lattice and small-integer cotangents
    every product and sum is exact: the explicit plain backward equals
    autograd's gradient of the plain forward bit for bit, as the kernel's
    atomic sums must on the card."""
    rng = np.random.default_rng(3)
    r, c = 8, 12
    coords = torch.from_numpy(
        rng.integers(0, 8 * (r - 1) + 1, (B, 700, 3)).astype(np.float32) / 8)
    g = torch.from_numpy(rng.integers(-4, 5, (B, 700, c)).astype(np.float32))
    grid = torch.zeros((B, r, r, r, c), requires_grad=True)
    cdv.devoxelize_plain(grid, coords).backward(g)
    np.testing.assert_array_equal(
        cdv.devoxelize_grad_plain(g, coords, r).numpy(), grid.grad.numpy())


def test_trilinear_voxelize_coords_equals_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tint.trilinear_voxelize_coords(torch.from_numpy(pts), 16).numpy(),
        np.asarray(jint.trilinear_voxelize_coords(jnp.asarray(pts), 16)))


def test_devoxelize_refuses_what_the_kernel_does_not_take():
    """Both routes raise on a grid that is not channels-last in memory
    (never a silent copy), on coordinates that need a gradient, on r < 2
    and on mismatched shapes; the card takes float32 only."""
    grid = torch.zeros((2, 4, 4, 4, 8))
    coords = torch.zeros((2, 10, 3))
    with pytest.raises(ValueError, match="channels-last"):
        cdv.trilinear_devoxelize(
            torch.zeros((2, 8, 4, 4, 4)).permute(0, 2, 3, 4, 1), coords,
            None)
    with pytest.raises(ValueError, match="no gradient to the coordinates"):
        cdv.trilinear_devoxelize(grid, coords.clone().requires_grad_(True),
                                 None)
    with pytest.raises(ValueError, match="r >= 2"):
        cdv.trilinear_devoxelize(torch.zeros((2, 1, 1, 1, 8)), coords, None)
    with pytest.raises(ValueError, match="B = 2"):
        cdv.trilinear_devoxelize(grid, torch.zeros((3, 10, 3)), None)
    with pytest.raises(ValueError, match="r >= 2"):
        cdv.trilinear_devoxelize(torch.zeros((2, 4, 4, 5, 8)), coords, None)
    with pytest.raises(ValueError, match="no trilinear_devoxelize kernel"):
        cdv.trilinear_devoxelize(grid.to("meta"), coords.to("meta"), None)


def _stand_in(monkeypatch):
    """The kernel route on CPU tensors through a stand-in library that
    records each launch's arguments."""
    from open3d_ml_tpu_torch.ops.cuda import _build
    calls = []

    class Library:
        def trilinear_devoxelize_plan_launch(self, *args):
            calls.append(("plan",) + args)
            return 0

        def trilinear_devoxelize_launch(self, *args):
            calls.append(("fwd",) + args)
            return 0

        def trilinear_devoxelize_bwd_launch(self, *args):
            calls.append(("bwd",) + args)
            return 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(cdv, "route", lambda t, family: "kernel")
    monkeypatch.setattr(cdv, "stream", lambda: 0)
    monkeypatch.setattr(cdv, "LAUNCHES", {"trilinear_devoxelize": 0,
                                          "trilinear_devoxelize_bwd": 0,
                                          "trilinear_devoxelize_plan": 0})
    return calls


def test_devoxelize_kernel_route_through_a_stand_in_library(monkeypatch):
    """On the kernel route ``devoxelize_plan`` launches once (coords,
    cell, perm, offsets, weights, three int32 scratch tensors of B r^3, B
    N and the scan's blocks, B, N, r, stream); the forward launches once
    through it with (grid, coords, perm, cell, out, B, N, r, C, stream)
    and [B, N, C] allocated; a grid that needs a gradient goes through
    ``TrilinearDevoxelize``, whose backward launches the backward kernel
    once through the forward's plan (g, perm, offsets, weights, dgrid, B,
    r, C, stream), with no zero fill. No plan, a plan of other coordinates
    or another resolution, C not a multiple of 4, or a tensor not 16-byte
    aligned raises before any launch (the kernels read float4 units);
    a failed launch raises."""
    calls = _stand_in(monkeypatch)
    grid = torch.zeros((2, 8, 8, 8, 16), requires_grad=True)
    coords = torch.zeros((2, 100, 3))
    out = cdv.trilinear_devoxelize(grid, coords,
                                   cdv.devoxelize_plan(coords, 8))
    assert out.shape == (2, 100, 16) and out.grad_fn is not None
    plan, fwd = calls[0], calls[1]
    assert plan[0] == "plan" and plan[1] == coords.data_ptr()
    assert plan[9:] == (2, 100, 8, 0)
    assert fwd[0] == "fwd" and fwd[1:3] == (grid.data_ptr(),
                                            coords.data_ptr())
    assert fwd[3:5] == (plan[3], plan[2])  # the plan's perm and cells
    assert fwd[6:] == (2, 100, 8, 16, 0)
    out.backward(torch.ones_like(out))
    bwd = calls[2]
    assert grid.grad.shape == grid.shape and bwd[0] == "bwd"
    assert bwd[2:5] == plan[3:6]
    assert bwd[6:] == (2, 8, 16, 0)
    small = torch.zeros((1, 7, 3))
    other = cdv.devoxelize_plan(small, 4)
    with torch.no_grad():
        cdv.trilinear_devoxelize(torch.zeros((1, 4, 4, 4, 8)), small, other)
    assert calls[3][0] == "plan" and calls[3][9:] == (1, 7, 4, 0)
    assert calls[4][0] == "fwd" and calls[4][6:] == (1, 7, 4, 8, 0)
    with pytest.raises(ValueError, match="multiple of 4"):
        cdv.trilinear_devoxelize(torch.zeros((1, 4, 4, 4, 6)), small, other)
    with pytest.raises(ValueError, match="multiple of 4"):
        cdv.devoxelize_grad(torch.zeros((1, 7, 6)), small, 4, other)
    shifted = torch.zeros(4 * 4 * 4 * 8 + 1)[1:].view(1, 4, 4, 4, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cdv.trilinear_devoxelize(shifted, small, other)
    with pytest.raises(ValueError, match="read a plan: got none"):
        cdv.trilinear_devoxelize(torch.zeros((1, 4, 4, 4, 8)), small, None)
    with pytest.raises(ValueError, match="read a plan: got none"):
        cdv.devoxelize_grad(torch.zeros((1, 7, 8)), small, 4, None)
    with pytest.raises(ValueError, match="plan is not one of"):
        cdv.trilinear_devoxelize(torch.zeros((1, 4, 4, 4, 8)),
                                 small.clone(), other)
    with pytest.raises(ValueError, match="plan is not one of"):
        cdv.trilinear_devoxelize(torch.zeros((1, 8, 8, 8, 8)), small, other)
    with pytest.raises(ValueError, match="plan is not one of"):
        cdv.devoxelize_grad(torch.zeros((1, 7, 8)), small, 8, other)
    assert len(calls) == 5
    assert cdv.LAUNCHES == {"trilinear_devoxelize": 2,
                            "trilinear_devoxelize_bwd": 1,
                            "trilinear_devoxelize_plan": 2}

    from open3d_ml_tpu_torch.ops.cuda import _build

    class Failing:
        def trilinear_devoxelize_plan_launch(self, *args):
            return 9

        def trilinear_devoxelize_launch(self, *args):
            return 9

    monkeypatch.setattr(_build, "library", Failing)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        cdv.devoxelize_plan(small, 4)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        cdv.trilinear_devoxelize(torch.zeros((1, 4, 4, 4, 8)), small, other)
    assert cdv.LAUNCHES == {"trilinear_devoxelize": 2,
                            "trilinear_devoxelize_bwd": 1,
                            "trilinear_devoxelize_plan": 2}


def test_step_launches_counted(monkeypatch):
    """A forward of the net builds one devoxelisation plan per resolution
    (2: r 8 for the first block, r 4 shared by the other three) and
    launches the devoxelisation once a PVConv block (4) through its
    resolution's plan, and a training step's backward the backward kernel
    as often, through the same plans, through the stand-in library."""
    calls = _stand_in(monkeypatch)
    net = PVCNN(**SMALL).get_net().train()
    pts, feat = _cloud(5)
    out = net({"point": torch.from_numpy(pts),
               "feat": torch.from_numpy(feat)})
    assert cdv.LAUNCHES == {"trilinear_devoxelize": 4,
                            "trilinear_devoxelize_bwd": 0,
                            "trilinear_devoxelize_plan": 2}
    out.sum().backward()
    assert cdv.LAUNCHES == {"trilinear_devoxelize": 4,
                            "trilinear_devoxelize_bwd": 4,
                            "trilinear_devoxelize_plan": 2}
    plans = [c for c in calls if c[0] == "plan"]
    fwds = [c for c in calls if c[0] == "fwd"]
    bwds = [c for c in calls if c[0] == "bwd"]
    assert [c[11] for c in plans] == [8, 4]
    assert [c[8:10] for c in fwds] == [(8, 8), (4, 8), (4, 8), (4, 16)]
    assert [c[3:5] for c in fwds] == [
        (c[3], c[2]) for c in plans[:1] + plans[1:] * 3]
    assert sorted(c[2:5] for c in bwds) == sorted(
        c[3:6] for c in plans[:1] + plans[1:] * 3)


def _numpy_plan(coords, r):
    """(cells, stable order, offsets) of coords [B, N, 3] with numpy."""
    b, n, _ = coords.shape
    lo = np.clip(np.floor(np.clip(coords, 0, r - 1)).astype(np.int64), 0,
                 r - 2)
    cells = (np.arange(b)[:, None] * r**3 +
             (lo[..., 0] * r + lo[..., 1]) * r + lo[..., 2]).reshape(-1)
    offsets = np.concatenate([[0], np.cumsum(np.bincount(
        cells, minlength=b * r**3))])
    return cells, np.argsort(cells, kind="stable"), offsets


@pytest.mark.parametrize("r", [4, 8])
def test_devoxelize_plan_plain_contract(r):
    """The plain plan: each point's lo cell, the points sorted by it with
    ascending indices within a cell, and the CSR offsets of the B r^3
    cells, all int32 and equal to a numpy count; each sorted point's 8
    corner weights, ``corner_weights``' in ``CORNERS`` order; the
    coordinates kept. ``devoxelize_plan`` builds none on the CPU."""
    _, coords, _ = _devox_inputs(10 + r, r, n=600)
    ct = torch.from_numpy(np.ascontiguousarray(coords.transpose(0, 2, 1)))
    assert cdv.devoxelize_plan(ct, r) is None  # the CPU reads no plan
    plan = cdv.devoxelize_plan_plain(ct, r)
    assert plan.coords is ct and plan.r == r
    assert {t.dtype for t in plan[2:5]} == {torch.int32}
    assert plan.weights.dtype == torch.float32
    cells, order, offsets = _numpy_plan(ct.numpy(), r)
    np.testing.assert_array_equal(plan.cell.numpy(), cells)
    np.testing.assert_array_equal(plan.perm.numpy(), order)
    np.testing.assert_array_equal(plan.offsets.numpy(), offsets)
    for k, (_, w) in enumerate(cdv.corner_weights(ct, r)):
        np.testing.assert_array_equal(plan.weights[:, k].numpy(),
                                      w.reshape(-1)[order].numpy())
    # many points share a cell (every 17th sits at r - 1 in all three)
    assert np.diff(offsets).max() >= 600 // 17


def _owner_order_grad(g, coords, r, plan):
    """The backward kernel's order, written out: each cell sums, corner
    by corner in ``CORNERS`` order, g * w of the points of lo cell
    (cell - corner) in ascending point index (the plan's runs and
    weights), from +0, one float32 product and one sum at a time."""
    b, _, c = g.shape
    g = g.reshape(-1, c)
    perm, offsets = plan.perm.long(), plan.offsets.long()
    cells = torch.arange(b * r**3)
    x, y, z = cells // r**2 % r, cells // r % r, cells % r
    dgrid = torch.zeros((b * r**3, c), dtype=g.dtype)
    for corner in cdv.CORNERS:
        sx, sy, sz = x - corner[0], y - corner[1], z - corner[2]
        ok = (sx >= 0) & (sy >= 0) & (sz >= 0)
        src = torch.where(ok, cells // r**3 * r**3 + (sx * r + sy) * r + sz,
                          0)
        start = offsets[src]
        count = torch.where(ok, offsets[src + 1] - start, 0)
        for t in range(int(count.max())):
            take = count > t
            j = start[take] + t
            w = plan.weights[j, cdv.CORNERS.index(corner)]
            dgrid[take] = dgrid[take] + g[perm[j]] * w[:, None]
    return dgrid.reshape(b, r, r, r, c)


@pytest.mark.parametrize("r", [4, 8])
def test_owner_order_equals_grad_plain_bit_for_bit(r):
    """The owner-computes order of the backward kernel, run sequentially on
    the CPU, equals ``devoxelize_grad_plain`` (its per-corner
    ``index_add_``) bit for bit on uniform coordinates and normal
    cotangents, where the products are not exact; and the sum in another
    order (corners last to first) does not, so the order is what holds
    the bits."""
    _, coords, g = _devox_inputs(20 + r, r, c=12, n=600)
    ct = torch.from_numpy(np.ascontiguousarray(coords.transpose(0, 2, 1)))
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 2, 1)))
    plan = cdv.devoxelize_plan_plain(ct, r)
    want = cdv.devoxelize_grad_plain(gt, ct, r)
    np.testing.assert_array_equal(_owner_order_grad(gt, ct, r, plan).numpy(),
                                  want.numpy())
    reverse = torch.zeros_like(want).reshape(-1, 12)
    for rows, w in cdv.corner_weights(ct, r)[::-1]:
        reverse.index_add_(0, rows.reshape(-1), (gt * w[..., None]).reshape(
            -1, 12))
    assert not torch.equal(reverse.reshape(want.shape), want)


# ------------------------------------------------------------ voxelisation

@pytest.mark.parametrize("normalize", [True, False])
def test_voxelize_normalized_equals_jax(normalize):
    """``normalized_coords`` and ``avg_voxelize`` at their cells, as
    ``PVConv`` voxelises, per sample of the batch against the JAX
    ``voxelize_normalized``: the voxel-unit coordinates within 1e-6
    relative L2, every point's cell equal (a cell may differ only where a
    coordinate lies within rounding of a .5 tie: none at these seeds; at
    most 1 in 1,000 points is the bound), the grids within 1e-6;
    ``avg_voxelize`` on the same cells within 1e-6."""
    pts, feat = _cloud(6, n=1000)
    if not normalize:
        pts = pts / 3.0 * 2.0 - 1.0
    for r in (4, 8, 32):
        norm = tpv.normalized_coords(torch.from_numpy(pts), r,
                                     normalize=normalize)
        grid = tpv.avg_voxelize(torch.from_numpy(feat),
                                tpv.voxel_cells(norm), r)
        assert grid.shape == (B, r, r, r, 9) and grid.is_contiguous()
        for b in range(B):
            jgrid, jnorm = jpv.voxelize_normalized(
                jnp.asarray(feat[b]), jnp.asarray(pts[b]), r, normalize)
            jnorm = np.asarray(jnorm)
            assert _rel(norm[b].numpy(), jnorm) <= 1e-6
            cells = tpv.voxel_cells(norm[b]).numpy()
            differ = (cells != np.round(jnorm)).any(-1).sum()
            assert differ <= len(cells) // 1000
            if differ == 0:
                assert _rel(grid[b].numpy(), np.asarray(jgrid)) <= 1e-6
            vox = np.round(jnorm).astype(np.int32)
            want = np.asarray(jpv.avg_voxelize(jnp.asarray(feat[b]),
                                               jnp.asarray(vox), r))
            got = tpv.avg_voxelize(torch.from_numpy(feat[b:b + 1]),
                                   torch.from_numpy(vox[None]).long(), r)
            assert _rel(got[0].numpy(), want) <= 1e-6


def test_voxel_cells_round_half_to_even():
    v = torch.tensor([0.5, 1.5, 2.5, 2.4999998, 3.5000002])
    np.testing.assert_array_equal(tpv.voxel_cells(v).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(
                                      v.numpy()))).astype(np.int64))


# --------------------------------------------------------------- BatchNorm

def _old_batch_norm(bn, x):
    """The train-mode forward of ``models/common.py`` ``BatchNorm`` before
    it took 5-d input: 2-d rows at axis -1, NCHW at axis 1."""
    rows = x.reshape(-1, x.shape[-1]) if bn.axis == -1 else x
    dims = 0 if bn.axis == -1 else (0, 2, 3)
    mean = rows.mean(dims)
    var = torch.clamp((rows * rows).mean(dims) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    if bn.axis == 1:
        mean, mul = mean[:, None, None], mul[:, None, None]
        return (rows - mean) * mul + bn.bias[:, None, None]
    return ((rows - mean) * mul + bn.bias).reshape(x.shape)


def test_batch_norm_earlier_ranks_unchanged_and_5d_equals_flax():
    """2-d (axis -1) and NCHW (axis 1) train-mode outputs bit-equal to the
    implementation before the 5-d change; at 5-d, axis 1, in
    ``channels_last_3d``, the output, its memory format and the running
    statistics against flax's BatchNorm over NDHWC (momentum 0.9, eps
    1e-4), within 1e-6."""
    rng = np.random.default_rng(8)
    for shape, axis in (((64, 6), -1), ((4, 6, 5, 7), 1)):
        bn = BatchNorm(6, axis=axis).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5)
            bn.bias.normal_()
        x = torch.from_numpy(rng.normal(1, 2, shape).astype(np.float32))
        with torch.no_grad():
            np.testing.assert_array_equal(bn(x).numpy(),
                                          _old_batch_norm(bn, x).numpy())
    x = rng.normal(1, 2, (2, 4, 4, 4, 6)).astype(np.float32)  # NDHWC
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-4)
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 1, 6).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": variables["batch_stats"]}
    want, upd = flax_bn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
    bn = BatchNorm(6, eps=1e-4, momentum=0.1, axis=1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    assert xt.is_contiguous(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        got = bn(xt)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert _rel(got.permute(0, 2, 3, 4, 1).numpy(), want) <= 1e-6
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, ours).numpy(),
                                   upd["batch_stats"][theirs], rtol=1e-6)
    bn.eval()
    with torch.no_grad():
        ev = bn(xt).permute(0, 2, 3, 4, 1).numpy()
    want_eval = flax_bn.clone(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]},
        jnp.asarray(x))
    assert _rel(ev, want_eval) <= 1e-6


# ----------------------------------------------------------------- modules

class _VNet(fnn.Module):
    """A JAX module per sample under ``nn.vmap``, BatchNorm synced over the
    batch axis, as the JAX net runs it."""
    net: fnn.Module
    training: bool = False
    takes_training: bool = True

    @fnn.compact
    def __call__(self, args):
        kw = {"training": self.training} if self.takes_training else {}
        fn = fnn.vmap(lambda mdl, a: mdl(*a, **kw),
                      variable_axes={"params": None, "batch_stats": None},
                      split_rngs={"params": False}, in_axes=(0,),
                      out_axes=0, axis_name="batch")
        return fn(self.net, args)


def _module_case(name):
    """(JAX module, port module, its batched args as numpy, whether the JAX
    module takes ``training``, the port's args)."""
    pts, feat = _cloud(20, c=12)
    if name == "shared_mlp":
        return (jpv.SharedMLP((16, 8)), tpv.SharedMLP(12, (16, 8)),
                (feat,), True, (feat,))
    if name == "se3d":
        grid = np.random.default_rng(21).normal(
            1, 1, (B, 4, 4, 4, 16)).astype(np.float32)
        return (jpv.SE3d(16), tpv.SE3d(16), (grid,), False,
                (grid.transpose(0, 4, 1, 2, 3),))
    if name == "pvconv_r8":
        return (jpv.PVConv(8, 8), tpv.PVConv(12, 8, 8), (feat, pts), True,
                (feat, pts))
    if name == "pvconv_r4_se":
        return (jpv.PVConv(16, 4, with_se=True),
                tpv.PVConv(12, 16, 4, with_se=True), (feat, pts), True,
                (feat, pts))
    raise KeyError(name)


def _flat(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, f"{prefix}{key}.")
        else:
            yield prefix + key, value


def _stats_to_port(stats):
    return {k.replace(".mean", ".running_mean").replace(".var",
                                                         ".running_var"): v
            for k, v in _flat(stats)}


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["shared_mlp", "se3d", "pvconv_r8",
                                  "pvconv_r4_se"])
def test_module_matches_jax(name, training):
    """Each module on the JAX module's weights: outputs within ``TOL``; in
    train mode also every BN's updated running statistics (1e-5)."""
    jmod, tmod, args, takes, targs = _module_case(name)
    jargs = jax.tree.map(jnp.asarray, args)
    vnet = _VNet(jmod, training, takes)
    variables = shape_variables(vnet, jargs)
    if training and "batch_stats" in variables:
        want, upd = jax.jit(lambda v, a: vnet.apply(
            v, a, mutable=["batch_stats"]))(variables, jargs)
    else:
        want, upd = jax.jit(vnet.apply)(variables, jargs), None
    load_jax_variables(tmod, variables).train(training)
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(np.ascontiguousarray(a))
                     if a.ndim != 5 else torch.from_numpy(a) for a in targs])
    got = got.numpy()
    if name == "se3d":
        got = got.transpose(0, 2, 3, 4, 1)
    assert got.shape == np.shape(want)
    assert _rel(got, want) <= TOL, name
    if upd is not None:
        sd = tmod.state_dict()
        for key, value in _stats_to_port(
                jax.tree.map(np.asarray, upd["batch_stats"]["net"])).items():
            np.testing.assert_allclose(sd[key].numpy(), value, rtol=1e-5,
                                       atol=1e-6, err_msg=key)


# --------------------------------------------------------------- the net

@pytest.fixture(scope="module")
def small():
    """A batch, the JAX net's variables (BN statistics drawn) and its
    eval-mode logits at the small config."""
    pts, feat = _cloud(30)
    labels = np.random.default_rng(32).integers(0, 13, (B, N)).astype(
        np.int32)
    jm = jpv.PVCNN(**SMALL)
    net = jm.get_net()
    inputs = {"point": jnp.asarray(pts), "feat": jnp.asarray(feat)}
    variables = shape_variables(net, inputs, seed=33, training=False)
    logits = np.asarray(jax.jit(lambda v, b: net.apply(
        v, b, training=False))(variables, inputs))
    return {"batch": {"point": pts, "feat": feat, "label": labels},
            "variables": variables, "logits": logits, "jax_model": jm,
            "jax_net": net}


def test_net_eval_matches_jax(small):
    net = load_jax_variables(PVCNN(**SMALL).get_net(),
                             small["variables"]).eval()
    batch = small["batch"]
    with torch.no_grad():
        got = net({"point": torch.from_numpy(batch["point"]),
                   "feat": torch.from_numpy(batch["feat"])}).numpy()
    assert got.shape == (B, N, 13)
    assert _rel(got, small["logits"]) <= TOL


def test_convert_round_trip(small):
    """JAX -> port -> JAX on PVCNN's tree: every leaf back bit for bit; a
    3D Conv kernel [kd, kh, kw, in, out] is the Conv3d weight [out, in,
    kd, kh, kw]."""
    variables = small["variables"]
    sd = load_jax_variables(PVCNN(**SMALL).get_net(),
                            variables).state_dict()
    params = variables["params"]["net"]
    kernel = params["pf0"]["vconv1"]["kernel"]
    assert kernel.ndim == 5
    np.testing.assert_array_equal(sd["pf0.vconv1.weight"].numpy(),
                                  kernel.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        sd["pf4.dense_0.weight"].numpy(),
        params["pf4"]["dense_0"]["kernel"].T)
    back = state_dict_to_jax(sd)
    flat = jax.tree_util.tree_leaves_with_path
    ref, got = dict(flat(variables)), dict(flat(back))
    assert set(got) == set(ref)
    for path, value in ref.items():
        np.testing.assert_array_equal(got[path], value)


def _reference_state_dict(rng, w=0.25, in_ch=9, classes=13):
    """A reference-shaped PVCNN state_dict (``point_features`` ModuleList,
    ``cloud_features`` and ``classifier`` Sequentials, 1x1 Conv1d
    weights [out, in, 1]) at width ``w``, as numpy."""
    sd = {}

    def t(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)

    def bn(tp, c):
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"{tp}.{leaf}"] = t(c)
        sd[tp + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[tp + ".num_batches_tracked"] = np.asarray(7)

    def conv1d(tp, i, o):
        sd[tp + ".weight"], sd[tp + ".bias"] = t(o, i, 1), t(o)

    def mlp(tp, i, o):
        conv1d(tp + ".layers.0", i, o)
        bn(tp + ".layers.1", o)

    li, ci, concat = 0, in_ch, 0
    for oc, num_blocks, res in tpv.BLOCKS:
        oc = int(w * oc)
        for _ in range(num_blocks):
            tp = f"point_features.{li}"
            if res is None:
                mlp(tp, ci, oc)
            else:
                for j, cin in ((0, ci), (3, oc)):
                    sd[f"{tp}.voxel_layers.{j}.weight"] = t(oc, cin, 3, 3, 3)
                    sd[f"{tp}.voxel_layers.{j}.bias"] = t(oc)
                    bn(f"{tp}.voxel_layers.{j + 1}", oc)
                mlp(tp + ".point_features", ci, oc)
            ci, concat, li = oc, concat + oc, li + 1
    c0, c1 = int(w * 256), int(w * 128)
    sd["cloud_features.0.0.weight"], sd["cloud_features.0.0.bias"] = \
        t(c0, ci), t(c0)
    bn("cloud_features.0.1", c0)
    sd["cloud_features.1.0.weight"], sd["cloud_features.1.0.bias"] = \
        t(c1, c0), t(c1)
    bn("cloud_features.1.1", c1)
    mlp("classifier.0", concat + c1, int(w * 512))
    mlp("classifier.2", int(w * 512), int(w * 256))
    conv1d("classifier.4", int(w * 256), classes)
    return sd


def test_convert_pvcnn_equals_jax():
    """``convert_pvcnn`` on a synthetic reference state_dict equals the JAX
    package's ``convert_pvcnn`` after ``jax_to_state_dict``, key for key
    and bit for bit, but for the BatchNorms' batch counts (0) that the
    port adds, and loads strictly into the port's net of that width."""
    sd = _reference_state_dict(np.random.default_rng(40))
    got = convert_pvcnn({k: torch.from_numpy(np.asarray(v))
                         for k, v in sd.items()})
    want = jax_to_state_dict(jax_convert_pvcnn(sd))
    counts = {k for k in got if k.endswith("num_batches_tracked")}
    assert set(got) - counts == set(want)
    assert all(got[k].item() == 0 for k in counts)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(),
                                      err_msg=key)
    net = PVCNN(width_multiplier=0.25).get_net()
    net.load_state_dict(got, strict=True)


# ----------------------------------------------------------- host side

def _room(seed, n=6000):
    rng = np.random.default_rng(seed)
    return {"point": rng.uniform(0, 4, (n, 3)).astype(np.float32),
            "feat": rng.integers(0, 256, (n, 3)).astype(np.float32),
            "label": rng.integers(0, 13, n).astype(np.int32)}


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("n_points", [1024, 8192])
def test_preprocess_bit_equal(split, n_points):
    """``preprocess`` (the augmentation on the training split; the
    minimum moved to 0, the 9 features, the draw of ``num_points``, with
    replacement where the room has fewer) bit-equal to JAX over two draws
    of models seeded alike, and with a generator passed in."""
    room = _room(5)
    kw = dict(num_points=n_points, augment=AUGMENT.to_dict(), seed=7)
    jm, tm = jpv.PVCNN(**kw), PVCNN(**kw)
    attr = {"split": split}
    for draw in range(3):
        rng = (None, None, 11)[draw]
        jp = jm.preprocess(room, attr, rng=rng and np.random.default_rng(rng))
        tp = tm.preprocess(room, attr, rng=rng and np.random.default_rng(rng))
        assert set(jp) == set(tp) == {"point", "feat", "label",
                                      "point_inds"}
        for key in jp:
            assert tp[key].dtype == jp[key].dtype
            np.testing.assert_array_equal(tp[key], jp[key], err_msg=key)
        assert tp["feat"].shape == (n_points, 9)
        assert tm.transform(tp, attr) is tp
    room.pop("feat")
    np.testing.assert_array_equal(tm.preprocess(room, attr)["feat"],
                                  jm.preprocess(room, attr)["feat"])


def _dataset_cfg():
    class Dataset:
        cfg = Config({"class_weights": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8,
                                        9]})
    return Dataset()


def test_loss_and_update_probs_equal_jax():
    rng = np.random.default_rng(42)
    logits = rng.normal(0, 3, (2, 100, 13)).astype(np.float32)
    labels = rng.integers(-1, 13, (2, 100)).astype(np.int32)
    kw = dict(ignored_label_inds=[-1])
    jm, tm = jpv.PVCNN(**kw), PVCNN(**kw)
    want, _, _ = jm.get_loss(JaxLoss(None, jm, _dataset_cfg()),
                             jnp.asarray(logits),
                             {"label": jnp.asarray(labels)})
    got, _, _ = tm.get_loss(SemSegLoss(None, tm, _dataset_cfg()),
                            torch.from_numpy(logits),
                            {"label": torch.from_numpy(labels)})
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    inputs = {"point_inds": np.stack([rng.permutation(150)[:100]
                                      for _ in range(2)]).astype(np.int32)}
    ref = jm.update_probs(inputs, logits, np.zeros((150, 13), np.float32))
    out = tm.update_probs(inputs, logits, np.zeros((150, 13), np.float32))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_augment_list_equal_jax():
    """The augmentation list of the host-side tests draws alike in both
    packages (the PVCNN preprocess hands it the model's generator)."""
    from open3d_ml_tpu_torch.datasets.augment import SemsegAugmentation
    room = _room(9, 800)
    cfg = AUGMENT.to_dict()
    got = SemsegAugmentation(cfg).augment(
        room["point"].copy(), room["feat"].copy(), room["label"].copy(),
        cfg, seed=np.random.default_rng(3))
    want = JaxAugment(cfg).augment(
        room["point"].copy(), room["feat"].copy(), room["label"].copy(),
        cfg, seed=np.random.default_rng(3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_defaults_and_yaml_equal_jax():
    """The port's defaults are the JAX class's; the port's YAML parses to
    the JAX file's values; the registry names the class."""
    assert PVCNN().cfg.to_dict() == jpv.PVCNN().cfg.to_dict()
    assert MODEL.get("PVCNN") is PVCNN
    jcfg = Config.load_from_file(
        REPO / "open3d_ml_tpu/configs/pvcnn_s3dis.yml")
    tcfg = Config.load_from_file(PV_YML)
    for section in ("dataset", "model", "pipeline"):
        assert tcfg[section].to_dict() == jcfg[section].to_dict(), section
    net = PVCNN(**tcfg.model.to_dict()).get_net()
    assert [m.resolution for m in net.modules()
            if isinstance(m, tpv.PVConv)] == [64, 32, 32, 32]
    assert sum(p.numel() for p in net.parameters()) == sum(
        v.size for v in jax.tree.leaves(jax.eval_shape(
            lambda: jpv.PVCNN(**tcfg.model.to_dict()).get_net().init(
                jax.random.PRNGKey(0),
                {"point": jnp.zeros((1, 64, 3)),
                 "feat": jnp.zeros((1, 64, 9))}))["params"]))
