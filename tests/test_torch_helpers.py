"""The port's library helpers against the JAX package's on the CPU: the
ragged rows and segment reductions (``ops/ragged.py``), grid subsampling
of a ragged batch (``ops/subsample.py``), the transform helpers
(``datasets/utils/transforms.py``), the schedules
(``modules/schedulers.py``), the optimizers with their weight-decay mask
(``modules/optimizers.py``), the model FLOPs and the card's peak
(``utils/flops.py``), the profiler hooks (``utils/profiling.py``) and the
boxes' corners and line sets (``vis/boundingbox.py``).

Tolerances: integer results, maxima and minima exactly equal; float sums
and means within 1e-6 relative (the two sum in other orders); the
schedules within 1e-6 relative plus 2^-22 of the base rate (JAX computes
them in float32, where 1 + cos and the one-cycle interpolation cancel to
small values; the port in float64); five optimizer updates within 1e-5
relative L2 per parameter.
"""

import json
import logging
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import yaml
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from open3d_ml_tpu.datasets.utils import transforms as jax_transforms
from open3d_ml_tpu.datasets.utils.bev_box import BEVBox3D as JaxBEVBox3D
from open3d_ml_tpu.models.randlanet import RandLANet as JaxRandLANet
from open3d_ml_tpu.modules import optimizers as jax_optimizers
from open3d_ml_tpu.modules import schedulers as jax_schedulers
from open3d_ml_tpu.ops import ragged as jax_ragged
from open3d_ml_tpu.ops.subsample import (
    grid_subsampling_batch as jax_grid_batch)
from open3d_ml_tpu.utils import flops as jax_flops
from open3d_ml_tpu.utils import profiling as jax_profiling
from open3d_ml_tpu.vis import BoundingBox3D as JaxBoundingBox3D
from open3d_ml_tpu.vis import LabelLUT as JaxLabelLUT
from open3d_ml_tpu_torch import ops
from open3d_ml_tpu_torch.datasets.utils import BEVBox3D, transforms
from open3d_ml_tpu_torch.datasets.utils.dataprocessing import DataProcessing
from open3d_ml_tpu_torch.models import PointPillars, RandLANet
from open3d_ml_tpu_torch.modules import optimizers, schedulers
from open3d_ml_tpu_torch.ops import ragged
from open3d_ml_tpu_torch.utils import flops, profiling
from open3d_ml_tpu_torch.utils.convert_jax import (jax_to_state_dict,
                                                   net_layout,
                                                   state_dict_to_jax)
from open3d_ml_tpu_torch.vis import BoundingBox3D, LabelLUT

from test_torch_pointpillars import SMALL as PP_SMALL
from test_torch_randlanet import SMALL as RANDLA_SMALL
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RANDLA_YAMLS = sorted((REPO / "open3d_ml_tpu_torch" / "configs").glob(
    "randlanet_*.yml"))
SCHEDULE_STEPS = 2001  # updates 0 to 2,000
# one float32 ulp at 1 is 2^-23: two roundings of a term of the base rate
SCHEDULE_ATOL = 2.0 ** -22

# ------------------------------------------------------------ ragged rows

# rows of 2, 0, 3, 0 and 4 entries, then 3 padding positions; an empty
# row, and empty rows at either end
ROW_SPLITS = [np.array([0, 2, 2, 5, 5, 9], np.int32),
              np.array([0, 0, 4, 4], np.int32),
              np.array([0, 0], np.int32)]
# segment ids with empty segments (1, 4), a negative id and ids past the
# last segment
SEGMENT_IDS = np.array([0, 0, 2, 3, 3, 3, 5, -1, 6, 2, 0, 9], np.int32)
NUM_SEGMENTS = 6


def _values(n, dtype, tail=(3,)):
    rng = np.random.default_rng(n)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(-50, 50, (n,) + tail).astype(dtype)
    return rng.normal(0, 10, (n,) + tail).astype(dtype)


def _close_or_equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("splits", ROW_SPLITS, ids=["mixed", "ends", "none"])
def test_row_split_helpers_equal_jax(splits):
    total = int(splits[-1]) + 3
    got = ragged.row_splits_to_segment_ids(torch.from_numpy(splits), total)
    want = jax_ragged.row_splits_to_segment_ids(jnp.asarray(splits), total)
    _close_or_equal(got, want)
    back = ragged.segment_ids_to_row_splits(got, len(splits) - 1)
    _close_or_equal(back, jax_ragged.segment_ids_to_row_splits(
        want, len(splits) - 1))
    np.testing.assert_array_equal(back.numpy(), splits)
    ids = torch.from_numpy(SEGMENT_IDS)
    _close_or_equal(ragged.segment_ids_to_row_splits(ids, NUM_SEGMENTS),
                    jax_ragged.segment_ids_to_row_splits(
                        jnp.asarray(SEGMENT_IDS), NUM_SEGMENTS))
    lengths = np.diff(splits)
    mask = ragged.dense_to_ragged_mask(torch.from_numpy(lengths), 3)
    _close_or_equal(mask, jax_ragged.dense_to_ragged_mask(
        jnp.asarray(lengths), 3))
    arr = ragged.RaggedArray(torch.zeros(total), torch.from_numpy(splits))
    assert arr.num_rows == len(splits) - 1
    np.testing.assert_array_equal(arr.row_lengths().numpy(), lengths)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("splits", ROW_SPLITS[:2], ids=["mixed", "ends"])
def test_ragged_to_dense_and_row_sums_equal_jax(splits, dtype):
    """Rows cut at 3 columns and padded with -7; the sums of the rows,
    the padding dropped."""
    total = int(splits[-1]) + 3
    values = _values(total, dtype)
    rows = len(splits) - 1
    _close_or_equal(
        ragged.ragged_to_dense(torch.from_numpy(values),
                               torch.from_numpy(splits), rows, 3, -7),
        jax_ragged.ragged_to_dense(jnp.asarray(values), jnp.asarray(splits),
                                   rows, 3, -7))
    _close_or_equal(
        ragged.reduce_subarrays_sum(torch.from_numpy(values),
                                    torch.from_numpy(splits)),
        jax_ragged.reduce_subarrays_sum(jnp.asarray(values),
                                        jnp.asarray(splits)))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max"])
def test_segment_reductions_equal_jax(name, dtype):
    """Empty segments, a negative id and ids past the last segment: JAX
    drops the ids outside [0, num_segments); an empty segment sums and
    averages to 0 and its maximum is the dtype's lowest value."""
    values = _values(len(SEGMENT_IDS), dtype)
    got = getattr(ragged, name)(torch.from_numpy(values),
                                torch.from_numpy(SEGMENT_IDS), NUM_SEGMENTS)
    want = getattr(jax_ragged, name)(jnp.asarray(values),
                                     jnp.asarray(SEGMENT_IDS), NUM_SEGMENTS)
    _close_or_equal(got, want)
    if name == "segment_max":
        lowest = (-np.inf if dtype == np.float32 else
                  np.iinfo(dtype).min)
        assert (got.numpy()[[1, 4]] == lowest).all()


def test_segment_max_never_reads_initial():
    """``initial`` is accepted and never read, in JAX too: an empty
    segment keeps the dtype's lowest value."""
    values = _values(len(SEGMENT_IDS), np.float32, ())
    got = ragged.segment_max(torch.from_numpy(values),
                             torch.from_numpy(SEGMENT_IDS), NUM_SEGMENTS,
                             initial=0.0)
    want = jax_ragged.segment_max(jnp.asarray(values),
                                  jnp.asarray(SEGMENT_IDS), NUM_SEGMENTS,
                                  initial=0.0)
    _close_or_equal(got, want)
    assert got[1] == -np.inf


@pytest.mark.parametrize("axis", [0, 1])
def test_masked_reductions_equal_jax(axis):
    """A row and a column with no entry: the max gives ``initial``, the
    mean 0."""
    rng = np.random.default_rng(4)
    values = rng.normal(0, 5, (5, 6)).astype(np.float32)
    mask = rng.random((5, 6)) < 0.6
    mask[2] = False
    mask[:, 3] = False
    for initial in (-np.inf, -100.0):
        _close_or_equal(
            ragged.masked_max(torch.from_numpy(values),
                              torch.from_numpy(mask), axis, initial),
            jax_ragged.masked_max(jnp.asarray(values), jnp.asarray(mask),
                                  axis, initial))
    _close_or_equal(
        ragged.masked_mean(torch.from_numpy(values), torch.from_numpy(mask),
                           axis),
        jax_ragged.masked_mean(jnp.asarray(values), jnp.asarray(mask), axis))


def test_ops_exports_equal_jax():
    """The port's ``ops`` exports the JAX package's ragged and subsample
    names; its one-cloud subsampling is ``DataProcessing``'s."""
    import open3d_ml_tpu.ops as jax_ops
    names = [n for n in jax_ops.__all__
             if getattr(jax_ops, n).__module__.endswith(("ragged",
                                                         "subsample"))]
    assert sorted(names) == sorted(ops.__all__)
    assert ops.grid_subsampling is DataProcessing.grid_subsampling


# ------------------------------------------------------- grid subsampling

@pytest.mark.parametrize("given", ["points", "features", "labels", "both"])
def test_grid_subsampling_batch_equals_jax(given):
    """Three clouds of a ragged batch, one of a single point: the points,
    row splits, features and labels equal to JAX's, bit for bit."""
    rng = np.random.default_rng(2)
    sizes = (400, 1, 250)
    points = rng.uniform(0, 2, (sum(sizes), 3)).astype(np.float32)
    splits = np.concatenate([[0], np.cumsum(sizes)])
    feats = (rng.normal(0, 1, (len(points), 4)).astype(np.float32)
             if given in ("features", "both") else None)
    labels = (rng.integers(0, 6, len(points)).astype(np.int32)
              if given in ("labels", "both") else None)
    got = ops.grid_subsampling_batch(points, splits, features=feats,
                                     labels=labels, grid_size=0.3)
    want = jax_grid_batch(points, splits, features=feats, labels=labels,
                          grid_size=0.3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1][-1] == len(got[0])


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize("cfg", [
    None, {"method": None},
    {"method": "linear", "normalize_points": True, "feat_bias": 3.0,
     "feat_scale": 7.0},
    {"method": "linear"},
    {"method": "coords_only"}], ids=["none", "no-method", "linear",
                                     "linear-feat", "coords-only"])
def test_trans_normalize_equals_jax(cfg):
    rng = np.random.default_rng(5)
    pc = rng.uniform(-4, 9, (200, 3)).astype(np.float32)
    feat = rng.uniform(0, 255, (200, 3)).astype(np.float32)
    got = transforms.trans_normalize(pc.copy(), feat.copy(), cfg)
    want = jax_transforms.trans_normalize(pc.copy(), feat.copy(), cfg)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cfg", [
    {"turn_on": False},
    {"turn_on": True},
    {"turn_on": True, "rotation_method": "all", "min_s": 0.8, "max_s": 1.2,
     "scale_anisotropic": True, "noise_level": 0.01},
    {"turn_on": True, "min_s": 0.9, "max_s": 1.1, "noise_level": 0.002}],
    ids=["off", "vertical", "all-anisotropic-noise", "scale-noise"])
def test_trans_augment_equals_jax(cfg):
    """The same draws at a fixed seed: equal points."""
    pts = np.random.default_rng(6).uniform(-3, 5, (300, 3)).astype(
        np.float32)
    got = transforms.trans_augment(pts.copy(), cfg, rng=11)
    want = jax_transforms.trans_augment(pts.copy(), cfg, rng=11)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,num_points", [(500, 64), (40, 64)])
def test_trans_crop_pc_equals_jax(n, num_points, monkeypatch):
    """The same KD-tree query, with both packages' unseeded draws (numpy's
    global generator where the cloud is short, a fresh ``default_rng``
    for the order) seeded alike: the same points, features, labels and
    indices."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    feat = rng.normal(0, 1, (n, 2)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    tree = cKDTree(pts)
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: real(13 if seed is None else seed))
    outs = []
    for fn in (transforms.trans_crop_pc, jax_transforms.trans_crop_pc):
        np.random.seed(9)
        outs.append(fn(pts, feat, labels, tree, 7, num_points))
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)
    assert outs[0][0].shape == (num_points, 3)
    assert 7 in outs[0][3]


# -------------------------------------------------------------- schedules

def _rates(make, steps=SCHEDULE_STEPS, lr=0.01):
    """The learning rate of updates 0 .. steps - 1 under ``make(opt)``."""
    w = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([w], lr=lr)
    sched = make(opt)
    out = []
    for _ in range(steps):
        out.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    return np.asarray(out)


def _jax_rates(schedule, steps=SCHEDULE_STEPS):
    return np.asarray(jax.vmap(schedule)(jnp.arange(steps)), np.float64)


@pytest.mark.parametrize("args", [(2000, 100, 1e-5), (1500, 0, 1e-5),
                                  (1000, 300, 1e-3)],
                         ids=["warmup", "no-warmup", "floor"])
def test_cosine_warmup_lr_equals_jax(args):
    got = _rates(lambda o: schedulers.cosine_warmup_lr(o, *args))
    want = _jax_rates(jax_schedulers.cosine_warmup_lr(0.01, *args))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=SCHEDULE_ATOL * 0.01)
    assert got.min() >= 0 and got[-1] == pytest.approx(0.01 * args[2])


@pytest.mark.parametrize("args", [(2000,), (1000, 25.0, 0.3),
                                  (1501, 10.0, 0.25)],
                         ids=["default", "div25", "odd"])
def test_one_cycle_lr_equals_optax(args):
    """optax's ``linear_onecycle_schedule`` as the JAX package builds it,
    past its last update too."""
    got = _rates(lambda o: schedulers.one_cycle_lr(o, *args))
    want = _jax_rates(jax_schedulers.one_cycle_lr(0.01, *args))
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=SCHEDULE_ATOL * 0.01)
    assert got.max() == pytest.approx(0.01)


@pytest.mark.parametrize("args", [(), (0.1, 0.5, 20), (0.9, 0.7, 3)])
def test_bn_momentum_schedule_equals_jax(args):
    got = schedulers.bn_momentum_schedule(*args)
    want = jax_schedulers.bn_momentum_schedule(*args)
    assert [got(e) for e in range(300)] == [want(e) for e in range(300)]
    assert got(10_000) == 0.01


# ------------------------------------------------------------- optimizers

# a RandLA-Net of two levels: the optimizers' parameter tree
RANDLA_OPT = dict(RANDLA_SMALL, num_points=256, num_layers=2,
                  dim_output=[8, 16], sub_sampling_ratio=[4, 4])


@pytest.fixture(scope="module")
def randla_params():
    """The JAX RandLA-Net's ``params`` tree (its init's shapes, drawn from
    a seeded generator, numpy), and the port net of the same config."""
    net = JaxRandLANet(compute_dtype="float32", **RANDLA_OPT).get_eval_net()
    n = RANDLA_OPT["num_points"]
    batch = {"coords": jnp.zeros((1, n, 3)), "features": jnp.zeros((1, n, 3))}
    shapes = jax.eval_shape(lambda b: net.init(
        {"params": jax.random.PRNGKey(0)}, b, training=False), batch)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: rng.normal(0, 0.5, x.shape).astype(np.float32),
        shapes["params"])
    return params, RandLANet(**RANDLA_OPT).get_net()


def _port_net(params):
    """The port net of ``RANDLA_OPT`` holding the flax ``params``."""
    port = RandLANet(**RANDLA_OPT).get_net()
    missing, unused = port.load_state_dict(
        jax_to_state_dict({"params": params}), strict=False)
    assert not unused
    assert all(k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")) for k in missing)
    return port


def _decayed_names(jax_mask, layout):
    """The port parameter names whose flax leaf ``jax_mask`` decays."""
    as_arrays = jax.tree.map(lambda m: np.full((1, 1), float(m)), jax_mask)
    sd = jax_to_state_dict({"params": as_arrays}, **layout)
    return {k for k, v in sd.items() if v.all()}, set(sd)


def test_no_decay_mask_equals_jax_on_randlanet(randla_params):
    params, port = randla_params
    got = optimizers.no_decay_mask(port)
    decayed, names = _decayed_names(
        jax_optimizers.no_decay_mask(params), net_layout(port))
    assert set(got) == names == {n for n, _ in port.named_parameters()}
    assert {n for n, d in got.items() if d} == decayed
    assert decayed and names - decayed


def test_no_decay_mask_equals_jax_on_pointpillars():
    """PointPillars: no flax scope, BatchNorms named ``bn*``, transposed
    convolutions; the mask of the tree that the port's weights convert
    to."""
    net = PointPillars(**PP_SMALL).get_net()
    layout = net_layout(net)
    params = state_dict_to_jax(net.state_dict(), **layout)["params"]
    got = optimizers.no_decay_mask(net)
    decayed, names = _decayed_names(
        jax_optimizers.no_decay_mask(params), layout)
    assert set(got) == names
    assert {n for n, d in got.items() if d} == decayed
    assert decayed and names - decayed


def _five_updates(port, params, make_port, tx, seed=1):
    """Five updates of ``port`` and of the flax ``params`` with optax's
    ``tx``, fed the same gradients (the port's, converted to flax leaves
    as the weights are); the relative L2 of each parameter after them,
    the flax ones converted back."""
    layout = net_layout(port)
    port = port.float()
    opt, sched = make_port(port)
    tree = params
    state = tx.init(tree)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(seed)
    for _ in range(5):
        grads = {n: torch.from_numpy(
            rng.normal(0, 1, tuple(p.shape)).astype(np.float32))
            for n, p in port.named_parameters()}
        jgrads = state_dict_to_jax(grads, **layout)["params"]
        updates, state = update(jgrads, state, tree)
        tree = optax.apply_updates(tree, updates)
        for n, p in port.named_parameters():
            p.grad = grads[n].clone()
        opt.step()
        if sched is not None:
            sched.step()
    want = jax_to_state_dict({"params": jax.tree.map(np.asarray, tree)},
                             **layout)
    return {n: float(torch.linalg.norm(p.detach() - want[n]) /
                     torch.linalg.norm(want[n]))
            for n, p in port.named_parameters()}


@pytest.mark.parametrize("decay_all", [False, True])
def test_adamw_grouped_equals_optax(randla_params, decay_all):
    params, _ = randla_params
    port = _port_net(params)
    errs = _five_updates(
        port, params,
        lambda m: (optimizers.adamw_grouped(
            m, 1e-2, weight_decay=0.3, betas=(0.8, 0.99),
            decay_norm_and_bias=decay_all), None),
        jax_optimizers.adamw_grouped(1e-2, weight_decay=0.3,
                                     betas=(0.8, 0.99),
                                     decay_norm_and_bias=decay_all))
    assert max(errs.values()) <= 1e-5, max(errs.items(), key=lambda e: e[1])


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_one_cycle_adam_equals_optax(randla_params, weight_decay):
    """Over 10 updates of which 5 run: the rate rises to its peak at
    update 4 and falls; b1 = moms[0], b2 = 0.99."""
    params, _ = randla_params
    port = _port_net(params)
    tx, _ = jax_optimizers.one_cycle_adam(10, 0.02, moms=(0.9, 0.8),
                                          weight_decay=weight_decay)
    errs = _five_updates(
        port, params,
        lambda m: optimizers.one_cycle_adam(m, 10, 0.02, moms=(0.9, 0.8),
                                            weight_decay=weight_decay),
        tx)
    assert max(errs.values()) <= 1e-5, max(errs.items(), key=lambda e: e[1])
    opt, sched = optimizers.one_cycle_adam(port, 10, 0.02)
    assert type(opt) is (torch.optim.Adam)
    assert opt.param_groups[0]["betas"] == (0.95, 0.99)


# ------------------------------------------------------------------ flops

def _randla_kwargs(path):
    cfg = yaml.safe_load(path.read_text())
    m = cfg["model"]
    return dict(num_points=m["num_points"],
                num_neighbors=m["num_neighbors"],
                dim_output=tuple(m["dim_output"]),
                dim_features=m["dim_features"],
                in_channels=m["in_channels"],
                sub_sampling_ratio=tuple(m["sub_sampling_ratio"]),
                num_classes=m["num_classes"],
                batch_size=cfg["pipeline"]["batch_size"])


@pytest.mark.parametrize("path", RANDLA_YAMLS, ids=lambda p: p.stem)
def test_randlanet_forward_flops_equal_jax(path):
    kwargs = _randla_kwargs(path)
    got = flops.randlanet_forward_flops(**kwargs)
    assert got == jax_flops.randlanet_forward_flops(**kwargs)
    assert isinstance(got, float) and got > 0


def test_pointpillars_forward_flops_equal_jax():
    """At ``pointpillars_kitti.yml``, read as ``bench.py`` reads it, and
    at the function's defaults."""
    cfg = yaml.safe_load((REPO / "open3d_ml_tpu_torch" / "configs" /
                          "pointpillars_kitti.yml").read_text())
    m = cfg["model"]
    kwargs = dict(
        max_points=m["max_points"],
        feat_channels=tuple(m["voxel_encoder"]["feat_channels"]),
        output_shape=tuple(m["scatter"]["output_shape"]),
        backbone=m["backbone"], neck=m["neck"],
        num_classes=len(m["classes"]),
        num_anchors=(len(np.asarray(m["head"]["sizes"]).reshape(-1, 3)) *
                     len(m["head"]["rotations"])),
        batch_size=cfg["pipeline"]["batch_size"])
    assert (flops.pointpillars_forward_flops(**kwargs) ==
            jax_flops.pointpillars_forward_flops(**kwargs))
    assert (flops.pointpillars_forward_flops() ==
            jax_flops.pointpillars_forward_flops())


def test_peak_flops_for_knows_only_the_h100():
    """The H100's dense bf16 peak by its device name; any other name
    raises (a default would put a wrong denominator under a share)."""
    assert flops.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    for name in ("TPU v5p", "TPU v5 lite", "NVIDIA A100-SXM4-80GB", "",
                 None):
        with pytest.raises(ValueError, match="no peak"):
            flops.peak_flops_for(name)
    assert not hasattr(flops, "TPU_PEAK_BF16")


# -------------------------------------------------------------- profiling

def test_trace_records_an_annotated_span(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("helpers-span"):
            torch.ones(64).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert [e for e in events if e.get("name") == "helpers-span"]
    with profiling.trace(tmp_path / "off", enabled=False):
        pass
    with profiling.trace(None):
        pass
    assert not (tmp_path / "off").exists()


@pytest.mark.parametrize("times", [[], [0.5], [0.3, 0.2, 0.11, 0.12, 0.1],
                                   [0.04, 0.01, 0.02, 0.05, 0.03, 0.06]])
def test_step_timer_summary_equals_jax(times, caplog):
    got, want = profiling.StepTimer(), jax_profiling.StepTimer()
    got.times, want.times = list(times), list(times)
    assert got.summary() == want.summary()
    with caplog.at_level(logging.INFO):
        got.log(logging.getLogger("port"), "p ")
        want.log(logging.getLogger("jax"), "p ")
    messages = [r.getMessage() for r in caplog.records]
    assert len(messages) == (2 if times else 0)
    assert len(set(messages)) <= 1
    timer = profiling.StepTimer(warmup=0)
    with timer.step():
        pass
    assert len(timer.times) == 1 and timer.summary()["steps"] == 1


# ------------------------------------------------------------------ boxes

def _boxes(pkg_box, pkg_bev):
    rng = np.random.default_rng(8)
    out = [pkg_bev(rng.uniform(-10, 10, 3), rng.uniform(0.5, 4, 3),
                   float(rng.uniform(-np.pi, np.pi)), label, conf)
           for label, conf in (("Car", -1.0), ("Pedestrian", 0.7),
                               ("Cyclist", 3.0), ("Van", 1.0))]
    axes = np.linalg.qr(rng.normal(0, 1, (3, 3)))[0]
    out.append(pkg_box(rng.uniform(-5, 5, 3), axes[0], axes[1], axes[2],
                       [1.5, 2.0, 0.5], "Car", 0.2, arrow_length=2.5))
    return out


def test_box_corners_and_lines_equal_jax():
    """``corners`` and ``create_lines`` bit-equal, with and without a
    ``LabelLUT`` (a class in it and one not), ground truth, predictions
    and other scores; 14 vertices and 17 lines a box."""
    got = _boxes(BoundingBox3D, BEVBox3D)
    want = _boxes(JaxBoundingBox3D, JaxBEVBox3D)
    for g, w in zip(got, want):
        assert g.corners().dtype == w.corners().dtype
        np.testing.assert_array_equal(g.corners(), w.corners())
    names = {"Car": "Car", "Pedestrian": "Pedestrian"}
    for lut in (None, (LabelLUT(names), JaxLabelLUT(names))):
        lines = BoundingBox3D.create_lines(
            got, lut=None if lut is None else lut[0])
        ref = JaxBoundingBox3D.create_lines(
            want, lut=None if lut is None else lut[1])
        assert list(lines) == list(ref)
        for key in ("vertex_positions", "line_indices", "line_colors"):
            assert lines[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(lines[key], ref[key])
        assert lines["bbox_labels"] == ref["bbox_labels"]
        assert lines["bbox_confidences"] == ref["bbox_confidences"]
        assert lines["vertex_positions"].shape == (14 * len(got), 3)
        assert lines["line_indices"].shape == (17 * len(got), 2)
    assert BoundingBox3D.create_lines([])["vertex_positions"].shape == (0, 3)
    with pytest.raises(ValueError):
        BoundingBox3D.create_lines(got, out_format="lineset")
