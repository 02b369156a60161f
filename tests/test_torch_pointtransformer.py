"""The port's PointTransformer (``open3d_ml_tpu_torch``) against the JAX
package, on the exact path.

Inputs are made with numpy from a seed and go through both packages. On
the CPU the JAX ``knn_search`` takes its XLA route and the port the plain
version of ``knn_exact``; both FPS are loops of the same steps. On the
1/32 lattice every d2 and every FPS distance is exact in float32, so both
sides pick the same neighbours and samples, ties included (the lower
index first), and the outputs differ only by float32 rounding: relative
L2 <= 1e-5 (``TOL``). On uniform floats the d2 formulas round apart, so
there the neighbours' distances are compared and the sets may differ only
at near-ties, as in ``test_torch_knn.py``.

The modules run on weights the JAX modules initialise (BN statistics drawn
with numpy so that BN is not the identity), carried into the port with
``load_jax_variables``; each JAX module runs per sample under ``nn.vmap``
with BatchNorm over the batch axis, as the JAX net does. The whole net runs
at blocks [1, 1, 1, 1, 1], B = 2, N = 512 (the widths are fixed by the
net), in eval and train mode, with one SGD step against ``optax``.
"""

import contextlib
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from open3d_ml_tpu.datasets import S3DIS as JaxS3DIS
from open3d_ml_tpu.datasets.augment import SemsegAugmentation as JaxAugment
from open3d_ml_tpu.dataloaders.dataloader import (
    PointCloudDataloader as JaxLoader)
from open3d_ml_tpu.models import point_transformer as jpt
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxLoss
from open3d_ml_tpu.ops import interpolation as jint
from open3d_ml_tpu.ops.sampling import (furthest_point_sampling as jfps,
                                        furthest_point_sampling_batch)
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu_torch import MODEL, run_pipeline
from open3d_ml_tpu_torch.datasets import S3DIS
from open3d_ml_tpu_torch.datasets.augment import SemsegAugmentation
from open3d_ml_tpu_torch.dataloaders import PointCloudDataloader
from open3d_ml_tpu_torch.models import PointTransformer
from open3d_ml_tpu_torch.models import point_transformer as tpt
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.ops import interpolation as tint
from open3d_ml_tpu_torch.ops.cuda import knn as ck
from open3d_ml_tpu_torch.ops.cuda import sampling as cfps
from open3d_ml_tpu_torch.ops.sampling import furthest_point_sampling
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
from open3d_ml_tpu_torch.utils import load_jax_variables, state_dict_to_jax

import chip_smoke
from test_torch_ops import lattice_cloud
from test_torch_randlanet import _randomise_stats
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PT_YML = REPO / "open3d_ml_tpu_torch/configs/pointtransformer_s3dis.yml"
TOL = 1e-5  # float32 relative L2
# the float64 nets: their 3-NN weights stay float32 in both packages (the
# distances come from the float32 search) and sum in other orders
F64_TOL = 1e-6
NEAR = 1e-3  # float64 distance gap inside which two neighbours may swap
B, N = 2, 512
SMALL = dict(blocks=[1, 1, 1, 1, 1], num_points=N)
# the shipped augmentation list, ChromaticAutoContrast's blend drawn
PT_AUGMENT = Config.load_from_file(
    REPO / "open3d_ml_tpu/configs/pointtransformer_s3dis.yml").model.augment


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jtree(batch):
    return jax.tree.map(jnp.asarray, batch)


def _lattice_batch(seed, b=B, n=N, c=3):
    rng = np.random.default_rng(seed)
    return (lattice_cloud(rng, b, n),
            rng.normal(0, 1, (b, n, c)).astype(np.float32))


# -------------------------------------------------------------- FPS, 3-NN

def _fps_case(case):
    rng = np.random.default_rng(10)
    mask = None
    n = {"past_one_cta": 1025, "past_one_cta_of_two": 2049}.get(case, 600)
    if case == "uniform":
        pts = rng.uniform(-25, 25, (B, n, 3)).astype(np.float32)
    else:
        pts = lattice_cloud(rng, B, n)
    if case == "duplicates":  # a short room padded by repeating points
        pts[:, 400:] = pts[:, rng.choice(400, 200)]
    if case == "quarter_repeated":
        # the last quarter repeats points of the first three: exact ties
        # between points that a cluster's CTAs hold apart
        keep = n - n // 4
        pts[:, keep:] = pts[:, rng.choice(keep, n - keep)]
    if case == "masked":
        mask = rng.random((B, n)) < 0.5
        mask[1] = False
        mask[1, rng.choice(n, 40, replace=False)] = True
    if case == "few_valid":  # fewer valid points than samples
        mask = np.zeros((B, n), bool)
        mask[:, rng.choice(n, 30, replace=False)] = True
    if case == "all_masked":
        mask = np.zeros((B, n), bool)
    return pts, mask


@pytest.mark.parametrize("case", ["uniform", "lattice", "duplicates",
                                  "masked", "past_one_cta",
                                  "past_one_cta_of_two", "quarter_repeated",
                                  "few_valid", "all_masked"])
def test_fps_equals_jax(case):
    """Indices equal ``furthest_point_sampling_batch``'s, ties (duplicate
    points, the lower index first) and masks included; the one-cloud form
    equals ``furthest_point_sampling``'s. The cases the kernel's split of
    a cloud over a cluster's CTAs makes risky: N just past one CTA's share
    (1,025 and 2,049 points), a quarter of the points repeated (exact
    ties), fewer valid points than samples, and no valid point at all
    (every step then takes index 0, the lowest of the equal -1s)."""
    pts, mask = _fps_case(case)
    m = 150
    want = np.asarray(furthest_point_sampling_batch(
        jnp.asarray(pts), m,
        points_mask=None if mask is None else jnp.asarray(mask)))
    got = furthest_point_sampling(
        torch.from_numpy(pts), m,
        points_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.int32 and got.shape == (B, m)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "masked":
        # sample 1 has 40 valid points: all of them come first (after
        # index 0, where every FPS starts), then valid ones repeat
        assert mask[1][got[1, 1:].numpy()].all()
    if case == "few_valid":
        # after index 0 only valid points, repeated once all are taken
        assert all(mask[row][got[row, 1:].numpy()].all() for row in range(B))
    if case == "all_masked":
        assert (got == 0).all()
    one = furthest_point_sampling(torch.from_numpy(pts[0]), m,
                                  points_mask=None if mask is None else
                                  torch.from_numpy(mask[0]))
    np.testing.assert_array_equal(one.numpy(), np.asarray(jfps(
        jnp.asarray(pts[0]), m,
        points_mask=None if mask is None else jnp.asarray(mask[0]))))


def test_fps_threads_and_checks():
    """The launch plan: one CTA up to 4,096 points, else the least
    cluster whose CTAs hold at most 1,024 points (16 CTAs at most);
    whole warps of 2 points a thread, up to 1,024 threads of up to 8
    points; a cluster outside (1, 2, 4, 8, 16), a CTA of more than 8,192
    points and clouds beyond ``MAX_POINTS`` are refused."""
    assert [cfps.fps_plan(n) for n in (1, 64, 256, 1024, 1025, 2048, 2049,
                                       4096, 4097, 16384, 24576, 32768)] == [
        (1, 32), (1, 32), (1, 128), (1, 512), (1, 544), (1, 1024),
        (1, 1024), (1, 1024), (8, 288), (16, 512), (16, 768), (16, 1024)]
    assert [cfps.fps_plan(16384, c) for c in (4, 8, 16)] == [
        (4, 1024), (8, 1024), (16, 512)]
    for n in (1, 100, 1025, 2049, 4096, 5000, 16384, 24576, 32768):
        for c in (None, 4, 8, 16):
            cluster, threads = cfps.fps_plan(n, c)
            per_cta = -(-n // cluster)
            assert threads % 32 == 0 and threads <= cfps.MAX_THREADS
            assert per_cta <= threads * cfps.MAX_PER_THREAD
            if c is None and n > cfps.ONE_CTA:
                assert per_cta <= 2 * cfps.CTA_POINTS
    with pytest.raises(ValueError, match="32768"):
        cfps.fps_plan(32769)
    with pytest.raises(ValueError, match="clusters"):
        cfps.fps_plan(1024, 3)
    with pytest.raises(ValueError, match="1024 threads"):
        cfps.fps_plan(32768, 2)
    pts = torch.zeros((1, 20, 3))
    with pytest.raises(ValueError, match="float32"):
        cfps.fps(pts.double(), 4)
    with pytest.raises(ValueError, match="points_mask"):
        cfps.fps(pts, 4, points_mask=torch.ones((1, 19), dtype=torch.bool))
    with pytest.raises(ValueError, match="m >= 1"):
        cfps.fps(pts, 0)
    meta = torch.zeros((1, 20, 3), device="meta")
    with pytest.raises(ValueError, match="no fps kernel"):
        cfps.fps(meta, 4)


def test_fps_wrapper_launches(monkeypatch):
    """On the kernel route ``fps`` asks the stand-in library for the
    plan's cluster occupancy once a plan, raising where it is 0, and hands
    its entry point the cluster and the CTA's threads, one launch a call,
    with [B, m] int32 allocated."""
    from open3d_ml_tpu_torch.ops.cuda import _build
    calls, queries = [], []

    class Library:
        clusters = 7

        def fps_launch(self, *args):
            calls.append(args)
            return 0

        def fps_max_clusters(self, *args):
            queries.append(args)
            return self.clusters

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(cfps, "route", lambda t, family: "kernel")
    monkeypatch.setattr(cfps, "stream", lambda: 0)
    monkeypatch.setattr(cfps, "LAUNCHES", {"fps": 0})
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.
                        nullcontext())
    cfps.max_clusters.cache_clear()
    pts = torch.zeros((2, 16384, 3))
    mask = torch.ones((2, 16384), dtype=torch.bool)
    out = cfps.fps(pts, 4096, points_mask=mask)
    assert out.shape == (2, 4096) and out.dtype == torch.int32
    # points, mask, out, B, N, m, cluster, threads, stream
    assert calls[0][1] == mask.data_ptr() and calls[0][2] == out.data_ptr()
    assert calls[0][3:] == (2, 16384, 4096, 16, 512, 0)
    assert queries == [(16384, 16, 512)]  # N, cluster, threads
    cfps.fps(pts[:, :64].contiguous(), 16)
    assert calls[1][1] is None and calls[1][3:] == (2, 64, 16, 1, 32, 0)
    cfps.fps(pts[:, :64].contiguous(), 16)  # the plan's query is kept
    assert len(queries) == 2 and cfps.LAUNCHES == {"fps": 3}
    Library.clusters = 0
    with pytest.raises(RuntimeError, match="no cluster of 8 CTAs"):
        cfps.fps(pts[:, :8192].contiguous(), 16)
    Library.clusters = -201
    with pytest.raises(RuntimeError, match="cudaError 201"):
        cfps.fps(pts[:, :4000].contiguous(), 16)
    assert len(calls) == 3 and cfps.LAUNCHES == {"fps": 3}
    cfps.max_clusters.cache_clear()


def test_three_nn_and_interpolation_equal_jax():
    """On lattice points the indices equal JAX's and the distances are
    within one ulp; the weights and the interpolation within float32
    rounding (1e-6); a query
    on a coarse point (d = 0) weighs it 1e8 against the others, as JAX
    does."""
    rng = np.random.default_rng(11)
    fine = lattice_cloud(rng, B, 300)
    coarse = np.ascontiguousarray(fine[:, ::4])
    feats = rng.normal(0, 1, (B, 75, 16)).astype(np.float32)
    dist, idx = tint.three_nn(torch.from_numpy(fine),
                              torch.from_numpy(coarse))
    w = tint.inverse_distance_weights(dist)
    out = tint.three_interpolate(torch.from_numpy(feats), idx, w)
    for b in range(B):
        jd, ji = jint.three_nn(jnp.asarray(fine[b]), jnp.asarray(coarse[b]))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        # the same d2, but XLA's CPU square root is not correctly rounded:
        # a few distances lie one ulp from torch's (and numpy's)
        np.testing.assert_array_equal(
            dist[b].numpy(), np.sqrt(dist[b].numpy() ** 2, dtype=np.float32))
        np.testing.assert_allclose(dist[b].numpy(), np.asarray(jd),
                                   rtol=2.5e-7, atol=0)
        jw = jint.inverse_distance_weights(jd)
        np.testing.assert_allclose(w[b].numpy(), np.asarray(jw), rtol=1e-6)
        jo = jint.three_interpolate(jnp.asarray(feats[b]), ji, jw)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(jo),
                                   rtol=1e-6, atol=1e-6)
        one = tint.three_interpolate(torch.from_numpy(feats[b]), idx[b],
                                     w[b])
        np.testing.assert_array_equal(one.numpy(), out[b].numpy())
    on_point = dist[:, ::4, 0] == 0
    assert on_point.all()
    assert (w[:, ::4, 0] > 1 - 1e-6).all()


def test_three_nn_uniform_floats_near_ties():
    rng = np.random.default_rng(12)
    fine = rng.uniform(-25, 25, (300, 3)).astype(np.float32)
    coarse = fine[::4].copy()
    dist, idx = tint.three_nn(torch.from_numpy(fine), torch.from_numpy(coarse))
    jd, ji = jint.three_nn(jnp.asarray(fine), jnp.asarray(coarse))
    # d2 of the formula: a query on a coarse point has d2 within rounding
    # of 0, and its square root far from 0 in relative terms
    np.testing.assert_allclose(dist.numpy() ** 2, np.asarray(jd) ** 2,
                               rtol=0, atol=NEAR)
    differ = (idx.numpy() != np.asarray(ji)).any(1)
    assert differ.mean() < 0.05


# ------------------------------------------------------------- the modules

class _VNet(fnn.Module):
    """A JAX module per sample under ``nn.vmap``, BatchNorm synced over the
    batch axis, as the JAX exact-path net runs it."""
    net: fnn.Module
    training: bool = False

    @fnn.compact
    def __call__(self, args):
        fn = fnn.vmap(lambda mdl, a: mdl(*a, training=self.training),
                      variable_axes={"params": None, "batch_stats": None},
                      split_rngs={"params": False}, in_axes=(0,),
                      out_axes=0, axis_name="batch")
        return fn(self.net, args)


def _module_case(name, seed=20):
    """(JAX module, port module, its batched args as numpy)."""
    pts, feat = _lattice_batch(seed, n=256, c=32)
    rng = np.random.default_rng(seed + 1)
    if name == "transformer":
        return (jpt.Transformer(32, 8, 16), tpt.Transformer(32, 8, 16),
                (pts, feat))
    if name == "down_stride1":
        f6 = rng.normal(0, 1, (B, 256, 6)).astype(np.float32)
        return (jpt.TransitionDown(32, 1, 8), tpt.TransitionDown(6, 32, 1, 8),
                (pts, f6))
    if name == "down_stride4":
        return (jpt.TransitionDown(64, 4, 16),
                tpt.TransitionDown(32, 64, 4, 16), (pts, feat))
    if name == "up_head":
        f64 = rng.normal(0, 1, (B, 256, 64)).astype(np.float32)
        return (jpt.TransitionUp(64), tpt.TransitionUp(64), ((pts, f64),))
    if name == "up_skip":
        coarse = np.ascontiguousarray(pts[:, ::4])
        f64 = rng.normal(0, 1, (B, 64, 64)).astype(np.float32)
        return (jpt.TransitionUp(64, 32), tpt.TransitionUp(64, 32),
                ((pts, feat), (coarse, f64)))
    if name == "bottleneck":
        return (jpt.Bottleneck(32, 8, 8), tpt.Bottleneck(32, 8, 8),
                (pts, feat))
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


MODULES = ["transformer", "down_stride1", "down_stride4", "up_head",
           "up_skip", "bottleneck"]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(name, training):
    """Each module on the JAX module's weights: outputs within ``TOL``; in
    train mode also every BN's updated running statistics (1e-5)."""
    jmod, tmod, args = _module_case(name)
    jargs = _jtree(args)
    variables = jax.tree.map(np.asarray, _VNet(jmod).init(
        jax.random.PRNGKey(0), jargs))
    variables = {"params": variables["params"],
                 "batch_stats": _randomise_stats(variables["batch_stats"],
                                                 np.random.default_rng(2))}
    vnet = _VNet(jmod, training)
    if training:
        want, upd = vnet.apply(variables, jargs, mutable=["batch_stats"])
    else:
        want = vnet.apply(variables, jargs)
    load_jax_variables(tmod, variables).train(training)
    with torch.no_grad():
        got = tmod(*jax.tree.map(torch.from_numpy, args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) <= TOL, name
    if training:
        sd = tmod.state_dict()
        for key, value in _stats_to_port(
                jax.tree.map(np.asarray, upd["batch_stats"]["net"])).items():
            np.testing.assert_allclose(sd[key].numpy(), value, rtol=1e-5,
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("points", ["lattice", "uniform"])
def test_queryandgroup_matches_jax(points):
    """The grouped rows equal JAX's on lattice points; on uniform floats
    the grouped points' distances agree within ``NEAR`` and the sets
    differ only at near-ties."""
    rng = np.random.default_rng(21)
    if points == "lattice":
        pts = lattice_cloud(rng, B, 300)
    else:
        pts = rng.uniform(-25, 25, (B, 300, 3)).astype(np.float32)
    queries = np.ascontiguousarray(pts[:, ::3])
    feat = rng.normal(0, 1, (B, 300, 8)).astype(np.float32)
    got, idx = tpt.queryandgroup(16, torch.from_numpy(pts),
                                 torch.from_numpy(queries),
                                 torch.from_numpy(feat))
    assert got.shape == (B, 100, 16, 11)
    for b in range(B):
        want, jidx = jpt.queryandgroup(16, jnp.asarray(pts[b]),
                                       jnp.asarray(queries[b]),
                                       jnp.asarray(feat[b]))
        want, jidx = np.asarray(want), np.asarray(jidx)
        if points == "lattice":
            np.testing.assert_array_equal(idx[b].numpy(), jidx)
            np.testing.assert_array_equal(got[b].numpy(), want)
            continue
        d_got = (got[b, ..., :3].double() ** 2).sum(-1).numpy()
        d_want = (want[..., :3].astype(np.float64) ** 2).sum(-1)
        np.testing.assert_allclose(np.sort(d_got, 1), np.sort(d_want, 1),
                                   rtol=0, atol=NEAR)
        kth = np.maximum(d_got.max(1), d_want.max(1))
        for row in range(100):
            for i in set(idx[b, row].tolist()) ^ set(jidx[row].tolist()):
                d = ((pts[b, i].astype(np.float64) - queries[b, row]) ** 2
                     ).sum()
                assert abs(d - kth[row]) <= NEAR


def test_queryandgroup_refuses_other_methods():
    z = torch.zeros((1, 8, 3))
    for method in ("approx", "window"):
        with pytest.raises(NotImplementedError, match=method):
            tpt.queryandgroup(4, z, z, z, method=method)


# -------------------------------------------------------------- the net

@pytest.fixture(scope="module")
def small():
    """A lattice batch, the JAX net's variables (BN statistics drawn) and
    its eval-mode logits."""
    pts, _ = _lattice_batch(30)
    feat = np.random.default_rng(31).uniform(0, 1, (B, N, 3)).astype(
        np.float32)
    labels = np.random.default_rng(32).integers(0, 13, (B, N)).astype(
        np.int32)
    batch = {"point": pts, "feat": feat, "label": labels}
    jm = jpt.PointTransformer(**SMALL)
    net = jm.get_net()
    inputs = _jtree({"point": pts, "feat": feat})
    variables = jax.tree.map(np.asarray, jax.jit(lambda b: net.init(
        {"params": jax.random.PRNGKey(0)}, b, training=False))(inputs))
    variables = {"params": variables["params"],
                 "batch_stats": _randomise_stats(variables["batch_stats"],
                                                 np.random.default_rng(33))}
    logits = np.asarray(jax.jit(lambda v, b: net.apply(
        v, b, training=False))(variables, inputs))
    return {"batch": batch, "variables": variables, "logits": logits,
            "jax_model": jm, "jax_net": net}


def _port_net(small, training=False):
    net = PointTransformer(**SMALL).get_net()
    return load_jax_variables(net, small["variables"]).train(training)


def test_net_eval_matches_jax(small):
    net = _port_net(small)
    batch = small["batch"]
    with torch.no_grad():
        got = net({"point": torch.from_numpy(batch["point"]),
                   "feat": torch.from_numpy(batch["feat"])}).numpy()
    assert got.shape == (B, N, 13)
    assert _rel(got, small["logits"]) <= TOL


class _Cfg(dict):
    """A config as both packages' ``get_optimizer`` read it."""

    def __getattr__(self, key):
        return self[key]


def _dataset_cfg():
    class Dataset:
        cfg = Config({"class_weights": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8,
                                        9]})
    return Dataset()


def _jax_train_step(small, dtype):
    """The JAX net's train step on ``small`` in ``dtype``: (logits, loss,
    gradients, BN statistics, parameters after one SGD step of the shipped
    recipe, lr 0.02 and momentum 0.9)."""
    batch, variables = small["batch"], small["variables"]
    jm, jnet = small["jax_model"], small["jax_net"]
    cast = lambda t: jax.tree.map(lambda v: jnp.asarray(v, dtype), t)
    params, stats = cast(variables["params"]), cast(variables["batch_stats"])
    jbatch = dict(cast({k: batch[k] for k in ("point", "feat")}),
                  label=jnp.asarray(batch["label"]))
    jloss = JaxLoss(None, jm, _dataset_cfg())

    def loss_fn(params):
        out, upd = jnet.apply({"params": params, "batch_stats": stats},
                              jbatch, training=True, mutable=["batch_stats"])
        loss, _, _ = jm.get_loss(jloss, out, jbatch)
        return loss, (out, upd["batch_stats"])

    (loss, (out, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tx, _ = jm.get_optimizer(_Cfg(optimizer={"lr": 0.02, "momentum": 0.9,
                                             "weight_decay": 0.0001},
                                  max_epoch=512))
    upd, _ = tx.update(grads, tx.init(params), params)
    return jax.tree.map(np.asarray, (out, loss, grads, new_stats,
                                     optax.apply_updates(params, upd)))


def test_net_train_step_matches_jax(small):
    """One train step on the JAX net's variables, both packages in float64
    (the searches still run on float32 coordinates, exact on the lattice):
    the train-mode logits, the loss, every gradient, every BN statistic and
    the parameters after one SGD step against ``optax``, each within
    ``F64_TOL`` (relative L2 of each tensor, ``_close``). In float32 the
    train-mode logits are within 2e-4: at N = 512 the deepest levels hold
    8 and 2 points, and batch statistics over so few rows amplify
    rounding; each package's float32 logits lie
    ~5.5e-5 from the float64 ones, and ~8e-5 from each other."""
    out, loss, grads, stats, params = _x64(_jax_train_step, small)
    tm = PointTransformer(**SMALL)
    net = _port_net(small, training=True).double()
    batch = small["batch"]
    cfg = _Cfg(optimizer={"lr": 0.02, "momentum": 0.9,
                          "weight_decay": 0.0001}, max_epoch=512)
    optimizer, scheduler = tm.get_optimizer(cfg, net)
    got = net({k: torch.from_numpy(batch[k]).double()
               for k in ("point", "feat")})
    got_loss, _, _ = tm.get_loss(SemSegLoss(None, tm, _dataset_cfg()), got,
                                 {"label": torch.from_numpy(batch["label"])})
    assert got.dtype == torch.float64
    assert _rel(got.detach().numpy(), out) <= F64_TOL
    assert abs(got_loss.item() - float(loss)) <= F64_TOL * abs(float(loss))
    optimizer.zero_grad()
    got_loss.backward()
    want_grads = dict(_grads_by_port_name(grads))
    named = dict(net.named_parameters())
    assert set(named) == set(want_grads)
    for key, p in named.items():
        _close(p.grad.numpy(), want_grads[key], key)
    sd = net.state_dict()
    for key, value in _stats_to_port(stats["net"]).items():
        _close(sd[key].numpy(), value, key)
    optimizer.step()
    scheduler.step()
    back = dict(_flat(state_dict_to_jax(net.state_dict())["params"]))
    for key, value in _flat(params):
        _close(back[key], value, key)

    net32 = _port_net(small, training=True)
    with torch.no_grad():
        got32 = net32({k: torch.from_numpy(batch[k])
                       for k in ("point", "feat")}).numpy()
    want32, _ = jax.jit(lambda v, b: small["jax_net"].apply(
        v, b, training=True, mutable=["batch_stats"]))(
            small["variables"], _jtree({k: batch[k] for k in ("point",
                                                              "feat")}))
    assert _rel(got32, want32) <= 2e-4
    assert _rel(got32, out) <= 1e-4


def _close(got, want, key):
    """A float64 tensor of the step within ``F64_TOL`` relative L2, or
    1e-12 absolute: a bias right before a train-mode BN has a gradient of 0
    but for rounding (~1e-17)."""
    diff = np.linalg.norm(got - want)
    assert diff <= F64_TOL * np.linalg.norm(want) + 1e-12, key


def _x64(fn, *args):
    with jax.enable_x64(True):
        return fn(*args, jnp.float64)


def _grads_by_port_name(grads):
    """JAX gradients keyed by the port's parameter names (Dense kernels
    transposed)."""
    for key, value in _flat(jax.tree.map(np.asarray, grads["net"])):
        *path, leaf = key.split(".")
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
        yield ".".join(path + [name]), (value.T if leaf == "kernel"
                                        else value)


@pytest.mark.slow
def test_full_width_eval_matches_jax():
    """The shipped net (blocks [2, 3, 4, 6, 3]) at the shipped 16,384
    points, B = 2, on the JAX net's variables (BN statistics drawn), lattice
    points: eval logits within ``TOL`` (a few minutes on the CPU)."""
    cfg = dict(blocks=[2, 3, 4, 6, 3], num_points=16384)
    pts, _ = _lattice_batch(60, n=16384)
    feat = np.random.default_rng(61).uniform(0, 1, (B, 16384, 3)).astype(
        np.float32)
    inputs = _jtree({"point": pts, "feat": feat})
    net = jpt.PointTransformer(**cfg).get_net()
    variables = jax.tree.map(np.asarray, jax.jit(lambda b: net.init(
        {"params": jax.random.PRNGKey(1)}, b, training=False))(inputs))
    variables = {"params": variables["params"],
                 "batch_stats": _randomise_stats(variables["batch_stats"],
                                                 np.random.default_rng(62))}
    want = np.asarray(jax.jit(lambda v, b: net.apply(v, b, training=False))(
        variables, inputs))
    tnet = load_jax_variables(PointTransformer(**cfg).get_net(),
                              variables).eval()
    with torch.no_grad():
        got = tnet({"point": torch.from_numpy(pts),
                    "feat": torch.from_numpy(feat)}).numpy()
    assert _rel(got, want) <= TOL


def test_convert_round_trip(small):
    """JAX -> port -> JAX on PointTransformer's tree: every leaf back bit
    for bit; Dense kernels transposed."""
    variables = small["variables"]
    sd = _port_net(small).state_dict()
    params = variables["params"]["net"]
    np.testing.assert_array_equal(
        sd["dec1_block1.transformer2.linear_w0.weight"].numpy(),
        params["dec1_block1"]["transformer2"]["linear_w0"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["enc1_down.bn.running_var"].numpy(),
        variables["batch_stats"]["net"]["enc1_down"]["bn"]["var"])
    back = state_dict_to_jax(sd)
    flat = jax.tree_util.tree_leaves_with_path
    ref, got = dict(flat(variables)), dict(flat(back))
    assert set(got) == set(ref)
    for path, value in ref.items():
        np.testing.assert_array_equal(got[path], value)


def _forward_launches(blocks):
    """({"knn_exact": ..., "fps": ...} calls of one forward at ``blocks``,
    {k: knn_exact calls at k}): per stage past the first an FPS and a
    grouping search at its nsample, per Bottleneck (blocks[i] - 1 in the
    encoder, one in the decoder) a self-search at its nsample, and per
    skip TransitionUp a search at k = 3."""
    by_k = {}
    for i in range(5):
        calls = blocks[i] + (1 if tpt.STRIDE[i] != 1 else 0)
        by_k[tpt.NSAMPLE[i]] = by_k.get(tpt.NSAMPLE[i], 0) + calls
    by_k[3] = 4
    return ({"knn_exact": sum(by_k.values()),
             "fps": sum(s != 1 for s in tpt.STRIDE)}, by_k)


def test_forward_launches_counted(monkeypatch):
    """At the shipped blocks a forward calls ``knn_exact`` 26 times (2 at
    k = 8, 20 at 16, 4 at 3) and ``fps`` 4 times, as ``_forward_launches``
    counts; counted on the CPU at N = 4,096 (levels of 4,096 to 16 points,
    none short of its k)."""
    blocks = [2, 3, 4, 6, 3]
    total, by_k = _forward_launches(blocks)
    assert total == {"knn_exact": 26, "fps": 4}
    assert by_k == {8: 2, 16: 20, 3: 4}
    seen = {"k": [], "fps": 0}
    real_knn, real_fps = ck.knn_exact, cfps.fps

    def knn(points, queries, k, **kw):
        seen["k"].append(k)
        return real_knn(points, queries, k, **kw)

    def fps(points, m, **kw):
        seen["fps"] += 1
        return real_fps(points, m, **kw)

    from open3d_ml_tpu_torch.ops import neighbors, sampling
    monkeypatch.setattr(neighbors, "knn_exact", knn)
    monkeypatch.setattr(sampling, "fps", fps)
    rng = np.random.default_rng(40)
    net = PointTransformer(blocks=blocks).get_net().eval()
    with torch.no_grad():
        net({"point": torch.from_numpy(rng.uniform(
            -5, 5, (1, 4096, 3)).astype(np.float32)),
            "feat": torch.zeros((1, 4096, 3))})
    counts = {k: seen["k"].count(k) for k in set(seen["k"])}
    assert counts == by_k and seen["fps"] == 4


def test_fused_and_other_methods_raise():
    """The fused path builds (``tests/test_torch_pointtransformer_fused.py``
    holds it to the JAX net); the "approx" and "window" searches are not
    ported and raise."""
    net = PointTransformer(knn_method="fused").get_net()
    assert net.knn_method == "fused" and net.cdt == torch.bfloat16
    with pytest.raises(NotImplementedError, match="approx"):
        PointTransformer(knn_method="approx").get_net()
    with pytest.raises(NotImplementedError, match="window"):
        PointTransformer(eval_knn_method="window").get_eval_net()


# -------------------------------------------------- optimizer and schedule

def _lrs(tm, cfg, updates):
    net = torch.nn.Linear(1, 1)
    optimizer, scheduler = tm.get_optimizer(cfg, net)
    out = []
    for _ in range(updates):
        out.append(optimizer.param_groups[0]["lr"])
        optimizer.step()
        scheduler.step()
    return out, optimizer


@pytest.mark.parametrize("steps", [None, 7])
def test_schedule_boundaries_equal_optax(steps):
    """The rate of update t (counted from 0) equals optax's schedule at
    count t at both boundaries: updates b - 1, b and b + 1. Without
    ``steps_per_epoch`` (a config read outside ``run_train``) the
    boundaries are updates int(0.6 * max_epoch) and int(0.8 * max_epoch);
    ``run_train`` sets steps_per_epoch, and they are epochs of updates."""
    cfg = _Cfg(optimizer={"lr": 0.02, "momentum": 0.9}, max_epoch=20)
    if steps:
        cfg["steps_per_epoch"] = steps
    _, schedule = jpt.PointTransformer().get_optimizer(cfg)
    spe = steps or 1
    bounds = [12 * spe, 16 * spe]
    lrs, _ = _lrs(PointTransformer(), cfg, bounds[1] + 2)
    for b in bounds:
        for t in (b - 1, b, b + 1):
            assert lrs[t] == pytest.approx(float(schedule(t)), rel=1e-6), t
    assert lrs[bounds[0] - 1] == 0.02
    assert lrs[bounds[0]] == pytest.approx(0.002)
    assert lrs[bounds[1]] == pytest.approx(0.0002)


def test_pipeline_sets_steps_per_epoch_in_both_packages():
    """Both ``run_train``s set ``steps_per_epoch`` to the train split's
    batches before ``get_optimizer``, so through the pipeline the shipped
    rate falls after epochs 307 and 409 of updates, not after updates 307
    and 409."""
    import inspect
    from open3d_ml_tpu.pipelines import semantic_segmentation as jss
    from open3d_ml_tpu_torch.pipelines import semantic_segmentation as tss
    jsrc = inspect.getsource(jss.SemanticSegmentation.run_train)
    tsrc = inspect.getsource(tss.SemanticSegmentation._train_epochs)
    for src in (jsrc, tsrc):
        at = src.index("steps_per_epoch\"] = ")
        assert at < src.index("get_optimizer(")
    cfg = _Cfg(optimizer={"lr": 0.02}, max_epoch=512, steps_per_epoch=3)
    _, schedule = jpt.PointTransformer().get_optimizer(cfg)
    assert float(schedule(307 * 3 - 1)) == pytest.approx(0.02)
    assert float(schedule(307 * 3)) == pytest.approx(0.002)


def test_weight_decay_is_not_read_in_either_package():
    """The YAML's ``optimizer.weight_decay`` changes no update in the JAX
    package (a JAX fault, mirrored): its SGD equals plain
    ``optax.sgd(0.02, 0.9)``, and the port's SGD has weight_decay 0."""
    params = {"w": jnp.asarray(np.linspace(-1, 1, 5, dtype=np.float32))}
    grads = {"w": jnp.asarray(np.linspace(2, 3, 5, dtype=np.float32))}
    cfg = _Cfg(optimizer={"lr": 0.02, "momentum": 0.9,
                          "weight_decay": 0.5}, max_epoch=512)
    tx, _ = jpt.PointTransformer().get_optimizer(cfg)
    plain = optax.sgd(0.02, momentum=0.9)
    got, _ = tx.update(grads, tx.init(params), params)
    want, _ = plain.update(grads, plain.init(params), params)
    np.testing.assert_array_equal(np.asarray(got["w"]),
                                  np.asarray(want["w"]))
    _, optimizer = _lrs(PointTransformer(), cfg, 1)
    assert isinstance(optimizer, torch.optim.SGD)
    group = optimizer.param_groups[0]
    assert (group["weight_decay"], group["momentum"], group["dampening"],
            group["nesterov"]) == (0, 0.9, 0, False)


def test_adam_option_equals_optax():
    cfg = _Cfg(optimizer={"lr": 0.01, "name": "adam"}, max_epoch=10)
    tx, _ = jpt.PointTransformer().get_optimizer(cfg)
    w0 = np.linspace(-1, 1, 6).astype(np.float32)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    net = torch.nn.Linear(6, 1, bias=False)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(w0)[None])
    optimizer, scheduler = PointTransformer().get_optimizer(cfg, net)
    assert isinstance(optimizer, torch.optim.Adam)
    rng = np.random.default_rng(41)
    for _ in range(8):  # across the boundaries at updates 6 and 8
        g = rng.normal(0, 1, 6).astype(np.float32)
        upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
        net.weight.grad = torch.from_numpy(g)[None].clone()
        optimizer.step()
        scheduler.step()
    np.testing.assert_allclose(net.weight[0].detach().numpy(),
                               np.asarray(params["w"]), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ host side

def _room(seed, n=6000):
    rng = np.random.default_rng(seed)
    return {"point": rng.uniform(0, 4, (n, 3)).astype(np.float32),
            "feat": rng.integers(0, 256, (n, 3)).astype(np.float32),
            "label": rng.integers(0, 13, n).astype(np.int32)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hue_saturation_and_augment_list_equal_jax(seed):
    """``HueSaturationTranslation`` alone, and the shipped augmentation
    list (ChromaticAutoContrast with its blend factor drawn), bit-equal to
    the JAX package's on one seed."""
    room = _room(seed, 800)
    cfg = {"HueSaturationTranslation": {"hue_max": 0.5,
                                        "saturation_max": 0.2}}
    for augment in (cfg, PT_AUGMENT.to_dict()):
        got = SemsegAugmentation(augment).augment(
            room["point"].copy(), room["feat"].copy(), room["label"].copy(),
            augment, seed=seed)
        want = JaxAugment(augment).augment(
            room["point"].copy(), room["feat"].copy(), room["label"].copy(),
            augment, seed=seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    hsv = SemsegAugmentation._rgb_to_hsv(room["feat"])
    np.testing.assert_array_equal(hsv, JaxAugment._rgb_to_hsv(room["feat"]))
    np.testing.assert_array_equal(SemsegAugmentation._hsv_to_rgb(hsv),
                                  JaxAugment._hsv_to_rgb(hsv))


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("n_points", [1024, 8192])
def test_preprocess_transform_bit_equal(split, n_points):
    """``preprocess`` (grid subsampling at 4 cm, the KD-tree, ``proj_inds``
    on the test split) and ``transform`` (the shipped augmentation on the
    training split; the crop, with a random seed point on the training
    split, or the padding) bit-equal to JAX, over two draws of models
    seeded alike."""
    room = _room(5)
    kw = dict(num_points=n_points, augment=PT_AUGMENT.to_dict(), seed=7)
    jm, tm = jpt.PointTransformer(**kw), PointTransformer(**kw)
    attr = {"split": split}
    jp, tp = jm.preprocess(room, attr), tm.preprocess(room, attr)
    assert set(jp) == set(tp)
    for key in jp:
        if key != "search_tree":
            np.testing.assert_array_equal(tp[key], jp[key], err_msg=key)
    assert (n_points < len(tp["point"])) == (n_points == 1024)
    for _ in range(2):
        jt, tt = jm.transform(jp, attr), tm.transform(tp, attr)
        assert set(jt) == set(tt)
        for key in jt:
            assert tt[key].dtype == jt[key].dtype
            np.testing.assert_array_equal(tt[key], jt[key], err_msg=key)


def test_loss_and_update_probs_equal_jax():
    rng = np.random.default_rng(42)
    logits = rng.normal(0, 3, (2, 100, 13)).astype(np.float32)
    labels = rng.integers(0, 13, (2, 100)).astype(np.int32)
    jm, tm = jpt.PointTransformer(), PointTransformer()
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


def test_defaults_and_yaml_equal_jax():
    """The port's defaults are the JAX class's; the port's YAML parses to
    the JAX file's values; the registry names the class."""
    assert PointTransformer().cfg.to_dict() == \
        jpt.PointTransformer().cfg.to_dict()
    assert MODEL.get("PointTransformer") is PointTransformer
    jcfg = Config.load_from_file(
        REPO / "open3d_ml_tpu/configs/pointtransformer_s3dis.yml")
    tcfg = Config.load_from_file(PT_YML)
    for section in ("dataset", "model", "pipeline"):
        assert tcfg[section].to_dict() == jcfg[section].to_dict(), section


# ------------------------------------------------- the command line, S3DIS

def write_s3dis(root, rooms, n=3000, seed=0):
    """S3DIS rooms as ``original_pkl/<name>.pkl`` files: (an [n, 7] array
    of x, y, z, r, g, b, label, no boxes)."""
    rng = np.random.default_rng(seed)
    (root / "original_pkl").mkdir(parents=True)
    for name in rooms:
        pc = np.concatenate([rng.uniform(0, 3, (n, 3)),
                             rng.integers(0, 256, (n, 3)),
                             rng.integers(0, 13, (n, 1))], 1)
        with open(root / "original_pkl" / f"{name}.pkl", "wb") as f:
            pickle.dump((pc.astype(np.float32), []), f)


PT_SMALL = ["--model.num_points", "512", "--pipeline.num_workers", "0",
            "--pipeline.batch_size", "2", "--pipeline.val_batch_size", "1",
            "--pipeline.max_epoch", "0"]
ROOMS = ("Area_1_office_1", "Area_2_office_1", "Area_5_office_1")


def test_cli_trains_on_s3dis_rooms(tmp_path, monkeypatch):
    """``--split train`` from the port's YAML on an S3DIS tree: one epoch of
    one step of 2 and one validation step, at 512-point patches; the net
    is the YAML's at blocks [1, 1, 1, 1, 1] (the YAML's blocks are a list,
    which the command line cannot override)."""
    write_s3dis(tmp_path / "s3dis", ROOMS)
    real = tpt.PointTransformer.get_net

    def small_net(self, knn_method=None):
        self.cfg["blocks"] = [1, 1, 1, 1, 1]
        return real(self, knn_method)

    monkeypatch.setattr(tpt.PointTransformer, "get_net", small_net)
    losses = []
    real_step = SemanticSegmentation._train_step

    def step(self, inputs, loss_fn):
        loss, cm = real_step(self, inputs, loss_fn)
        losses.append(float(loss))
        return loss, cm

    monkeypatch.setattr(SemanticSegmentation, "_train_step", step)
    run_pipeline.main(["-c", str(PT_YML), "--device", "cpu",
                       "--dataset.dataset_path", str(tmp_path / "s3dis"),
                       "--main_log_dir", str(tmp_path / "logs"),
                       "--split", "train", *PT_SMALL])
    ckpt = (tmp_path / "logs" / "PointTransformer_S3DIS_torch" /
            "checkpoint" / "ckpt_00000.pth")
    assert ckpt.exists()
    assert len(losses) == 1 and np.isfinite(losses).all()


@pytest.mark.parametrize("split", ["test", "valid"])
def test_cli_refuses_the_patch_loop(split, tmp_path):
    """``--split test`` (and valid, which runs ``run_test`` for this
    pipeline) raise before the possibility-map loop starts, which would
    never end."""
    write_s3dis(tmp_path / "s3dis", ROOMS[-1:], n=600)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        run_pipeline.main(["-c", str(PT_YML), "--device", "cpu",
                           "--dataset.dataset_path", str(tmp_path / "s3dis"),
                           "--main_log_dir", str(tmp_path / "logs"),
                           "--split", split, *PT_SMALL])


def test_test_loop_never_advances_in_either_package(tmp_path):
    """The JAX fault the refusal mirrors: PointTransformer's ``transform``
    never calls the sampler, so a batch of the test split leaves every
    cloud's ``min_possibilities`` as it was, in the JAX package and in the
    port, and the loop (which ends when they pass 0.5) never ends."""
    write_s3dis(tmp_path / "s3dis", ROOMS[-1:], n=600)
    for dataset, model, loader in (
            (JaxS3DIS, jpt.PointTransformer, JaxLoader),
            (S3DIS, PointTransformer, PointCloudDataloader)):
        split = dataset(dataset_path=str(tmp_path / "s3dis"),
                        test_area_idx=5).get_split("test")
        m = model(num_points=256, seed=0)
        data = loader(split, preprocess=m.preprocess, transform=m.transform)
        sampler = split.sampler
        sampler.initialize_with_dataloader(data)
        m.trans_point_sampler = sampler.get_point_sampler()
        before = list(sampler.min_possibilities)
        cid = next(sampler.get_cloud_sampler())
        out = data[cid]["data"]
        assert out["point"].shape == (256, 3)
        assert sampler.min_possibilities == before
        assert max(before) < 0.5


def test_chip_smoke_pt_constants():
    """``chip_smoke.py`` drives the YAML's model section and pipeline batch
    sizes without reading the YAML, and expects ``_forward_launches`` of
    them."""
    cfg = Config.load_from_file(PT_YML)
    model = cfg.model.to_dict()
    assert chip_smoke.POINTTRANSFORMER_S3DIS == {
        k: model[k] for k in chip_smoke.POINTTRANSFORMER_S3DIS}
    assert set(chip_smoke.POINTTRANSFORMER_S3DIS) >= {
        "blocks", "num_points", "voxel_size", "in_channels", "num_classes"}
    assert chip_smoke.PT_TRAIN_BATCH == (cfg.pipeline.batch_size,
                                         cfg.pipeline.val_batch_size)
    assert chip_smoke.PT_FORWARD_LAUNCHES == _forward_launches(
        model["blocks"])[0]
