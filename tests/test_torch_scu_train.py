"""SparseConvUnet training in the port (``open3d_ml_tpu_torch``) against the
JAX package, on the CPU.

The rulebook (``stencil_match_plain``) against ``stencil_match_pallas``'s
XLA twin and, at a tiny shape, its Pallas kernel in Mosaic interpret mode;
the stencil convolution's gradient (``StencilConv``) against ``jax.grad`` of
``stencil_conv_pallas``; ``MaskedBatchNorm`` in train mode against flax;
one whole training step against ``jax.value_and_grad`` of the JAX net on
the same variables; the ScanNet augmentations and ``Custom3D`` bit for bit;
the pipeline's seeded weights; and ``run_train`` with a resume. The JAX
side runs its stencil kernels through their XLA twins (``interpret=True``
on the CPU), which take no bf16 rounding in the gathers but round the
products' inputs, as the port does.
"""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open3d_ml_tpu.datasets import Custom3D as JaxCustom3D
from open3d_ml_tpu.datasets.augment import SemsegAugmentation as JaxAugment
from open3d_ml_tpu.models import SparseConvUnet as JaxSparseConvUnet
from open3d_ml_tpu.models.common import MaskedBatchNorm as JaxMaskedBN
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxSemSegLoss
from open3d_ml_tpu.ops.pallas import stencil as ps
from open3d_ml_tpu.utils import Config as JaxConfig
from open3d_ml_tpu_torch import DATASET
from open3d_ml_tpu_torch.datasets import Custom3D, SyntheticShapes
from open3d_ml_tpu_torch.datasets.augment import SemsegAugmentation
from open3d_ml_tpu_torch.models import RandLANet, SparseConvUnet
from open3d_ml_tpu_torch.models import sparseconvunet as tscu
from open3d_ml_tpu_torch.models.common import MaskedBatchNorm
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.ops.cuda import stencil as cs
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
from open3d_ml_tpu_torch.utils import Config, load_jax_variables
from open3d_ml_tpu_torch.utils.convert_jax import jax_to_state_dict

from test_torch_scu import SMALL, _randomise_stats, surface_batch
from test_torch_sparse import _t, stencil_case
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CLASS_COUNTS = [900, 150, 420, 77, 260]
# the parity tests' net: test_torch_scu's small config, label -1 ignored
STEP = dict(SMALL, ignored_label_inds=[-1])


def _rel_l2(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


# ----------------------------------------------------------------- rulebook

def _match_args(case):
    keys = cs._pad_keys(_t(case["keys"]), case["seg"])
    return keys, _t(case["qkeys"]), _t(case["seg_ids"])


@pytest.mark.parametrize("form, qblock, num_segs", [
    ("sub", 32, 16), ("sub", 32, 2), ("down", 32, 16), ("down", 32, 1),
    ("up", 128, 16), ("up", 128, 1), ("sub", 32, 72)])
def test_stencil_match_plain_matches_xla_twin(form, qblock, num_segs):
    """rel and found equal everywhere, the misses' 0x7F000000 and the
    ragged last block included; the S = 1 or 2 tables overflow, so some
    taps whose site exists miss on both sides; S = 72 makes a table of
    1,152 rows, past the kernels' former limit of 1,024."""
    rng = np.random.default_rng(qblock + num_segs)
    big = num_segs > 16  # 1,400 sites: enough segments for S = 72
    case = stencil_case(form, 16, qblock, num_segs, 4, 4, rng,
                        cap=1400 if big else 250, box=14 if big else 12)
    keys, qkeys, seg_ids = _match_args(case)
    assert not big or seg_ids.shape[-1] == num_segs
    rel, found = cs.stencil_match_plain(keys, qkeys, seg_ids, seg=16,
                                        qblock=qblock)
    ref_rel, ref_found = ps.stencil_match_pallas(
        jnp.asarray(keys.numpy()), jnp.asarray(case["qkeys"]),
        jnp.asarray(case["seg_ids"]), seg=16, qblock=qblock, interpret=True)
    assert rel.dtype == torch.int32 and found.dtype == torch.bool
    np.testing.assert_array_equal(found.numpy(), np.asarray(ref_found))
    np.testing.assert_array_equal(rel.numpy(), np.asarray(ref_rel))
    assert found.any() and (rel[~found] == cs.BIGPOS).all()
    if num_segs <= 2:
        assert case["overflow"] > 0
        exist = np.isin(case["qkeys"], case["keys"]) & (case["qkeys"] >= 0)
        assert (exist & ~found.numpy()).any()


def test_stencil_match_plain_matches_mosaic_kernel(monkeypatch):
    """The Pallas TPU kernel itself, run by the Mosaic interpreter at a
    tiny shape with tables that overflow, against the plain version."""
    monkeypatch.setattr(ps, "_INTERPRET_KERNEL", True)
    jax.clear_caches()
    rng = np.random.default_rng(7)
    case = stencil_case("sub", 16, 8, 2, 4, 8, rng, b=1, cap=64, box=8,
                        seed=7)
    keys, qkeys, seg_ids = _match_args(case)
    rel, found = cs.stencil_match_plain(keys, qkeys, seg_ids, seg=16,
                                        qblock=8)
    ref_rel, ref_found = ps.stencil_match_pallas(
        jnp.asarray(keys.numpy()), jnp.asarray(case["qkeys"]),
        jnp.asarray(case["seg_ids"]), seg=16, qblock=8, interpret=True)
    np.testing.assert_array_equal(found.numpy(), np.asarray(ref_found))
    np.testing.assert_array_equal(rel.numpy(), np.asarray(ref_rel))


def test_stencil_match_least_position_of_a_repeated_segment():
    """A segment twice in a table: its keys match at the first slot."""
    keys = torch.arange(32, dtype=torch.int32)[None]  # 2 segments of 16
    seg_ids = torch.tensor([[[1, 1]]], dtype=torch.int32)
    qkeys = torch.tensor([[[17, 3, 31, -1]]], dtype=torch.int32)
    rel, found = cs.stencil_match(keys, qkeys, seg_ids, seg=16, qblock=32)
    assert rel.tolist() == [[[1, cs.BIGPOS, 15, cs.BIGPOS]]]
    assert found.tolist() == [[[True, False, True, False]]]


def _sorted_table_lookup(keys, qkeys, seg_ids, seg, qblock):
    """The stencil kernels' lookup (csrc/stencil_taps.cuh) in numpy: each
    block's slots but those that repeat the id of a lower slot, ordered by
    id, their keys copied in that order (one sorted array where the keys
    of a batch row ascend), one left search per tap, and the least table
    position among equal keys, which later sorted segments can hold only
    at their row 0."""
    b, q, k = qkeys.shape
    nqb = seg_ids.shape[1]
    rel = np.full((b, q, k), cs.BIGPOS, np.int32)
    for bi in range(b):
        for blk in range(nqb):
            ids, first = np.unique(seg_ids[bi, blk], return_index=True)
            order, s = first, len(first)  # the least slot of each id
            table = keys[bi][(ids[:, None] * seg + np.arange(seg)).ravel()]
            assert (np.diff(table.astype(np.int64)) >= 0).all()
            taps = qkeys[bi, blk * qblock:(blk + 1) * qblock]
            pos = np.searchsorted(table, taps, side="left")
            hit = ((taps >= 0) & (pos < table.size) &
                   (table[np.minimum(pos, table.size - 1)] == taps))
            r = np.minimum(pos // seg, s - 1)
            best = order[r] * seg + pos % seg
            for r2 in range(1, s):
                later = np.minimum(r + r2, s - 1)
                same = (r + r2 < s) & (table[later * seg] == taps)
                best = np.where(same, np.minimum(best, order[later] * seg),
                                best)
            rel[bi, blk * qblock:(blk + 1) * qblock] = np.where(hit, best,
                                                                cs.BIGPOS)
    return rel, rel != cs.BIGPOS


@pytest.mark.parametrize("form, qblock, num_segs", [
    ("sub", 32, 16), ("down", 32, 4), ("up", 128, 16)])
def test_sorted_table_lookup_matches_the_plain_rulebook(form, qblock,
                                                        num_segs):
    """The kernels' design against ``stencil_match_plain`` where the keys
    ascend, as on the path: with ids repeated in a table (the least slot
    wins), all-pad segments in it, and tap keys equal to the pad key
    INT32_MAX (the least position among the pads of several segments)."""
    rng = np.random.default_rng(num_segs + qblock)
    case = stencil_case(form, 16, qblock, num_segs, 4, 4, rng, cap=250)
    keys, qkeys, seg_ids = _match_args(case)
    keys = torch.nn.functional.pad(keys, (0, 16), value=cs._I32MAX)
    seg_ids = seg_ids.clone()
    seg_ids[:, ::3, -1] = seg_ids[:, ::3, 0]  # a repeated id
    seg_ids[:, 1::3, 0] = keys.shape[1] // 16 - 1  # an all-pad segment
    qkeys = qkeys.clone()
    qkeys[:, ::7, 0] = cs._I32MAX
    rel, found = cs.stencil_match_plain(keys, qkeys, seg_ids, seg=16,
                                        qblock=qblock)
    got_rel, got_found = _sorted_table_lookup(
        keys.numpy(), qkeys.numpy(), seg_ids.numpy(), 16, qblock)
    np.testing.assert_array_equal(got_found, found.numpy())
    np.testing.assert_array_equal(got_rel, rel.numpy())
    assert (found & (qkeys == cs._I32MAX)).any()


def test_stencil_match_wrapper_passes_its_shared_memory(monkeypatch):
    """On the kernel route ``stencil_match`` hands its entry point the
    shared memory of its sorted table (``match_shared``), also for a table
    past the former 1,024-row limit, and counts one launch."""
    from test_torch_sparse import _kernel_route
    calls = _kernel_route(monkeypatch)
    rng = np.random.default_rng(4)
    case = stencil_case("sub", 16, 32, 72, 4, 4, rng, cap=1400, box=14)
    keys, qkeys, seg_ids = _match_args(case)
    cs.stencil_match(keys, qkeys, seg_ids, seg=16, qblock=32)
    kind, args = calls[-1]
    # ..., S, seg, qblock, shared, stream
    assert kind == "match" and args[-5:-1] == (72, 16, 32,
                                               cs.match_shared(72, 16))
    assert cs.LAUNCHES == {"stencil_conv": 0, "stencil_match": 1}


@pytest.mark.parametrize("bad", ["pad", "dtype", "tables"])
def test_stencil_match_wrapper_rejects(bad):
    rng = np.random.default_rng(3)
    case = stencil_case("sub", 16, 32, 4, 4, 4, rng)
    keys, qkeys, seg_ids = _match_args(case)
    if bad == "pad":
        keys = keys[:, :-3].contiguous()
    elif bad == "dtype":
        qkeys = qkeys.long()
    else:
        seg_ids = seg_ids[:, :-1].contiguous()
    with pytest.raises(ValueError):
        cs.stencil_match(keys, qkeys, seg_ids, seg=16, qblock=32)


# ------------------------------------------------------ the conv's gradient

def _port_grads(case, cot, dtype, route=cs.stencil_conv):
    v = _t(case["values"]).requires_grad_()
    w = _t(case["w"]).requires_grad_()
    out = route(v, _t(case["keys"]), _t(case["qkeys"]), _t(case["seg_ids"]),
                w, seg=case["seg"], qblock=case["qblock"],
                compute_dtype=dtype)
    (out * _t(cot)).sum().backward()
    return out, v.grad.numpy(), w.grad.numpy()


def _jax_grads(case, cot, dtype):
    def loss(v, w):
        out = ps.stencil_conv_pallas(
            v, jnp.asarray(case["keys"]), jnp.asarray(case["qkeys"]),
            jnp.asarray(case["seg_ids"]), w, case["seg"], case["qblock"],
            dtype, True)
        return jnp.sum(out * jnp.asarray(cot))

    dv, dw = jax.grad(loss, (0, 1))(jnp.asarray(case["values"]),
                                    jnp.asarray(case["w"]))
    return np.asarray(dv), np.asarray(dw)


def _grad_case(form, qblock, num_segs, seed):
    rng = np.random.default_rng(seed)
    case = stencil_case(form, 16, qblock, num_segs, 12, 10, rng, cap=250)
    cot = rng.standard_normal(case["qkeys"].shape[:2] + (10,)).astype(
        np.float32)
    return case, cot


@pytest.mark.parametrize("form, qblock, num_segs", [
    ("sub", 32, 16), ("sub", 32, 2), ("down", 32, 1), ("up", 128, 16)])
def test_stencil_conv_grads_match_jax_float32(form, qblock, num_segs):
    """dvalues and dw against ``jax.grad`` through the custom VJP, float32:
    the same products summed in other orders, within 1e-5 of each
    gradient's largest entry. V = 250 (125 for the up form's parents) is
    not a multiple of seg, so the values are padded and trimmed."""
    case, cot = _grad_case(form, qblock, num_segs, seed=qblock + num_segs)
    _, dv, dw = _port_grads(case, cot, torch.float32)
    ref_dv, ref_dw = _jax_grads(case, cot, jnp.float32)
    assert dv.shape == ref_dv.shape and dw.shape == ref_dw.shape
    assert np.abs(dv - ref_dv).max() <= 1e-5 * np.abs(ref_dv).max()
    assert np.abs(dw - ref_dw).max() <= 1e-5 * np.abs(ref_dw).max()


@pytest.mark.parametrize("form, qblock", [("sub", 32), ("down", 32),
                                          ("up", 128)])
def test_stencil_conv_grads_match_jax_bfloat16(form, qblock):
    """At bf16 both sides round G and w to bf16 before the products, and
    dw and dG once after their float32 sums, which they take in other
    orders: a sum that lands within float32 rounding of a bf16 rounding
    boundary may round to the neighbouring bf16 value (2^-8 to 2^-7 of
    it) on one side. So each dw entry lies within one bf16 step (2^-7 of
    its size) of JAX's, and dvalues, a float32 sum of such dG rows, within
    2^-7 of the sum of their sizes; nearly every entry is equal (measured:
    every dw entry, and all but 1 of 15,000 dvalues entries over the three
    forms), and the float32 gradient is further off (the bf16 rounding did
    happen on both sides)."""
    case, cot = _grad_case(form, qblock, 16, seed=5 + qblock)
    _, dv, dw = _port_grads(case, cot, torch.bfloat16)
    ref_dv, ref_dw = _jax_grads(case, cot, jnp.bfloat16)
    assert (np.abs(dw - ref_dw) <= 2.0 ** -7 * np.abs(ref_dw)).all()
    _, dv_abs, _ = _port_grads(dict(case, w=np.abs(case["w"])),
                               np.abs(cot), torch.float32)
    # dv_abs bounds the sum of |dG| over a value row's readers
    assert (np.abs(dv - ref_dv) <= 2.0 ** -7 * 1.01 * dv_abs + 1e-7).all()
    assert np.mean(dw == ref_dw) >= 0.98 and np.mean(dv == ref_dv) >= 0.98
    _, dv32, dw32 = _port_grads(case, cot, torch.float32)
    assert np.abs(dw32 - ref_dw).max() > np.abs(dw - ref_dw).max()


def test_stencil_conv_carries_a_gradient_on_both_routes(monkeypatch):
    """Values or weights that need a gradient go through ``StencilConv``
    before the route is chosen, so the kernel's output, written through
    ``data_ptr``, carries one too: here the plain version is replaced by
    one whose output has no autograd history, as the kernel's has none,
    and the gradients come out all the same."""
    case, cot = _grad_case("sub", 32, 4, seed=9)
    out, dv, dw = _port_grads(case, cot, torch.float32)
    assert type(out.grad_fn).__name__ == "StencilConvBackward"
    real = cs.stencil_conv_plain

    def detached(*args, **kwargs):
        return real(*args, **kwargs).detach()

    monkeypatch.setattr(cs, "stencil_conv_plain", detached)
    out2, dv2, dw2 = _port_grads(case, cot, torch.float32)
    assert out2.requires_grad
    np.testing.assert_array_equal(dv2, dv)
    np.testing.assert_array_equal(dw2, dw)
    # only the weight needs a gradient: no scatter of dvalues
    w = _t(case["w"]).requires_grad_()
    out3 = cs.stencil_conv(_t(case["values"]), _t(case["keys"]),
                           _t(case["qkeys"]), _t(case["seg_ids"]), w, seg=16,
                           qblock=32, compute_dtype=torch.float32)
    calls = []
    monkeypatch.setattr(cs, "gather_bucket_bwd",
                        lambda *a, **k: calls.append(1))
    (out3 * _t(cot)).sum().backward()
    assert not calls
    np.testing.assert_array_equal(w.grad.numpy(), dw)


# ---------------------------------------------------------------- BatchNorm

def test_masked_batch_norm_train_matches_flax():
    """Output, gradients (input, scale, bias) and updated statistics of one
    train-mode call on [B, V, C] with padded rows, against flax with
    axis_name=None: float32 sums in other orders, within 1e-5."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 60, 5)) * 2 + 1).astype(np.float32)
    mask = rng.random((2, 60)) > 0.3
    cot = rng.standard_normal(x.shape).astype(np.float32)
    stats = {"mean": rng.normal(0, 0.5, 5).astype(np.float32),
             "var": rng.uniform(0.2, 2.0, 5).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
              "bias": rng.normal(0, 0.3, 5).astype(np.float32)}
    bn = JaxMaskedBN(momentum=0.99, epsilon=1e-4, axis_name=None)

    def loss(p, xx):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, xx,
                          jnp.asarray(mask), training=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (ref, ref_stats)), (dp, dx) = jax.value_and_grad(
        loss, (0, 1), has_aux=True)(params, jnp.asarray(x))
    port = MaskedBatchNorm(5, eps=1e-4, momentum=0.01).train()
    port.load_state_dict({"weight": _t(params["scale"]),
                          "bias": _t(params["bias"]),
                          "running_mean": _t(stats["mean"]),
                          "running_var": _t(stats["var"])})
    xt = _t(x).requires_grad_()
    y = port(xt, _t(mask))
    (y * _t(cot)).sum().backward()
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), **close)
    assert (y.detach().numpy()[~mask] == 0).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **close)
    np.testing.assert_allclose(port.weight.grad.numpy(),
                               np.asarray(dp["scale"]), **close)
    np.testing.assert_allclose(port.bias.grad.numpy(),
                               np.asarray(dp["bias"]), **close)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(ref_stats["mean"]), **close)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(ref_stats["var"]), **close)


# ------------------------------------------------------ one training step

def _scu_batch(seed, b=2, n=1500, classes=5):
    rng = np.random.default_rng(seed)
    batch = surface_batch(rng, b, n)
    batch["label"] = rng.integers(-1, classes, batch["point_mask"].shape
                                  ).astype(np.int32)
    return batch


def _jax_step(cfg, variables, batch):
    """Loss, gradients and updated BN statistics of one JAX training
    step."""
    model = JaxSparseConvUnet(compute_dtype="float32", **cfg)
    net = model.get_net()
    data = types.SimpleNamespace(
        cfg=JaxConfig({"class_weights": CLASS_COUNTS}))
    loss_obj = JaxSemSegLoss(None, model, data)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        results, updates = net.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, training=True, mutable=["batch_stats", "intermediates"])
        loss, _, _ = model.get_loss(loss_obj, results, jbatch)
        return loss, updates["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tree = jax.tree.map(np.asarray, {"grads": grads, "stats": stats})
    return {"loss": float(loss),
            "grads": jax_to_state_dict({"params": tree["grads"]}),
            "stats": jax_to_state_dict({"batch_stats": tree["stats"]})}


def _variables(cfg, batch, seed):
    net = JaxSparseConvUnet(compute_dtype="float32", **cfg).get_net()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda b: net.init({"params": jax.random.PRNGKey(seed)}, b,
                           training=False))(jbatch))
    return {"params": variables["params"],
            "batch_stats": _randomise_stats(variables["batch_stats"],
                                            np.random.default_rng(seed))}


def _port_step(cfg, variables, batch):
    """The port's pipeline after one ``_train_step`` from the same
    variables (or the pipeline's own weights, for None); returns
    (pipeline, loss)."""
    model = SparseConvUnet(compute_dtype="float32", **cfg)
    data = types.SimpleNamespace(cfg=Config({"class_weights": CLASS_COUNTS}),
                                 name="counts")
    pipe = SemanticSegmentation(model, dataset=data, device="cpu", seed=0,
                                optimizer={"lr": 1e-3})
    if variables is not None:
        load_jax_variables(pipe.net, variables)
    pipe.optimizer, pipe.scheduler = model.get_optimizer(pipe.cfg, pipe.net)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = pipe._train_step(inputs, SemSegLoss(pipe, model, data))
    return pipe, float(loss)


def _check_step(pipe, loss, ref, grad_rel, grad_max, stats_max):
    assert np.isfinite(loss)
    assert abs(loss - ref["loss"]) <= 1e-6 * abs(ref["loss"])
    got = {name: p.grad.numpy() for name, p in pipe.net.named_parameters()}
    assert set(got) == set(ref["grads"])
    flat = np.concatenate([got[k].ravel() for k in got])
    want = np.concatenate([ref["grads"][k].numpy().ravel() for k in got])
    assert _rel_l2(flat, want) <= grad_rel, _rel_l2(flat, want)
    for name, g in got.items():
        w = ref["grads"][name].numpy()
        assert np.abs(g - w).max() <= grad_max * np.abs(w).max(), name
    sd = pipe.net.state_dict()
    assert ref["stats"]
    for key, w in ref["stats"].items():
        err = np.abs(sd[key].numpy() - w.numpy()).max()
        assert err <= stats_max * np.abs(w.numpy()).max(), key


@pytest.fixture(scope="module")
def step_case():
    batch = _scu_batch(11)
    variables = _variables(STEP, batch, 3)
    return batch, variables, _jax_step(STEP, variables, batch)


def test_train_step_matches_jax_float32(step_case):
    """One step of the 3-level net (multiplier 4, ~1,000 voxels a sample,
    tables short of exact): the loss within 1e-6; every gradient within
    1e-5 relative L2 over all and 1e-4 of each tensor's largest entry; the
    running statistics within 1e-6 of each tensor's largest entry. Both
    sides take float32 sums in other orders, so a ReLU input within
    rounding of 0 could route a gradient otherwise; none does here."""
    batch, variables, ref = step_case
    pipe, loss = _port_step(STEP, variables, batch)
    _check_step(pipe, loss, ref, grad_rel=1e-5, grad_max=1e-4,
                stats_max=1e-6)


def test_train_step_calls_per_step(monkeypatch):
    """Per training step at 3 levels: 15 stencil convolutions, and in the
    backward one rulebook and one gather per convolution, and one gather
    backward per convolution but the input one (its values, the voxel
    averages of the inputs, need no gradient). At 7 levels: 39, 39, 39 and
    38, the counts ``chip_smoke.py`` pins on the card."""
    calls = {"stencil_conv": 0, "stencil_match": 0, "gather_bucket": 0,
             "gather_bucket_bwd": 0}
    for module, name in ((tscu, "stencil_conv"), (cs, "stencil_match"),
                         (cs, "gather_bucket"), (cs, "gather_bucket_bwd")):
        fn = getattr(module, name)

        def counted(*args, fn=fn, name=name, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    batch = _scu_batch(12, b=1, n=800)
    _port_step(STEP, None, batch)
    assert calls == {"stencil_conv": 15, "stencil_match": 15,
                     "gather_bucket": 15, "gather_bucket_bwd": 14}
    import chip_smoke
    levels = SparseConvUnet().cfg.num_levels
    convs = 1 + 2 * levels + 4 * (levels - 1)
    assert chip_smoke.SCU_TRAIN_STEP_LAUNCHES == {
        "stencil_conv": convs, "stencil_match": convs,
        "bucket_gather": convs, "bucket_gather_bwd": convs - 1}


def test_chip_smoke_training_config_equals_shipped_yaml():
    """``chip_smoke.py`` trains SparseConvUnet with the shipped pipeline
    settings without reading the YAML, on rooms that make 6 training and
    2 validation steps of a batch."""
    import chip_smoke
    cfg = JaxConfig.load_from_file(
        REPO / "open3d_ml_tpu/configs/sparseconvunet_scannet.yml").pipeline
    for key, value in chip_smoke.SCU_TRAIN_PIPELINE.items():
        assert cfg[key] == value, key
    assert chip_smoke.SCU_TRAIN_ROOMS == {"train": 8, "val": 2}


def test_new_modules_import_no_jax():
    """The training slice's modules load neither JAX nor the JAX
    package."""
    code = ("import sys\n"
            "import open3d_ml_tpu_torch.datasets.customdataset\n"
            "import open3d_ml_tpu_torch.datasets.augment.augmentation\n"
            "import open3d_ml_tpu_torch.pipelines.semantic_segmentation\n"
            "import open3d_ml_tpu_torch.ops.cuda.stencil\n"
            "import chip_smoke\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'yaml',\n"
            "                   'open3d_ml_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _hash_steps(cfg, variables, batch, dtype):
    """One train-mode step of the hash net (``get_eval_net``, the JAX
    package's ``_SCUBatcher`` over the vmapped per-sample net) in both
    packages from the same variables, in ``dtype``: ({"logits", "loss",
    "grads", "stats"} of JAX, the same of the port)."""
    f64 = dtype == np.float64
    jm = JaxSparseConvUnet(compute_dtype="float32", **cfg)
    jnet = jm.get_eval_net()
    data = types.SimpleNamespace(
        cfg=JaxConfig({"class_weights": CLASS_COUNTS}))
    with jax.enable_x64(f64):
        cast = lambda t: jax.tree.map(lambda v: jnp.asarray(v, dtype), t)
        params, stats = cast(variables["params"]), cast(
            variables["batch_stats"])
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jbatch["feat"] = jbatch["feat"].astype(dtype)
        loss_obj = JaxSemSegLoss(None, jm, data)

        def loss_fn(params):
            out, upd = jnet.apply(
                {"params": params, "batch_stats": stats}, jbatch,
                training=True, mutable=["batch_stats", "intermediates"])
            return jm.get_loss(loss_obj, out, jbatch)[0], (
                upd["batch_stats"], out)

        (loss, (new_stats, logits)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        tree = jax.tree.map(lambda v: np.asarray(v, np.float64),
                            {"grads": grads, "stats": new_stats})
    ref = {"logits": np.asarray(logits, np.float64), "loss": float(loss),
           "grads": jax_to_state_dict({"params": tree["grads"]}),
           "stats": jax_to_state_dict({"batch_stats": tree["stats"]})}

    model = SparseConvUnet(compute_dtype="float32", **cfg)
    net = load_jax_variables(model.get_eval_net(), variables).train()
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    if f64:
        net = net.double()
        inputs["feat"] = inputs["feat"].double()
    loss_obj = SemSegLoss(None, model, types.SimpleNamespace(
        cfg=Config({"class_weights": CLASS_COUNTS})))
    loss_obj.class_weights = loss_obj.class_weights.to(inputs["feat"].dtype)
    logits = net(inputs)
    loss = model.get_loss(loss_obj, logits, inputs)[0]
    loss.backward()
    got = {"logits": logits.detach().double().numpy(),
           "loss": float(loss.detach()),
           "grads": {n: p.grad.double().numpy()
                     for n, p in net.named_parameters()},
           "stats": {k: v.double().numpy()
                     for k, v in net.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}}
    return ref, got


def _hash_step_apart(ref, got):
    """The relative L2 distances of the logits, the gradients (all in one)
    and the running statistics (each tensor), and the loss's relative
    difference."""
    assert set(got["grads"]) == set(ref["grads"])
    assert set(got["stats"]) == set(ref["stats"]) and got["stats"]
    keys = sorted(got["grads"])
    flat = lambda d: np.concatenate([np.asarray(d[k]).ravel() for k in keys])
    stats = max(_rel_l2(got["stats"][k], ref["stats"][k].numpy())
                for k in got["stats"])
    return {"logits": _rel_l2(got["logits"], ref["logits"]),
            "grads": _rel_l2(flat(got["grads"]),
                             flat({k: v.numpy()
                                   for k, v in ref["grads"].items()})),
            "stats": stats,
            "loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"])}


@pytest.fixture(scope="module")
def hash_case():
    batch = _scu_batch(13)
    return batch, _variables(STEP, batch, 5)


def test_hash_path_refuses_train_mode(hash_case):
    """The hash path in train mode at B = 2 (the 3-level net), float32,
    against the JAX hash net's step: logits, loss, every gradient and the
    running statistics within 1e-4. Its BatchNorm pools the two samples'
    sites, as the JAX net's ``psum`` over its vmapped samples does."""
    batch, variables = hash_case
    apart = _hash_step_apart(*_hash_steps(STEP, variables, batch,
                                          np.float32))
    assert max(apart.values()) <= 1e-4, apart


def test_hash_path_train_step_float64(hash_case):
    """The same step in float64 on both sides: within 1e-6; and each
    BatchNorm's running statistics moved once, by momentum 0.99 towards
    the pooled batch statistics."""
    batch, variables = hash_case
    ref, got = _hash_steps(STEP, variables, batch, np.float64)
    apart = _hash_step_apart(ref, got)
    assert max(apart.values()) <= 1e-6, apart
    before = jax_to_state_dict({"batch_stats": variables["batch_stats"]})
    moved = [k for k in got["stats"]
             if not np.allclose(got["stats"][k], before[k].numpy())]
    assert set(moved) == set(got["stats"])


def test_loss_masks_padded_points_and_ignored_labels():
    """``get_loss`` weighs only the points of ``point_mask`` whose labels
    are not ignored, as the JAX package's does."""
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 50, 5)).astype(np.float32)
    inputs = {"label": rng.integers(-1, 5, (2, 50)).astype(np.int32),
              "point_mask": rng.random((2, 50)) > 0.3}
    jmodel = JaxSparseConvUnet(num_classes=5, ignored_label_inds=[-1])
    tmodel = SparseConvUnet(num_classes=5)
    jdata = types.SimpleNamespace(cfg=JaxConfig(
        {"class_weights": CLASS_COUNTS}))
    tdata = types.SimpleNamespace(cfg=Config({"class_weights": CLASS_COUNTS}))
    ref, ref_lab, _ = jmodel.get_loss(
        JaxSemSegLoss(None, jmodel, jdata), jnp.asarray(logits),
        {k: jnp.asarray(v) for k, v in inputs.items()})
    got, lab, scores = tmodel.get_loss(
        SemSegLoss(None, tmodel, tdata), torch.from_numpy(logits),
        {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_lab))
    assert tuple(scores.shape) == (100, 5)


def test_optimizer_is_constant_rate_adam():
    """Adam with the configured rate and betas, eps 1e-8; the scheduler
    keeps the rate whatever ``scheduler_gamma`` says, as the JAX
    pipeline's plain ``optax.adam`` does."""
    net = torch.nn.Linear(3, 2)
    cfg = Config({"optimizer": {"lr": 0.004, "betas": [0.8, 0.99]},
                  "scheduler_gamma": 0.5, "steps_per_epoch": 1})
    opt, sched = SparseConvUnet().get_optimizer(cfg, net)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (0.004,
                                                           (0.8, 0.99), 1e-8)
    for _ in range(3):
        opt.step()
        sched.step()
    assert opt.param_groups[0]["lr"] == 0.004
    opt, _ = SparseConvUnet().get_optimizer(Config({}), net)
    assert opt.param_groups[0]["lr"] == 1e-3
    assert opt.param_groups[0]["betas"] == (0.9, 0.999)


# ------------------------------------------------------------- host side

SCANNET_AUGMENT = SparseConvUnet().cfg.augment
AUGMENT_SEEDS = range(12)


def _augment(cls, seed):
    """A 2,000-point room augmented by ``cls`` with the ScanNet recipe."""
    rng = np.random.default_rng(100 + seed)
    pc = rng.uniform(-150, 150, (2000, 3)).astype(np.float32)
    feat = rng.uniform(0, 255, (2000, 3)).astype(np.float32)
    labels = rng.integers(0, 20, 2000).astype(np.int32)
    return cls(SCANNET_AUGMENT, seed=seed).augment(pc, feat, labels,
                                                   SCANNET_AUGMENT)


@pytest.mark.parametrize("seed", AUGMENT_SEEDS)
def test_scannet_augmentations_bit_equal(seed):
    """The shipped ScanNet recipe (rotate, scale, noise, the dropout, the
    flips and the three chromatic steps) from one seed: points, colours and
    labels equal bit for bit."""
    got = _augment(SemsegAugmentation, seed)
    want = _augment(JaxAugment, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_scannet_augmentation_seeds_take_every_branch(monkeypatch):
    """Over the seeds of the bit-equality test each random step of the
    recipe applies its change at least once and skips it at least once
    (the flips and the colour steps 0.95 of the time each)."""
    seen = {}
    for name in ("RandomDropout", "RandomHorizontalFlip",
                 "ChromaticAutoContrast", "ChromaticTranslation",
                 "ChromaticJitter"):
        real = getattr(SemsegAugmentation, name)

        def watched(self, *args, real=real, name=name):
            before = [None if a is None else np.array(a) for a in args[:-1]]
            out = real(self, *args)
            out = out if isinstance(out, tuple) else (out,)
            changed = any(b is not None and (o.shape != b.shape or
                                             (o != b).any())
                          for o, b in zip(out, before))
            seen.setdefault(name, set()).add(changed)
            return out if len(out) > 1 else out[0]

        monkeypatch.setattr(SemsegAugmentation, name, watched)
    for seed in AUGMENT_SEEDS:
        _augment(SemsegAugmentation, seed)
    assert seen["RandomDropout"] == {True, False}
    assert seen["ChromaticAutoContrast"] == {True, False}
    for name in ("RandomHorizontalFlip", "ChromaticTranslation",
                 "ChromaticJitter"):
        assert True in seen[name], name


def test_unported_augmentations_raise():
    pc = np.zeros((10, 3), np.float32)
    feat = np.zeros((10, 3), np.float32)
    with pytest.raises(NotImplementedError, match="not ported"):
        SemsegAugmentation({}).augment(pc, feat, None, {"Unknown": {}})
    with pytest.raises(ValueError, match="Unsupported rotate method"):
        SemsegAugmentation({}).augment(pc, feat, None,
                                       {"rotate": {"method": "upright"}})
    with pytest.raises(ValueError, match="Unsupported rotate method"):
        JaxAugment({}).augment(pc, feat, None,
                               {"rotate": {"method": "upright"}})


def _write_rooms(root, counts, n=900, seed=0):
    """Rooms of ``n`` points (walls and floor, RGB 0-255, labels 0-4) as
    .npy dicts under root/{train,val,test}."""
    rng = np.random.default_rng(seed)
    for split, count in counts.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(count):
            pts = surface_batch(rng, 1, n)["point"][0] * 0.05
            np.save(root / split / f"room_{i}.npy",
                    {"point": pts,
                     "feat": rng.uniform(0, 255, (n, 3)).astype(np.float32),
                     "label": rng.integers(0, 5, n).astype(np.int32)})
    return root


def test_custom3d_matches_jax(tmp_path):
    root = _write_rooms(tmp_path / "data", {"train": 3, "val": 2, "test": 1})
    np.save(root / "test" / "plain.npy",
            np.random.default_rng(1).uniform(0, 5, (40, 6)).astype(
                np.float32))
    port = Custom3D(dataset_path=str(root), seed=2)
    ref = JaxCustom3D(dataset_path=str(root))
    assert DATASET.get("Custom3D") is Custom3D
    assert DATASET.get("SyntheticShapes") is SyntheticShapes
    assert port.get_label_to_names() == ref.get_label_to_names()
    assert port.num_classes == ref.num_classes
    for split in ("train", "validation", "test", "all"):
        ps_, rs = port.get_split(split), ref.get_split(split)
        assert len(ps_) == len(rs) > 0
        for i in range(len(ps_)):
            assert ps_.get_attr(i) == rs.get_attr(i)
            got, want = ps_.get_data(i), rs.get_data(i)
            for key in ("point", "feat", "label"):
                assert (got[key] is None) == (want[key] is None)
                if want[key] is not None:
                    assert got[key].dtype == want[key].dtype
                    np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="Invalid split"):
        port.get_split_list("nope")


def test_training_preprocess_and_transform_bit_equal(tmp_path):
    """A training cloud through ``preprocess`` (the ScanNet augmentations)
    and ``transform`` on models seeded alike: equal arrays, over several
    draws."""
    root = _write_rooms(tmp_path / "data", {"train": 1}, n=3000)
    split = Custom3D(dataset_path=str(root)).get_split("train")
    data, attr = split.get_data(0), split.get_attr(0)
    jm = JaxSparseConvUnet(voxel_size=0.02, num_points=2048, seed=8,
                           augment=SCANNET_AUGMENT)
    tm = SparseConvUnet(num_points=2048, seed=8)
    for _ in range(3):
        jp, tp = jm.preprocess(data, attr), tm.preprocess(data, attr)
        jt, tt = jm.transform(jp, attr), tm.transform(tp, attr)
        for key in jt:
            np.testing.assert_array_equal(tt[key], jt[key], err_msg=key)


# ---------------------------------------------------------------- pipeline

def _old_init_weights(net, gen):
    """``init_weights`` as it was before it knew the SCU layers."""
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, torch.nn.Linear):
                bound = module.in_features ** -0.5
                module.weight.uniform_(-bound, bound, generator=gen)
                module.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(module, torch.nn.BatchNorm1d):
                module.reset_parameters()
    return net


def test_randlanet_seeded_weights_unchanged():
    """The pipeline draws RandLA-Net's weights as before: same seed, same
    weights and dropout seed."""
    from test_torch_randlanet import SMALL as RANDLA
    pipe = SemanticSegmentation(RandLANet(**RANDLA), device="cpu", seed=5)
    rng = np.random.default_rng(5)
    top = np.iinfo(np.int32).max
    gen = torch.Generator().manual_seed(int(rng.integers(top)))
    want = _old_init_weights(RandLANet(**RANDLA).get_net(), gen)
    for key, value in want.state_dict().items():
        assert torch.equal(pipe.net.state_dict()[key], value), key
    assert pipe.net.dropout.seed == int(rng.integers(top))


def test_scu_weights_come_from_the_pipeline_seed():
    """Two pipelines with one seed give equal SCU weights, stencil weights
    included, whatever the global generator holds; another seed gives
    other ones. The stencil weights have flax's std 1/sqrt(K * Cin), the
    BatchNorms are the identity, and the bias-free shortcut is drawn."""
    def weights(seed, noise):
        torch.manual_seed(noise)
        model = SparseConvUnet(multiplier=8, num_levels=3)
        return SemanticSegmentation(model, device="cpu",
                                    seed=seed).net.state_dict()

    a, b, c = weights(3, 0), weights(3, 1), weights(4, 0)
    for key in a:
        assert torch.equal(a[key], b[key]), key
        if a[key].dim() == 3:  # every stencil weight drawn, none left at 0
            assert bool((a[key] != 0).all()), key
    assert not torch.equal(a["l0_down_kernel"], c["l0_down_kernel"])
    assert not torch.equal(a["l0_post0.lin.weight"],
                           c["l0_post0.lin.weight"])
    w = a["l2_block0.conv1.weight"]
    assert abs(float(w.std()) * (27 * 24) ** 0.5 - 1.0) < 0.05
    assert torch.equal(a["l1_up_bn.weight"], torch.ones(24))
    assert torch.equal(a["final_bn.running_var"], torch.ones(8))


def _train_pipeline(root, seed, max_epoch):
    dataset = Custom3D(dataset_path=str(root / "data"), seed=0,
                       steps_per_epoch_train=4, steps_per_epoch_valid=2,
                       class_weights=CLASS_COUNTS)
    model = SparseConvUnet(seed=seed, multiplier=4, num_levels=3,
                           num_classes=5, num_points=512, max_voxels=512,
                           voxel_size=0.1)
    return SemanticSegmentation(
        model, dataset=dataset, device="cpu", seed=seed, max_epoch=max_epoch,
        batch_size=2, val_batch_size=2, num_workers=1,
        optimizer={"lr": 1e-3, "betas": [0.9, 0.999]},
        main_log_dir=str(root / "logs"))


def test_run_train_checkpoint_and_resume(tmp_path):
    """``run_train`` of the stencil net on ``Custom3D`` rooms with the
    ScanNet augmentations: two steps and a validation step with finite
    losses, a checkpoint, and a fresh pipeline (other initial weights)
    resuming from it with the saved weights, BN statistics and Adam state;
    the resumed run trains epoch 1 and writes its checkpoint."""
    _write_rooms(tmp_path / "data", {"train": 3, "val": 2})
    first = _train_pipeline(tmp_path, seed=0, max_epoch=0)
    first.run_train()
    assert len(first.losses) == 2 and len(first.valid_losses) == 1
    assert np.isfinite(first.losses + first.valid_losses).all()
    ckpt = (tmp_path / "logs" / "SparseConvUnet_Custom3D_torch" /
            "checkpoint" / "ckpt_00000.pth")
    assert ckpt.exists()
    saved = {k: v.clone() for k, v in first.net.state_dict().items()}
    assert not torch.equal(saved["l0_up_bn.running_mean"],
                           torch.zeros_like(saved["l0_up_bn.running_mean"]))
    saved_opt = first.optimizer.state_dict()

    resumed = _train_pipeline(tmp_path, seed=1, max_epoch=1)
    assert not torch.equal(resumed.net.input_conv.weight,
                           saved["input_conv.weight"])
    resumed.optimizer, resumed.scheduler = resumed.model.get_optimizer(
        resumed.cfg, resumed.net)
    assert resumed.load_ckpt() == 1
    for key, value in resumed.net.state_dict().items():
        assert torch.equal(value, saved[key]), key
    state = resumed.optimizer.state_dict()["state"]
    for idx, moments in saved_opt["state"].items():
        for name, value in moments.items():
            assert torch.equal(state[idx][name], value), (idx, name)
    resumed.run_train()
    assert len(resumed.losses) == 2 and np.isfinite(resumed.losses).all()
    assert (ckpt.parent / "ckpt_00001.pth").exists()


def _port_grads_float64(cfg, variables, batch, monkeypatch):
    """The port's gradients of one step in float64 (the plain stencil
    convolution, which carries float64 values, with its own autograd)."""
    monkeypatch.setattr(tscu, "stencil_conv", cs.stencil_conv_plain)
    model = SparseConvUnet(compute_dtype="float32", **cfg)
    net = load_jax_variables(model.get_net(), variables).double().train()
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}
    inputs["feat"] = inputs["feat"].double()
    loss = SemSegLoss(None, model, types.SimpleNamespace(
        cfg=Config({"class_weights": CLASS_COUNTS})))
    loss.class_weights = loss.class_weights.double()
    model.get_loss(loss, net(inputs), inputs)[0].backward()
    return {name: p.grad.numpy() for name, p in net.named_parameters()}


@pytest.mark.slow
def test_train_step_matches_jax_full_width(monkeypatch):
    """One step at the ScanNet config's widths and depth (7 levels,
    multiplier 32, residual blocks, seg 64, qblock 32, S 16) on two small
    rooms. The port in float64 against JAX's float32 step: the gradient
    within 1e-5 relative L2 (measured 2.1e-6). The port's float32 step:
    loss within 1e-6 and running statistics within 1e-6 as at 3 levels,
    but its gradient only within 1e-3 relative L2: at this size a ReLU
    input within float32 rounding of 0 takes the other branch on one side
    (measured: one, in channel 70 of l1_post0.bn1, which moves the
    gradient of every layer below it by 5.9e-4 relative L2)."""
    cfg = dict(multiplier=32, residual_blocks=True, num_levels=7,
               in_channels=3, num_classes=5, max_voxels=4000,
               num_points=6000, bucket_seg=64, bucket_qblock=32,
               bucket_segs=16, ignored_label_inds=[-1])
    batch = _scu_batch(21, b=2, n=6000)
    batch["point"] = batch["point"] * 2.5
    variables = _variables(cfg, batch, 6)
    ref = _jax_step(cfg, variables, batch)
    pipe, loss = _port_step(cfg, variables, batch)
    _check_step(pipe, loss, ref, grad_rel=1e-3, grad_max=2e-2,
                stats_max=1e-6)
    g64 = _port_grads_float64(cfg, variables, batch, monkeypatch)
    flat = np.concatenate([g.ravel() for g in g64.values()])
    want = np.concatenate([ref["grads"][k].numpy().ravel() for k in g64])
    assert _rel_l2(flat, want) <= 1e-5, _rel_l2(flat, want)
