"""The port's training step (``open3d_ml_tpu_torch``) against the JAX
package, and the pieces it is made of.

One training step on both sides: the same variables (``load_jax_variables``),
the same numpy batch of lattice coordinates with a patch of duplicated
points (so that the pool's max has exact ties), the dropout mask the JAX
net drew (captured with ``capture_intermediates`` and fed to the port in
place of its own dropout), ``SemSegLoss`` with class weights, and Adam with
the exponential schedule (``optax.adam`` on the JAX side, the port's
``get_optimizer``). On the CPU the JAX fused path runs its kernels' XLA
twins (exact float32 gathers and scatter-adds) and the port its kernels'
plain versions.
"""

import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open3d_ml_tpu.models.randlanet import RandLANet as JaxRandLANet
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxSemSegLoss
from open3d_ml_tpu.modules.losses import filter_valid_label as jax_filter
from open3d_ml_tpu.modules.metrics import SemSegMetric as JaxSemSegMetric
from open3d_ml_tpu.modules.metrics.semseg_metric import (
    confusion_matrix_device as jax_confusion)
from open3d_ml_tpu.modules.schedulers import (
    exponential_lr as jax_exponential_lr)
from open3d_ml_tpu.utils import Config as JaxConfig
from open3d_ml_tpu_torch.models import RandLANet
from open3d_ml_tpu_torch.models.randlanet import _BatchNorm, _Dropout
from open3d_ml_tpu_torch.modules.losses import SemSegLoss, filter_valid_label
from open3d_ml_tpu_torch.modules.metrics import (SemSegMetric,
                                                 confusion_matrix_device)
from open3d_ml_tpu_torch.modules.schedulers import exponential_lr
from open3d_ml_tpu_torch.ops import bucket as tb
from open3d_ml_tpu_torch.ops.cuda import bucket as cb
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
from open3d_ml_tpu_torch.utils import Config, load_jax_variables
from open3d_ml_tpu_torch.utils.convert_jax import (jax_to_state_dict,
                                                   state_dict_to_jax)

from test_torch_ops import lattice_cloud
from test_torch_randlanet import SMALL, _randomise_stats

B, N = 2, 2560
LR, GAMMA, STEPS = 1e-2, 0.9, 2
CLASS_COUNTS = [5000, 320, 541, 2578, 3274, 552, 184, 78, 24094, 1729, 17059,
                636, 23041, 10113, 47649, 983, 12960, 450, 116]


def _batch():
    """Lattice coordinates, features and labels; rows 64-127 of each
    sample repeat rows 0-63 (points, features and labels)."""
    rng = np.random.default_rng(11)
    coords = lattice_cloud(rng, B, N)
    feats = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    labels = rng.integers(0, 19, (B, N)).astype(np.int32)
    for a in (coords, feats, labels):
        a[:, 64:128] = a[:, :64]
    return {"coords": coords, "features": feats, "labels": labels}


def _dataset(config):
    """A stand-in dataset that carries only the class counts."""
    return types.SimpleNamespace(cfg=config({"class_weights": CLASS_COUNTS}),
                                 name="counts")


class _FixedDropout(torch.nn.Module):
    """Dropout with the JAX net's keep mask (rate 0.5)."""

    def __init__(self, keep):
        super().__init__()
        self.keep = keep

    def forward(self, x):
        if not self.training:
            return x
        return torch.where(self.keep, x * 2.0, torch.zeros_like(x))


def _jax_step(variables, batch, dtype):
    """Loss, gradients, updated BN statistics, the dropout keep mask and
    the Adam-updated parameters of one JAX training step."""
    model = JaxRandLANet(compute_dtype=dtype, **SMALL)
    net = model.get_net()
    loss_obj = JaxSemSegLoss(None, model, _dataset(JaxConfig))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        results, updates = net.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch, training=True, mutable=["batch_stats", "intermediates"],
            rngs={"dropout": jax.random.PRNGKey(7)},
            capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
        loss, _, _ = model.get_loss(loss_obj, results, jbatch)
        return loss, (updates["batch_stats"], updates["intermediates"])

    (loss, (stats, inter)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    (dropped,) = jax.tree.leaves(inter)
    tx = optax.adam(jax_exponential_lr(LR, GAMMA, steps_per_epoch=STEPS))
    updates, _ = tx.update(grads, tx.init(variables["params"]),
                           variables["params"])
    params = optax.apply_updates(variables["params"], updates)
    tree = jax.tree.map(np.asarray, {"grads": grads, "stats": stats,
                                     "params": params})
    return {"loss": float(loss),
            "grads": jax_to_state_dict({"params": tree["grads"]}),
            "stats": jax_to_state_dict({"batch_stats": tree["stats"]}),
            "params": jax_to_state_dict({"params": tree["params"]}),
            "keep": np.asarray(dropped) != 0}


@pytest.fixture(scope="module")
def reference():
    """The batch, the JAX variables (numpy) and a JAX step per dtype."""
    batch = _batch()
    net = JaxRandLANet(compute_dtype="float32", **SMALL).get_net()
    key = jax.random.PRNGKey(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda b: net.init({"params": key, "dropout": key}, b,
                           training=False))(jbatch))
    variables = {"params": variables["params"],
                 "batch_stats": _randomise_stats(variables["batch_stats"],
                                                 np.random.default_rng(12))}
    return {"batch": batch, "variables": variables,
            "jax": {dtype: _jax_step(variables, batch, dtype)
                    for dtype in ("float32", "bfloat16")}}


def _port_step(reference, dtype):
    """The port's pipeline after one ``_train_step`` from the same state;
    returns (pipeline, loss)."""
    model = RandLANet(compute_dtype=dtype, **SMALL)
    pipe = SemanticSegmentation(model, device="cpu", seed=0,
                                optimizer={"lr": LR}, scheduler_gamma=GAMMA,
                                steps_per_epoch=STEPS)
    load_jax_variables(pipe.net, reference["variables"])
    keep = torch.from_numpy(reference["jax"][dtype]["keep"])
    pipe.net.dropout = _FixedDropout(keep)
    pipe.optimizer, pipe.scheduler = model.get_optimizer(pipe.cfg, pipe.net)
    inputs = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    loss, _ = pipe._train_step(inputs, SemSegLoss(pipe, model,
                                                  _dataset(Config)))
    return pipe, float(loss)


@pytest.fixture(scope="module")
def port_float32(reference):
    return _port_step(reference, "float32")


def _zero_gradient(name):
    """Parameters whose gradient is 0 in exact arithmetic: the bias of a
    Linear followed by BatchNorm (which removes it with the mean) and the
    attention scores' bias (softmax over K ignores a shift)."""
    return ((name.endswith("conv.bias") and name != "fc1_3.conv.bias") or
            name == "fc0.bias" or name.endswith("score_fn.bias"))


def _flat(tensors):
    return np.concatenate([np.asarray(t, np.float64).ravel()
                           for t in tensors])


def test_train_step_loss_matches_jax_float32(reference, port_float32):
    """The same weights, batch, mask and weights give the same loss; every
    stage is exact or float32 rounding apart (measured: equal bits)."""
    _, loss = port_float32
    want = reference["jax"]["float32"]["loss"]
    assert np.isfinite(loss)
    assert abs(loss - want) <= 1e-6 * abs(want)


def test_train_step_gradients_match_jax_float32(reference, port_float32):
    """Every gradient, through ``jax_to_state_dict``. Measured: relative L2
    1.8e-6 over all of them, at most 8e-6 of a tensor's largest entry.
    The bounds are 1e-5 and 1e-4. Gradients that are 0 in exact arithmetic
    are float32 noise on both sides (measured under 5e-8); they must stay
    under 1e-6."""
    pipe, _ = port_float32
    want = reference["jax"]["float32"]["grads"]
    got = {name: p.grad.numpy() for name, p in pipe.net.named_parameters()}
    assert set(got) == set(want)
    g, w = _flat(got.values()), _flat(want[k] for k in got)
    assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w)
    for name in got:
        ref = want[name].numpy()
        if _zero_gradient(name):
            assert np.abs(got[name]).max() <= 1e-6, name
            assert np.abs(ref).max() <= 1e-6, name
        else:
            err = np.abs(got[name] - ref).max()
            assert err <= 1e-4 * np.abs(ref).max(), name


def test_train_step_bn_statistics_match_jax_float32(reference, port_float32):
    """The running statistics after the step: flax's update with the
    biased batch variance (measured within 1e-7 of each tensor's largest
    entry; bound 1e-6)."""
    pipe, _ = port_float32
    sd = pipe.net.state_dict()
    want = reference["jax"]["float32"]["stats"]
    assert want
    for key, ref in want.items():
        err = np.abs(sd[key].numpy() - ref.numpy()).max()
        assert err <= 1e-6 * np.abs(ref.numpy()).max(), key


def test_train_step_adam_update_matches_optax_float32(reference,
                                                      port_float32):
    """Adam's first step moves a weight by lr * g / (|g| + eps): at most
    lr, and lr times the sign of g wherever |g| >> eps. Where the JAX
    gradient exceeds 1e-6 (the gradient's float32 noise is under 5e-8)
    both sides move by the same amount up to float32 rounding of the
    weight (1e-6); elsewhere they differ by at most 2 lr."""
    pipe, _ = port_float32
    ref = reference["jax"]["float32"]
    sd = pipe.net.state_dict()
    determined = 0
    for name, want in ref["params"].items():
        got, want = sd[name].numpy(), want.numpy()
        big = np.abs(ref["grads"][name].numpy()) > 1e-6
        determined += int(big.sum())
        np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-6,
                                   err_msg=name)
        assert np.abs(got - want).max() <= 2 * LR * (1 + 1e-6), name
    assert determined > 0.9 * sum(v.numel() for v in ref["params"].values())


def test_train_step_bfloat16_close_to_jax(reference):
    """At bfloat16 the two sides round at different places (the port's
    gathers round values and cotangents as the TPU kernels did, the JAX
    twins here are exact; the bf16 products and casts differ), and the
    weight gradient of a Linear that feeds BatchNorm sums mean-zero
    products over every row, so its rounding error is large relative to
    it on either side. So the port's bf16 gradient is held to be no
    further from the JAX float32 gradient than the JAX package's own bf16
    gradient is, with 50% room (measured: the port 0.19, JAX 0.19 relative
    L2); the loss within 1e-3 and the BN statistics within 1e-2 of the
    JAX bf16 step's (measured 2e-5 and 3e-4)."""
    pipe, loss = _port_step(reference, "bfloat16")
    ref, ref32 = reference["jax"]["bfloat16"], reference["jax"]["float32"]
    names = [name for name, _ in pipe.net.named_parameters()]
    got = _flat(p.grad.numpy() for _, p in pipe.net.named_parameters())
    truth = _flat(ref32["grads"][k] for k in names)
    jax_bf16 = _flat(ref["grads"][k] for k in names)
    port_dist = np.linalg.norm(got - truth) / np.linalg.norm(truth)
    jax_dist = np.linalg.norm(jax_bf16 - truth) / np.linalg.norm(truth)
    assert np.isfinite(loss)
    assert abs(loss - ref["loss"]) <= 1e-3 * abs(ref["loss"])
    assert port_dist <= 1.5 * jax_dist, (port_dist, jax_dist)
    sd = pipe.net.state_dict()
    for key, want in ref["stats"].items():
        err = np.abs(sd[key].numpy() - want.numpy()).max()
        assert err <= 1e-2 * np.abs(want.numpy()).max(), key


def test_train_step_launches_one_backward_per_gather(reference,
                                                      monkeypatch):
    """A training step runs one gather backward per gather: 16 at four
    levels (a neighbour gather in each LSE pass, a pool and an upsample per
    level), beside one KNN search per level plus one per level whose pool
    queries cannot reuse the level's search (N % qblock != 0): levels 2-3
    here, level 3 (704 points) at the shipped config. These are the counts
    ``chip_smoke.py`` pins on the card."""
    calls = {"knn_bucket": 0, "gather_bucket": 0, "gather_bucket_bwd": 0}
    # the pyramid calls knn_bucket through its own module's name
    for module, name in ((tb, "knn_bucket"), (cb, "gather_bucket"),
                         (cb, "gather_bucket_bwd")):
        fn = getattr(module, name)

        def counted(*args, fn=fn, name=name, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    import chip_smoke
    _port_step(reference, "float32")
    assert calls == {"knn_bucket": 6, "gather_bucket": 16,
                     "gather_bucket_bwd": 16}
    shipped = RandLANet().cfg
    sizes = [shipped.num_points // 4 ** i for i in range(4)]
    searches = 4 + sum(n % shipped.block != 0 for n in sizes)
    assert chip_smoke.TRAIN_STEP_LAUNCHES == {
        "bucket_knn": searches, "bucket_gather": 16,
        "bucket_gather_bwd": 16, "knn_exact": 0}


# ----------------------------------------------------------- BN and dropout

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_step_matches_flax(dtype):
    """37 rows: the output and the updated statistics of flax's BatchNorm
    (momentum 0.99, biased variance), within float32 rounding; torch's own
    BatchNorm1d moves the running variance towards the unbiased variance,
    37/36 times larger, which these bounds catch."""
    rng = np.random.default_rng(13)
    x = (rng.normal(1.0, 3.0, (37, 5))).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 5), rng.normal(0, 0.3, 5)
    mean, var = rng.normal(0, 0.2, 5), rng.uniform(0.5, 1.5, 5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                             variables)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-6)
    jx = jnp.asarray(x).astype(dtype)
    want, updates = bn.apply(variables, jx, mutable=["batch_stats"])

    port = _BatchNorm(5)
    with torch.no_grad():
        for p, v in ((port.weight, scale), (port.bias, bias),
                     (port.running_mean, mean), (port.running_var, var)):
            p.copy_(torch.tensor(v, dtype=torch.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = port.train()(tx)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    stats = updates["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)

    torch_bn = torch.nn.BatchNorm1d(5, eps=1e-6, momentum=0.01)
    torch_bn.load_state_dict(port.state_dict(), strict=False)
    with torch.no_grad():
        torch_bn.running_var.copy_(torch.tensor(var, dtype=torch.float32))
    torch_bn.train()(tx.float())
    assert not np.allclose(torch_bn.running_var.numpy(),
                           np.asarray(stats["var"]), rtol=1e-5, atol=0)


def test_batchnorm_eval_is_torch_batchnorm():
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(0, 2, (50, 4)).astype(np.float32))
    port, ref = _BatchNorm(4), torch.nn.BatchNorm1d(4, eps=1e-6,
                                                    momentum=0.01)
    with torch.no_grad():
        for t in (port, ref):
            t.running_mean.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
            t.running_var.copy_(torch.tensor([1.5, 0.5, 2.0, 1.0]))
    with torch.no_grad():
        np.testing.assert_array_equal(port.eval()(x).numpy(),
                                      ref.eval()(x).numpy())
    assert set(port.state_dict()) == set(ref.state_dict())


def test_dropout_draws_from_its_own_generator():
    """The mask comes from the module's seeded generator, not torch's
    global one; kept elements are doubled; eval mode is the identity."""
    x = torch.ones((4, 1000, 32))

    def masked(seed, global_seed):
        torch.manual_seed(global_seed)
        drop = _Dropout(0.5, seed=seed).train()
        return drop(x), drop(x)

    a1, a2 = masked(3, 0)
    b1, b2 = masked(3, 1)
    np.testing.assert_array_equal(a1.numpy(), b1.numpy())
    np.testing.assert_array_equal(a2.numpy(), b2.numpy())
    assert not torch.equal(a1, a2)  # the generator advances
    assert not torch.equal(a1, masked(4, 0)[0])
    assert set(np.unique(a1.numpy())) == {0.0, 2.0}
    assert abs((a1 == 0).float().mean().item() - 0.5) < 0.01
    assert torch.equal(_Dropout(0.5).eval()(x), x)


def test_pipeline_seeds_the_dropout():
    def mask(seed):
        pipe = SemanticSegmentation(RandLANet(**SMALL), device="cpu",
                                    seed=seed)
        return pipe.net.dropout.train()(torch.ones((1, 64, 32)))

    assert torch.equal(mask(5), mask(5))
    assert not torch.equal(mask(5), mask(6))


# --------------------------------------------------- loss, metric, schedule

@pytest.mark.parametrize("ignored", [[0], [0, 3]])
def test_filter_valid_label_matches_jax(ignored):
    labels = np.random.default_rng(15).integers(0, 19, 500).astype(np.int32)
    got = filter_valid_label(None, torch.from_numpy(labels), 19 - len(ignored),
                             ignored)
    want = jax_filter(None, jnp.asarray(labels), 19 - len(ignored), ignored)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_cross_entropy_matches_jax(weighted):
    rng = np.random.default_rng(16)
    logits = rng.normal(0, 2, (400, 19)).astype(np.float32)
    labels = rng.integers(0, 19, 400).astype(np.int32)
    valid = rng.random(400) > 0.2
    counts = CLASS_COUNTS if weighted else None
    model_cfg = {"num_classes": 19, "ignored_label_inds": [0]}
    jloss = JaxSemSegLoss(None, types.SimpleNamespace(
        cfg=JaxConfig(model_cfg)), types.SimpleNamespace(
        cfg=JaxConfig({"class_weights": counts})))
    loss = SemSegLoss(None, types.SimpleNamespace(cfg=Config(model_cfg)),
                      types.SimpleNamespace(cfg=Config(
                          {"class_weights": counts})))
    assert (loss.class_weights is None) == (not weighted)
    got = loss.weighted_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(valid))
    want = jloss.weighted_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels),
                                        jnp.asarray(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # no valid row: the denominator is 1e-6, the loss 0
    none = torch.zeros(400, dtype=torch.bool)
    assert loss.weighted_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels),
                                       none).item() == 0.0


def test_class_weights_bit_equal():
    from open3d_ml_tpu.datasets.utils import DataProcessing as JaxDP
    from open3d_ml_tpu_torch.datasets.utils import DataProcessing
    got = DataProcessing.get_class_weights(CLASS_COUNTS)
    want = JaxDP.get_class_weights(CLASS_COUNTS)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_confusion_matrix_and_metric_match_jax():
    rng = np.random.default_rng(17)
    port, ref = SemSegMetric(), JaxSemSegMetric()
    assert port.acc() == [] and port.iou() == []
    for _ in range(3):
        scores = rng.normal(0, 1, (300, 6)).astype(np.float32)
        labels = rng.integers(0, 5, 300).astype(np.int32)  # class 5 absent
        valid = rng.random(300) > 0.1
        got = confusion_matrix_device(torch.from_numpy(scores),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(valid), 6)
        want = np.asarray(jax_confusion(jnp.asarray(scores),
                                        jnp.asarray(labels),
                                        jnp.asarray(valid), 6))
        np.testing.assert_array_equal(got.numpy(), want)
        port.update_cm(got)
        ref.update_cm(want)
    np.testing.assert_array_equal(port.acc(), ref.acc())
    np.testing.assert_array_equal(port.iou(), ref.iou())


def test_exponential_lr_and_adam_match_optax():
    """Five steps on one parameter vector: the learning rate of update t
    is lr * gamma^(t // steps_per_epoch) and Adam's update is optax.adam's
    (within 1e-5: the two round the bias corrections in different orders,
    measured 1.7e-6 after five steps of lr 0.1)."""
    rng = np.random.default_rng(18)
    w0 = rng.normal(0, 1, 7).astype(np.float32)
    grads = rng.normal(0, 1, (5, 7)).astype(np.float32)
    schedule = jax_exponential_lr(0.1, 0.5, steps_per_epoch=2)
    tx = optax.adam(schedule)
    params = jnp.asarray(w0)
    state = tx.init(params)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch.optim.Adam([w], lr=0.1, betas=(0.9, 0.999), eps=1e-8)
    sched = exponential_lr(opt, 0.5, steps_per_epoch=2)
    for t, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(schedule(t)))
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        w.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(params),
                                   rtol=0, atol=1e-5)


def test_get_optimizer_reads_the_pipeline_config():
    model = RandLANet(**SMALL)
    net = model.get_net()
    cfg = Config({"optimizer": {"lr": 0.003}, "scheduler_gamma": 0.5,
                  "steps_per_epoch": 3})
    opt, sched = model.get_optimizer(cfg, net)
    assert isinstance(opt, torch.optim.Adam)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    lrs = []
    for _ in range(7):
        lrs.append(group["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [0.003] * 3 + [0.0015] * 3 + [0.00075])
    opt, _ = model.get_optimizer(Config({"adam_lr": 0.02}), net)
    assert opt.param_groups[0]["lr"] == 0.02


# -------------------------------------------------------------- conversion

def test_state_dict_to_jax_round_trips(reference):
    variables = reference["variables"]
    net = load_jax_variables(RandLANet(**SMALL).get_net(), variables)
    back = state_dict_to_jax(net.state_dict())
    flat_in = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    for path, value in flat_in:
        np.testing.assert_array_equal(flat_out[path], value)
    sd = jax_to_state_dict(back)
    for key, value in net.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(sd[key], value), key
    with pytest.raises(KeyError, match="no flax leaf"):
        state_dict_to_jax({"fc0.odd": torch.zeros(2)})
