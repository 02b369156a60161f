"""PVCNN's training in the port (``open3d_ml_tpu_torch``) against the JAX
package: one training step, Adam under the exponential schedule, the
command line on S3DIS rooms, and two faults of the JAX package that the
port mirrors.

The step runs at the small config of ``test_torch_pvcnn.py`` (width 0.125,
grids of 8^3 and 4^3, B = 2, N = 512) on the JAX net's variables, in
float64 on both sides: the dropout masks are the JAX net's (captured with
``capture_intermediates`` and fed to the port in place of its own), so
both compute one function. The loss, each gradient, BN statistic and
parameter after one Adam step within 1e-6 relative L2 (``F64_TOL``).
"""

import pickle
import types

import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from open3d_ml_tpu.dataloaders.dataloader import (
    PointCloudDataloader as JaxLoader)
from open3d_ml_tpu.datasets import S3DIS as JaxS3DIS
from open3d_ml_tpu.datasets.samplers import semseg_spatially_regular as jsr
from open3d_ml_tpu.models import pvcnn as jpv
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxLoss
from open3d_ml_tpu.pipelines import SemanticSegmentation as JaxPipeline
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu_torch import run_pipeline
from open3d_ml_tpu_torch.dataloaders import PointCloudDataloader
from open3d_ml_tpu_torch.datasets import S3DIS
from open3d_ml_tpu_torch.models import PVCNN
from open3d_ml_tpu_torch.models import pvcnn as tpv
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
from open3d_ml_tpu_torch.utils import load_jax_variables

import chip_smoke
from test_torch_pvcnn import (B, N, PV_YML, SMALL, _cloud, _rel,
                              shape_variables)
from torch_threads import one_torch_thread  # noqa: F401

LR, GAMMA, STEPS = 1e-2, 0.5, 3
F64_TOL = 1e-6  # float64 relative L2
ROOMS = ("Area_1_office_1", "Area_2_office_1", "Area_5_office_1")


class _Cfg(dict):
    """A config as both packages' ``get_optimizer`` read it."""

    def __getattr__(self, key):
        return self[key]


def _dataset_cfg():
    class Dataset:
        cfg = Config({"class_weights": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8,
                                        9]})
    return Dataset()


class _FixedDropout(torch.nn.Module):
    """Dropout (rate 0.3) with the JAX net's keep masks, one a call in the
    order of the calls."""

    def __init__(self, keeps):
        super().__init__()
        self.keeps = list(keeps)

    def forward(self, x):
        keep = torch.from_numpy(self.keeps.pop(0))
        return torch.where(keep, x / (1.0 - 0.3), torch.zeros_like(x))


@pytest.fixture(scope="module")
def step():
    """The JAX net's train step at the small config in float64: its
    variables (float32 values), batch, loss, gradients, BN statistics,
    dropout keep masks and parameters after one Adam step, as numpy."""
    pts, feat = _cloud(50)
    labels = np.random.default_rng(51).integers(-1, 13, (B, N)).astype(
        np.int32)
    jm = jpv.PVCNN(ignored_label_inds=[-1], **SMALL)
    net = jm.get_net()
    variables = shape_variables(
        net, {"point": jnp.asarray(pts), "feat": jnp.asarray(feat)},
        seed=52, training=False)
    loss_obj = JaxLoss(None, jm, _dataset_cfg())
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                     t)
        params, stats = f64(variables["params"]), f64(
            variables["batch_stats"])
        jbatch = {"point": jnp.asarray(pts, jnp.float64),
                  "feat": jnp.asarray(feat, jnp.float64),
                  "label": jnp.asarray(labels)}

        def loss_fn(params):
            out, upd = net.apply(
                {"params": params, "batch_stats": stats}, jbatch,
                training=True, mutable=["batch_stats", "intermediates"],
                rngs={"dropout": jax.random.PRNGKey(7)},
                capture_intermediates=lambda mdl, _: isinstance(
                    mdl, fnn.Dropout))
            loss, _, _ = jm.get_loss(loss_obj, out, jbatch)
            return loss, (upd["batch_stats"], upd["intermediates"])

        (loss, (new_stats, inter)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
        tx, _ = jm.get_optimizer(_Cfg(optimizer={"lr": LR},
                                      scheduler_gamma=GAMMA,
                                      steps_per_epoch=STEPS))
        upd, _ = tx.update(grads, tx.init(params), params)
        tree = jax.tree.map(np.asarray, {
            "grads": grads["net"], "stats": new_stats["net"],
            "params": optax.apply_updates(params, upd)["net"]})
    drops = {jax.tree_util.keystr(path): v for path, v in
             jax.tree_util.tree_leaves_with_path(inter)}
    keeps = [np.asarray(next(v for k, v in drops.items()
                             if f"Dropout_{i}" in k)) != 0
             for i in range(2)]
    return {"variables": variables,
            "batch": {"point": pts, "feat": feat, "label": labels},
            "loss": float(loss), "keeps": keeps,
            **{k: dict(_by_port_name(v)) for k, v in tree.items()}}


def _by_port_name(tree, prefix=""):
    """A flax subtree's float64 leaves under the port's names (Dense
    kernels transposed, Conv3d kernels to [out, in, kd, kh, kw])."""
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _by_port_name(value, f"{prefix}{key}.")
            continue
        if key == "kernel":
            value = (value.T if value.ndim == 2 else
                     value.transpose(4, 3, 0, 1, 2))
        yield prefix + names[key], value


def _close(got, want, key):
    """A float64 tensor of the step within ``F64_TOL`` relative L2, or
    1e-12 absolute: a bias right before a train-mode BatchNorm has a
    gradient of 0 but for rounding."""
    diff = np.linalg.norm(got - want)
    assert diff <= F64_TOL * np.linalg.norm(want) + 1e-12, key


def test_train_step_matches_jax(step):
    """One step of the port in float64 on the JAX net's variables, batch
    and dropout masks against the JAX step in float64: the loss, every
    gradient, every BN statistic and every parameter after one Adam step
    of the port's ``get_optimizer`` within ``F64_TOL``. In float32 the
    two packages' gradients lie up to ~1e-3 apart at this config: the
    global feature's BatchNorm normalises over the B = 2 samples, which
    makes any float32 step ill-conditioned (``chip_smoke.py``'s pvcnn
    phase measures it at the shipped batch of 4)."""
    tm = PVCNN(ignored_label_inds=[-1], **SMALL)
    net = load_jax_variables(tm.get_net(), step["variables"]).double()
    net.train().dropout = _FixedDropout(step["keeps"])
    optimizer, scheduler = tm.get_optimizer(
        _Cfg(optimizer={"lr": LR}, scheduler_gamma=GAMMA,
             steps_per_epoch=STEPS), net)
    batch = {k: torch.from_numpy(v) for k, v in step["batch"].items()}
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}
    loss, _, _ = tm.get_loss(SemSegLoss(None, tm, _dataset_cfg()),
                             net(batch), batch)
    assert abs(loss.item() - step["loss"]) <= F64_TOL * abs(step["loss"])
    optimizer.zero_grad()
    loss.backward()
    named = dict(net.named_parameters())
    assert set(named) == set(step["grads"])
    for key, p in named.items():
        _close(p.grad.numpy(), step["grads"][key], key)
    sd = net.state_dict()
    for key, value in step["stats"].items():
        _close(sd[key].numpy(), value, key)
    optimizer.step()
    scheduler.step()
    for key, p in named.items():
        _close(p.detach().numpy(), step["params"][key], key)


def test_net_dropout_draws_from_its_own_generator():
    """The net's two dropouts draw from one generator of their own, seeded
    by ``manual_seed``: two nets seeded alike drop alike, the global
    generator untouched; eval mode drops nothing."""
    pts, feat = _cloud(53)
    x = {"point": torch.from_numpy(pts), "feat": torch.from_numpy(feat)}
    outs = []
    for _ in range(2):
        net = PVCNN(**SMALL).get_net().train()
        torch.manual_seed(0)
        net.load_state_dict(PVCNN(**SMALL).get_net().state_dict())
        net.dropout.manual_seed(5)
        before = torch.random.get_rng_state()
        with torch.no_grad():
            outs.append(net(x))
            assert not torch.equal(outs[-1], net(x))
            net.eval()
            assert torch.equal(net(x), net(x))
        assert torch.equal(before, torch.random.get_rng_state())
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_adam_and_schedule_equal_optax():
    """``get_optimizer``'s Adam under ``exponential_lr`` against the JAX
    package's ``optax.adam`` over 8 updates across two epoch boundaries
    (steps_per_epoch 3, gamma 0.5)."""
    cfg = _Cfg(optimizer={"lr": LR}, scheduler_gamma=GAMMA,
               steps_per_epoch=STEPS)
    tx, schedule = jpv.PVCNN().get_optimizer(cfg)
    w0 = np.linspace(-1, 1, 6).astype(np.float32)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    net = torch.nn.Linear(6, 1, bias=False)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(w0)[None])
    optimizer, scheduler = PVCNN().get_optimizer(cfg, net)
    assert isinstance(optimizer, torch.optim.Adam)
    rng = np.random.default_rng(41)
    for t in range(8):
        assert optimizer.param_groups[0]["lr"] == pytest.approx(
            float(schedule(t)), rel=1e-6)
        g = rng.normal(0, 1, 6).astype(np.float32)
        upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
        net.weight.grad = torch.from_numpy(g)[None].clone()
        optimizer.step()
        scheduler.step()
    np.testing.assert_allclose(net.weight[0].detach().numpy(),
                               np.asarray(params["w"]), rtol=1e-5, atol=1e-7)


def test_weight_decay_and_betas_are_not_read_in_either_package():
    """The YAML's ``optimizer.weight_decay`` and ``betas`` change no update
    in the JAX package (a JAX fault, mirrored): its Adam equals plain
    ``optax.adam`` under the same schedule; the port's Adam has weight
    decay 0 and betas (0.9, 0.999)."""
    params = {"w": jnp.asarray(np.linspace(-1, 1, 5, dtype=np.float32))}
    grads = {"w": jnp.asarray(np.linspace(2, 3, 5, dtype=np.float32))}
    cfg = _Cfg(optimizer={"lr": 0.001, "weight_decay": 0.5,
                          "betas": [0.5, 0.6]}, scheduler_gamma=0.99)
    tx, schedule = jpv.PVCNN().get_optimizer(cfg)
    plain = optax.adam(schedule)
    state, pstate = tx.init(params), plain.init(params)
    for _ in range(3):
        got, state = tx.update(grads, state, params)
        want, pstate = plain.update(grads, pstate, params)
        np.testing.assert_array_equal(np.asarray(got["w"]),
                                      np.asarray(want["w"]))
    optimizer, _ = PVCNN().get_optimizer(cfg, torch.nn.Linear(2, 1))
    group = optimizer.param_groups[0]
    assert (group["weight_decay"], group["betas"], group["eps"]) == \
        (0, (0.9, 0.999), 1e-8)


# ------------------------------------------------- the command line, S3DIS

def write_s3dis(root, rooms, n=2000, seed=0):
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


PV_SMALL = ["--model.num_points", "512", "--model.width_multiplier",
            "0.125", "--model.voxel_resolution_multiplier", "0.25",
            "--pipeline.num_workers", "0", "--pipeline.batch_size", "2",
            "--pipeline.val_batch_size", "1"]


def test_cli_trains_validates_and_resumes(tmp_path, monkeypatch):
    """``--split train`` from the port's YAML on an S3DIS tree (areas 1-2
    train, area 5 validates), at the small config: one epoch of two steps
    of 2 and one validation step, its checkpoint; then a run to epoch 1
    in the same log directory resumes from it (the net and Adam state as
    saved) and writes the next."""
    write_s3dis(tmp_path / "s3dis", ROOMS)
    steps, loaded = [], []
    real_step = SemanticSegmentation._train_step
    real_eval = SemanticSegmentation._eval_step
    real_load = SemanticSegmentation.load_ckpt

    def train_step(self, inputs, loss_fn):
        loss, cm = real_step(self, inputs, loss_fn)
        steps.append(("train", float(loss)))
        return loss, cm

    def eval_step(self, inputs, loss_fn):
        loss, cm = real_eval(self, inputs, loss_fn)
        steps.append(("eval", float(loss)))
        return loss, cm

    def load(self, *args, **kwargs):
        epoch = real_load(self, *args, **kwargs)
        loaded.append((epoch, {k: v.clone() for k, v in
                               self.net.state_dict().items()}))
        return epoch

    monkeypatch.setattr(SemanticSegmentation, "_train_step", train_step)
    monkeypatch.setattr(SemanticSegmentation, "_eval_step", eval_step)
    monkeypatch.setattr(SemanticSegmentation, "load_ckpt", load)
    common = ["-c", str(PV_YML), "--device", "cpu",
              "--dataset.dataset_path", str(tmp_path / "s3dis"),
              "--main_log_dir", str(tmp_path / "logs"),
              "--dataset.steps_per_epoch_train", "4",
              "--dataset.steps_per_epoch_valid", "1", "--split", "train",
              *PV_SMALL]
    ckpts = tmp_path / "logs" / "PVCNN_S3DIS_torch" / "checkpoint"
    run_pipeline.main(common + ["--pipeline.max_epoch", "0"])
    assert [k for k, _ in steps] == ["train", "train", "eval"]
    assert np.isfinite([v for _, v in steps]).all()
    saved = torch.load(ckpts / "ckpt_00000.pth", weights_only=True)
    assert saved["epoch"] == 0 and saved["optimizer"]["state"]
    run_pipeline.main(common + ["--pipeline.max_epoch", "1"])
    assert [e for e, _ in loaded] == [0, 1]
    for key, value in saved["model"].items():
        assert torch.equal(loaded[1][1][key], value), key
    assert (ckpts / "ckpt_00001.pth").exists() and len(steps) == 6


@pytest.mark.parametrize("split", ["test", "valid"])
def test_cli_refuses_the_patch_loop(split, tmp_path):
    """``--split test`` (and valid, which runs ``run_test`` for this
    pipeline) raise before the possibility-map loop starts, which would
    never end, naming the ROADMAP item."""
    write_s3dis(tmp_path / "s3dis", ROOMS[-1:], n=600)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        run_pipeline.main(["-c", str(PV_YML), "--device", "cpu",
                           "--dataset.dataset_path", str(tmp_path / "s3dis"),
                           "--main_log_dir", str(tmp_path / "logs"),
                           "--split", split, *PV_SMALL])


def test_test_loop_never_ends_in_either_package(tmp_path, monkeypatch):
    """The JAX fault the refusal mirrors: PVCNN's ``transform`` never
    calls the sampler, so the test loop's cloud generator (which moves on
    once a cloud's ``min_possibilities`` pass 0.5) yields the same cloud
    for ever. On JAX, a bounded run on a room of fewer points than
    ``num_points``: the pipeline's loop (``run_test_on_split``, its
    net's forward a stand-in of zero logits: no value the net gives
    moves the possibilities) with the generator stopped after 6 draws
    finalises no cloud and leaves the possibilities as they were. The
    port's data path leaves them alike, and its pipeline refuses the
    loop."""
    write_s3dis(tmp_path / "s3dis", ROOMS[-1:], n=200)
    real = jsr.SemSegSpatiallyRegularSampler.get_cloud_sampler
    drawn = []

    def bounded(self):
        gen = real(self)
        for _ in range(6):
            cid = next(gen)
            drawn.append((cid, list(self.min_possibilities)))
            yield cid

    monkeypatch.setattr(jsr.SemSegSpatiallyRegularSampler,
                        "get_cloud_sampler", bounded)
    jm = jpv.PVCNN(num_points=256, width_multiplier=0.125,
                   voxel_resolution_multiplier=0.25, seed=0)
    dataset = JaxS3DIS(dataset_path=str(tmp_path / "s3dis"),
                       test_area_idx=5, use_cache=False)
    pipeline = JaxPipeline(jm, dataset, main_log_dir=str(tmp_path / "jax"),
                           test_batch_size=2)
    monkeypatch.setattr(pipeline, "_make_infer_fn", lambda: (
        lambda params, stats, consts, batch: np.zeros(
            batch["point"].shape[:2] + (jm.cfg.num_classes,), np.float32)))
    pipeline.state = types.SimpleNamespace(params=None, batch_stats=None,
                                           consts={})
    test_split = dataset.get_split("test")
    loader = JaxLoader(dataset=test_split, preprocess=jm.preprocess,
                       transform=jm.transform, sampler=test_split.sampler)
    results = pipeline.run_test_on_split(loader, test_split.sampler)
    assert results == {} and pipeline.test_results == {}
    assert [cid for cid, _ in drawn] == [0] * 6
    assert all(m == drawn[0][1] and max(m) < 0.5 for _, m in drawn)

    split = S3DIS(dataset_path=str(tmp_path / "s3dis"),
                  test_area_idx=5).get_split("test")
    tm = PVCNN(num_points=256, seed=0)
    data = PointCloudDataloader(split, preprocess=tm.preprocess,
                                transform=tm.transform)
    sampler = split.sampler
    sampler.initialize_with_dataloader(data)
    tm.trans_point_sampler = sampler.get_point_sampler()
    before = list(sampler.min_possibilities)
    gen = sampler.get_cloud_sampler()
    for _ in range(3):
        assert data[next(gen)]["data"]["point"].shape == (256, 3)
    assert sampler.min_possibilities == before and max(before) < 0.5
    assert not PVCNN.draws_patches
    pipe = SemanticSegmentation(PVCNN(**SMALL), S3DIS(
        dataset_path=str(tmp_path / "s3dis"), test_area_idx=5),
        device="cpu", main_log_dir=str(tmp_path / "logs"))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        pipe.run_inference({"point": np.zeros((600, 3), np.float32),
                            "feat": None, "label": None})


def test_test_loop_accumulator_too_small_in_either_package(tmp_path):
    """A second JAX fault on the same loop, mirrored: the test split's
    possibility map, and so the loop's accumulator of probabilities, has
    a row for each point ``preprocess`` kept (``num_points`` of them),
    while ``update_probs`` writes at ``point_inds``, indices into the
    room. So on a room of more points than ``num_points`` (every S3DIS
    room at the shipped 40,960) the loop's first ``update_probs`` raises
    ``IndexError``, in both packages."""
    write_s3dis(tmp_path / "s3dis", ROOMS[-1:], n=600)
    for dataset, model, loader in (
            (JaxS3DIS, jpv.PVCNN, JaxLoader),
            (S3DIS, PVCNN, PointCloudDataloader)):
        split = dataset(dataset_path=str(tmp_path / "s3dis"),
                        test_area_idx=5).get_split("test")
        m = model(num_points=256, seed=0)
        data = loader(split, preprocess=m.preprocess, transform=m.transform)
        sampler = split.sampler
        sampler.initialize_with_dataloader(data)
        rows = sampler.possibilities[0].shape[0]
        assert rows == 256
        out = data[0]["data"]
        assert out["point_inds"].max() >= rows
        logits = np.zeros((1, 256, 13), np.float32)
        with pytest.raises(IndexError):
            m.update_probs({"point_inds": out["point_inds"][None]}, logits,
                           np.zeros((rows, 13), np.float16))


def test_chip_smoke_pvcnn_constants():
    """``chip_smoke.py`` drives the YAML's model section and the pipeline
    keys it reads without reading the YAML, expects one devoxelisation a
    PVConv block and one plan a resolution (and one backward a block a
    step), and its four path shapes are
    the shipped net's; ``pv_flops`` counts ~0.9 TFLOP for a forward of
    4 x 40,960."""
    cfg = Config.load_from_file(PV_YML)
    model = cfg.model.to_dict()
    assert chip_smoke.PVCNN_S3DIS == {k: model[k]
                                      for k in chip_smoke.PVCNN_S3DIS}
    assert set(chip_smoke.PVCNN_S3DIS) >= {
        "num_points", "width_multiplier", "voxel_resolution_multiplier",
        "extra_feature_channels", "num_classes"}
    pipe = cfg.pipeline.to_dict()
    assert chip_smoke.PVCNN_PIPELINE == {k: pipe[k]
                                         for k in chip_smoke.PVCNN_PIPELINE}
    net = chip_smoke.pv_model().get_net()
    assert chip_smoke.pv_shapes(net) == [(64, 64), (32, 64), (32, 64),
                                         (32, 128)]
    blocks = sum(isinstance(m, tpv.PVConv) for m in net.children())
    plans = len({r for r, _ in chip_smoke.pv_shapes(net)})
    assert chip_smoke.PV_FORWARD_LAUNCHES == {
        "trilinear_devoxelize": blocks, "trilinear_devoxelize_plan": plans}
    assert chip_smoke.PV_STEP_LAUNCHES == {
        "trilinear_devoxelize": blocks, "trilinear_devoxelize_plan": plans,
        "trilinear_devoxelize_bwd": blocks}
    flops = chip_smoke.pv_flops(net, 4, 40_960)
    assert 0.85e12 < flops < 0.95e12
    assert [r.split("_")[1] for r in chip_smoke.PV_ROOMS] == [
        "1", "2", "3", "4", str(cfg.dataset.test_area_idx)]
