"""Training the port's KPConv (KPFCNN) against the JAX package: one step of
a deformable net against ``jax.value_and_grad`` (the loss, the
point-to-point regularizer, every gradient and BN statistic), SGD with the
deform group against ``optax``, and the command line on S3DIS rooms and a
SemanticKITTI tree written into ``tmp_path``, with ``run_test`` ending and
``run_inference`` labelling every point.

The deformable net is the JAX tests' (``tests/test_kpconv.py``
``TestDeformable``: 256 points, width 16, two levels, two deformable
blocks), B = 2, on the JAX net's variables carried over with
``load_jax_variables``. In float32 the loss, the regularizer, each BN
statistic and each gradient lie within 1e-5 relative L2 (``TOL``) of
JAX's (4e-6 the largest, a gradient of the deepest block).
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from open3d_ml_tpu.models import KPFCNN as JaxKPFCNN
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxLoss
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu_torch import run_pipeline
from open3d_ml_tpu_torch.datasets import S3DIS
from open3d_ml_tpu_torch.models import KPFCNN, RandLANet
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
from open3d_ml_tpu_torch.utils import load_jax_variables, state_dict_to_jax

import chip_smoke
from test_torch_kpconv import (_batches, _cloud, _flat, _rel,
                               load_jax_native, to_jax, to_torch,
                               warm_cpu_kernels)
from test_torch_pointtransformer import write_s3dis
from test_torch_randlanet import REPO, _randomise_stats
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5  # float32 relative L2
DEFORM = dict(num_classes=6, lbl_values=list(range(7)),
              ignored_label_inds=[0], num_points=256, first_features_dim=16,
              in_features_dim=2, first_subsampling_dl=0.2, in_radius=3.0,
              neighborhood_limits=[10, 10], batch_norm_momentum=0.98,
              deform_fitting_power=1.0, repulse_extent=1.2,
              architecture=["simple", "resnetb_deformable",
                            "resnetb_deformable_strided", "resnetb",
                            "nearest_upsample", "unary"])
S3DIS_YML = REPO / "open3d_ml_tpu_torch/configs/kpconv_s3dis.yml"
KITTI_YML = REPO / "open3d_ml_tpu_torch/configs/kpconv_semantickitti.yml"
ROOMS = ("Area_1_office_1", "Area_2_office_1", "Area_5_office_1")


@pytest.fixture(scope="module", autouse=True)
def _warm():
    load_jax_native()
    warm_cpu_kernels()


class _Cfg(dict):
    """A pipeline config as both packages' ``get_optimizer`` read it."""

    def __getattr__(self, key):
        return self[key]


class _Dataset:
    cfg = Config({"class_weights": [3, 1, 4, 1, 5, 9]})


@pytest.fixture(scope="module")
def deform():
    """The deformable batch, the JAX variables (BN statistics drawn) and
    JAX's train step on them: loss, regularizer, gradients, statistics."""
    tm, jm = KPFCNN(**DEFORM), JaxKPFCNN(**DEFORM)
    tbatch, jbatch = _batches(tm, jm, _cloud(4, n=1500, extent=6.0))
    net = jm.get_net()
    jb = to_jax(jbatch)
    v = jax.tree.map(np.asarray, jax.jit(lambda b: net.init(
        {"params": jax.random.PRNGKey(0)}, b, training=False))(jb))
    v = {"params": v["params"], "kp_points": v["kp_points"],
         "batch_stats": _randomise_stats(v["batch_stats"],
                                         np.random.default_rng(5))}
    jloss = JaxLoss(None, jm, _Dataset())

    def loss_fn(params):
        out, upd = net.apply({**v, "params": params}, jb, training=True,
                             mutable=["batch_stats", "p2p_reg"])
        loss, _, _ = jm.get_loss(jloss, out, jb)
        reg = jm.regularizer_loss(upd)
        return loss + reg, (loss, reg, upd["batch_stats"])

    (total, (loss, reg, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    return {"batch": tbatch, "variables": v, "total": float(total),
            "loss": float(loss), "reg": float(reg),
            "grads": jax.tree.map(np.asarray, grads),
            "stats": jax.tree.map(np.asarray, stats)}


def _flax_key(key, value):
    """The dotted flax key of the port's parameter ``key``."""
    (flax_key, _), = _flat(state_dict_to_jax({key: value})["params"])
    return flax_key


def _port_grads(net):
    """The port's gradients as a flax tree's dotted keys."""
    grads = {k: p.grad for k, p in net.named_parameters()}
    return dict(_flat(state_dict_to_jax(grads)["params"]))


def test_deformable_train_step_matches_jax(deform):
    """One train step of the deformable net: the cross-entropy, the
    regularizer power * (2 * fitting + repulsive) (each term averaged over
    the batch, summed over the two deformable convolutions), their sum's
    gradient with respect to every parameter, and the BN statistics."""
    tm = KPFCNN(**DEFORM)
    net = load_jax_variables(tm.get_net(), deform["variables"]).train()
    batch = to_torch(deform["batch"])
    out = net(batch)
    loss, _, _ = tm.get_loss(SemSegLoss(None, tm, _Dataset()), out, batch)
    reg = tm.regularizer_loss(net)
    assert abs(float(loss) - deform["loss"]) <= TOL * deform["loss"]
    assert abs(float(reg) - deform["reg"]) <= TOL * deform["reg"]
    assert deform["reg"] > 0
    (loss + reg).backward()
    got = _port_grads(net)
    want = dict(_flat(deform["grads"]))
    assert set(got) == set(want)
    for key, value in want.items():
        assert _rel(got[key], value) <= TOL, key
    assert np.abs(want["net.enc1.KPConv.offset_bias"]).sum() > 0
    back = dict(_flat(state_dict_to_jax(net.state_dict())["batch_stats"]))
    for key, value in _flat(deform["stats"]):
        assert _rel(back[key], value) <= TOL, key


def test_regularizer_contracts():
    """0 for a rigid net and for the models without deformable
    convolutions; a fitting mode other than point2point raises, as in
    JAX; an eval-mode forward keeps no terms."""
    rigid = dict(DEFORM, architecture=["simple", "resnetb",
                                       "resnetb_strided", "resnetb",
                                       "nearest_upsample", "unary"])
    tm, jm = KPFCNN(**rigid), JaxKPFCNN(**rigid)
    tbatch, _ = _batches(tm, jm, _cloud(4, n=1500, extent=6.0))
    net = tm.get_net().train()
    net(to_torch(tbatch))
    assert tm.regularizer_loss(net) == 0.0
    assert RandLANet().regularizer_loss(net) == 0.0
    other = KPFCNN(**dict(DEFORM, deform_fitting_mode="point2plane"))
    dnet = other.get_net()
    with torch.no_grad():
        dnet.eval()(to_torch(tbatch))
    assert other.regularizer_loss(dnet) == 0.0
    dnet.train()(to_torch(tbatch))
    with pytest.raises(ValueError, match="point2plane"):
        other.regularizer_loss(dnet)


@pytest.mark.parametrize("factor", [0.1, 1.0])
def test_sgd_with_the_deform_group_equals_optax(deform, factor):
    """Three SGD steps (momentum 0.9, no dampening) under the exponential
    schedule (gamma 0.5 an epoch of 2 updates) from the same gradients:
    the parameters after each step within 1e-6 of optax's, the offset
    parameters at ``deform_lr_factor`` times the rate in both packages
    (one group at a factor of 1)."""
    cfg = _Cfg(optimizer={"lr": 0.1, "momentum": 0.9}, scheduler_gamma=0.5,
               steps_per_epoch=2, deform_lr_factor=factor)
    tm, jm = KPFCNN(**DEFORM), JaxKPFCNN(**DEFORM)
    net = load_jax_variables(tm.get_net(), deform["variables"])
    optimizer, scheduler = tm.get_optimizer(cfg, net)
    assert len(optimizer.param_groups) == (2 if factor != 1.0 else 1)
    if factor != 1.0:
        names = {id(p): k for k, p in net.named_parameters()}
        offsets = [names[id(p)] for p in optimizer.param_groups[1]["params"]]
        assert offsets and all("offset" in k for k in offsets)
        assert optimizer.param_groups[1]["lr"] == pytest.approx(0.1 * factor)
    tx, _ = jm.get_optimizer(cfg)
    params = deform["variables"]["params"]
    state = tx.init(params)
    rng = np.random.default_rng(6)
    for _ in range(3):
        grads = jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(
            np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params,
                                                              updates))
        by_name = dict(_flat(grads))
        for key, p in net.named_parameters():
            g = by_name[_flax_key(key, p)]
            p.grad = torch.from_numpy(np.ascontiguousarray(
                g.T if p.dim() == 2 else g))
        optimizer.step()
        scheduler.step()
        back = dict(_flat(state_dict_to_jax(net.state_dict())["params"]))
        for key, value in _flat(params):
            np.testing.assert_allclose(back[key], value, rtol=1e-6,
                                       atol=1e-7, err_msg=key)


def test_rigid_yaml_keeps_one_group():
    """The SemanticKITTI YAML sets ``deform_lr_factor`` 0.1, but its
    architecture has no deformable block: one group at the base rate, in
    both packages, with the YAML's SGD settings."""
    cfg = Config.load_from_file(KITTI_YML)
    pipe = _Cfg(cfg.pipeline.to_dict(), steps_per_epoch=3)
    tm = KPFCNN(**cfg.model.to_dict())
    optimizer, _ = tm.get_optimizer(pipe, tm.get_net())
    assert len(optimizer.param_groups) == 1
    group = optimizer.param_groups[0]
    assert (group["lr"], group["momentum"], group["dampening"],
            group["nesterov"], group["weight_decay"]) == (0.01, 0.98, 0,
                                                          False, 0)
    tx, _ = JaxKPFCNN(**cfg.model.to_dict()).get_optimizer(pipe)
    params = {"KPConv": {"offset_bias": jnp.ones(3), "weights": jnp.ones(3)}}
    updates, _ = tx.update(params, tx.init(params), params)
    np.testing.assert_array_equal(updates["KPConv"]["offset_bias"],
                                  updates["KPConv"]["weights"])


def test_pipeline_step_adds_the_regularizer(deform, tmp_path):
    """``SemanticSegmentation._train_step`` reports and descends the loss
    plus ``regularizer_loss``, as the JAX step does."""
    tm = KPFCNN(**DEFORM)
    pipe = SemanticSegmentation(tm, device="cpu", seed=0,
                                main_log_dir=str(tmp_path))
    load_jax_variables(pipe.net, deform["variables"])
    pipe.optimizer, pipe.scheduler = tm.get_optimizer(
        _Cfg(optimizer={"lr": 0.0, "momentum": 0.9}), pipe.net)
    loss, cm = pipe._train_step(to_torch(deform["batch"]),
                                SemSegLoss(None, tm, _Dataset()))
    assert abs(float(loss) - deform["total"]) <= TOL * deform["total"]
    assert int(cm.sum()) == 2 * 256


# ------------------------------------------------------- the command line

def _common(tmp_path, yml, root, points=512):
    return ["-c", str(yml), "--device", "cpu",
            "--dataset.dataset_path", str(root),
            "--main_log_dir", str(tmp_path / "logs"),
            "--dataset.cache_dir", str(tmp_path / "cache"),
            "--dataset.test_result_folder", str(tmp_path / "test"),
            "--pipeline.num_workers", "0", "--pipeline.max_epoch", "0",
            "--model.num_points", str(points)]


def test_cli_trains_and_tests_on_s3dis_rooms(tmp_path, monkeypatch):
    """``kpconv_s3dis.yml`` at full width and depth, 512-point patches:
    ``--split train`` (the two training rooms, one step each, one
    validation step; finite losses, the checkpoint), then ``--split
    test`` on the Area 5 room: 1.5 m balls until the room is covered, the
    loop ends, and every input point gets a label. The features are the
    4 columns [1, r, g, b]."""
    write_s3dis(tmp_path / "s3dis", ROOMS)
    losses, widths = [], []
    real_step = SemanticSegmentation._train_step

    def step(self, inputs, loss_fn):
        widths.append(inputs["features"].shape[-1])
        loss, cm = real_step(self, inputs, loss_fn)
        losses.append(float(loss))
        return loss, cm

    monkeypatch.setattr(SemanticSegmentation, "_train_step", step)
    argv = _common(tmp_path, S3DIS_YML, tmp_path / "s3dis")
    run_pipeline.main(argv + ["--split", "train"])
    logs = tmp_path / "logs" / "KPFCNN_S3DIS_torch"
    assert (logs / "checkpoint" / "ckpt_00000.pth").exists()
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert widths == [4, 4]

    patches = []
    real_test = SemanticSegmentation.run_test_on_split

    def count(self, *args, **kwargs):
        real = self.eval_net.forward
        self.eval_net.forward = lambda b: patches.append(1) or real(b)
        return real_test(self, *args, **kwargs)

    monkeypatch.setattr(SemanticSegmentation, "run_test_on_split", count)
    run_pipeline.main(argv + ["--split", "test"])
    pred = np.load(tmp_path / "test" / "S3DIS" / "Area_5_office_1.npy")
    with open(tmp_path / "s3dis" / "original_pkl" /
              "Area_5_office_1.pkl", "rb") as f:
        n = pickle.load(f)[0].shape[0]
    assert pred.shape == (n,)
    assert pred.min() >= 0 and pred.max() < 13
    assert len(patches) > 1


def test_cli_trains_on_semantickitti(tmp_path, monkeypatch):
    """``kpconv_semantickitti.yml`` as shipped (``in_features_dim`` 2:
    the features [1, z], not the reader's remission) over a SemanticKITTI
    tree of ``chip_smoke.write_semantickitti``: one train step and one
    validation step of 512-point patches."""
    chip_smoke.write_semantickitti(tmp_path / "kitti", 3000,
                                   scans={"00": 1, "08": 1})
    losses = []
    real_step = SemanticSegmentation._train_step

    def step(self, inputs, loss_fn):
        assert inputs["features"].shape[-1] == 2
        loss, cm = real_step(self, inputs, loss_fn)
        losses.append(float(loss))
        return loss, cm

    monkeypatch.setattr(SemanticSegmentation, "_train_step", step)
    run_pipeline.main(_common(tmp_path, KITTI_YML, tmp_path / "kitti") +
                      ["--split", "train"])
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert (tmp_path / "logs" / "KPFCNN_SemanticKITTI_torch" / "checkpoint" /
            "ckpt_00000.pth").exists()


def test_run_inference_labels_every_point(tmp_path):
    """``run_inference`` on one S3DIS room through the S3DIS YAML's model
    (512-point patches): one label and one probability row per input
    point, every row blended from at least one patch (the accumulator
    starts at 0 and takes 0.02 of each patch's probabilities)."""
    write_s3dis(tmp_path / "s3dis", ROOMS[-1:], n=2500, seed=3)
    with open(tmp_path / "s3dis" / "original_pkl" / f"{ROOMS[-1]}.pkl",
              "rb") as f:
        pc = pickle.load(f)[0]
    cfg = Config.load_from_file(S3DIS_YML)
    model = KPFCNN(**dict(cfg.model.to_dict(), num_points=512, seed=1))
    dataset = S3DIS(dataset_path=str(tmp_path / "s3dis"))
    pipe = SemanticSegmentation(model, dataset, device="cpu", seed=2,
                                main_log_dir=str(tmp_path / "logs"))
    out = pipe.run_inference({"point": pc[:, :3], "feat": pc[:, 3:6],
                              "label": None})
    assert out["predict_labels"].shape == (len(pc),)
    assert out["predict_scores"].shape == (len(pc), 13)
    assert np.isfinite(out["predict_scores"].astype(np.float32)).all()
    assert (out["predict_scores"].astype(np.float32).sum(-1) > 0.0).all()


def test_chip_smoke_kpconv_request():
    """``chip_smoke.py``'s kpconv phase: its cloud is the bench's
    (``bench.py`` ``_lidar_cloud``), its configs are the port's YAMLs, and
    its test room lies in the S3DIS YAML's test area."""
    import bench
    np.testing.assert_array_equal(chip_smoke.kp_cloud(2000, 5),
                                  bench._lidar_cloud(2000, 5))
    for name, path in chip_smoke.KP_CONFIGS.items():
        cfg = Config.load_from_file(REPO / path)
        assert cfg.model.name == "KPFCNN"
        assert cfg.dataset.name.lower() == name
    area = Config.load_from_file(S3DIS_YML).dataset.test_area_idx
    assert chip_smoke.KP_TEST_ROOM.startswith(f"Area_{area}_")
    assert chip_smoke.KP_TRAIN_SCANS["00"] > 1


@pytest.mark.slow
def test_full_width_eval_matches_jax():
    """The shipped SemanticKITTI net (5 levels, width 128, 13 KPConvs) on
    JAX variables (BN statistics drawn), B = 1, 2,048-point patches of a
    lidar cloud: eval logits within ``TOL`` (~30 s on the CPU)."""
    from test_torch_kpconv import _assert_equal_samples
    from open3d_ml_tpu.dataloaders import DefaultBatcher as JaxBatcher
    from open3d_ml_tpu.datasets.samplers import SemSegRandomSampler as JR
    from open3d_ml_tpu_torch.dataloaders import DefaultBatcher
    from open3d_ml_tpu_torch.datasets.samplers import SemSegRandomSampler
    cfg = Config.load_from_file(KITTI_YML).model.to_dict()
    cfg.pop("name")
    cfg["num_points"] = 2048
    tm, jm = KPFCNN(**cfg), JaxKPFCNN(**cfg)
    data = {"point": chip_smoke.kp_cloud(20000, 1), "feat": None,
            "label": np.zeros(20000, np.int32)}
    attr = {"split": "test"}
    tm.trans_point_sampler = SemSegRandomSampler.get_point_sampler()
    jm.trans_point_sampler = JR.get_point_sampler()
    got = tm.transform(tm.preprocess(data, attr), attr,
                       rng=np.random.default_rng(2))
    want = jm.transform(jm.preprocess(data, attr), attr,
                        rng=np.random.default_rng(2))
    _assert_equal_samples(got, want)
    tbatch = DefaultBatcher().collate_fn([{"data": got}])["data"]
    jb = to_jax(JaxBatcher().collate_fn([{"data": want}])["data"])
    net = jm.get_net()
    v = jax.tree.map(np.asarray, jax.jit(lambda b: net.init(
        {"params": jax.random.PRNGKey(3)}, b, training=False))(jb))
    v["batch_stats"] = _randomise_stats(v["batch_stats"],
                                        np.random.default_rng(4))
    logits = np.asarray(jax.jit(lambda v, b: net.apply(
        v, b, training=False))(v, jb))
    tnet = load_jax_variables(tm.get_net(), v).eval()
    with torch.no_grad():
        out = tnet(to_torch(tbatch)).numpy()
    assert _rel(out, logits) <= TOL
