"""RandLA-Net at the four other shipped YAMLs through the readers, the
training step and the command line, against the JAX package on the CPU;
and ``randlanet_pandaset.yml`` through its reader and the command line.

The readers' files are written into ``tmp_path`` by ``chip_smoke``'s
writers (``write_rc_data``: S3DIS rooms, Semantic3D text scans, Toronto3D
and ParisLille3D PLY tiles, PandaSet pickles), which both packages'
readers read alike. Per
YAML, at small shapes (1,024-point patches at the YAML's widths for the
command line, 2,560 at narrow widths for the step; float32, the loader
in this thread) with its channels, classes, ignored labels and class
weights:

* one fused training step against ``jax.value_and_grad`` with the JAX
  net's dropout mask, as ``tests/test_torch_train.py`` holds
  SemanticKITTI's: loss, gradients, BN statistics;
* ``run_pipeline --split train`` then ``--split test``: a checkpoint, the
  TensorBoard scalars, and the predictions in the reader's own format;
* ``run_test_on_split`` in both packages' pipelines, built by each
  command line from the same YAML and overrides, on the same weights and
  sampler seed: the float16 scores within one float16 ulp.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator)

import chip_smoke
import open3d_ml_tpu.datasets as jax_datasets
from open3d_ml_tpu.dataloaders.dataloader import (
    PointCloudDataloader as JaxLoader)
from open3d_ml_tpu.models import randlanet as jrl
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxSemSegLoss
from open3d_ml_tpu.pipelines.semantic_segmentation import TrainState
from open3d_ml_tpu.utils import Config as JaxConfig
import open3d_ml_tpu_torch.datasets as port_datasets
from open3d_ml_tpu_torch import run_pipeline
from open3d_ml_tpu_torch.dataloaders import PointCloudDataloader
from open3d_ml_tpu_torch.models import RandLANet
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
from open3d_ml_tpu_torch.utils import Config, load_jax_variables
from open3d_ml_tpu_torch.utils.convert_jax import jax_to_state_dict

from test_torch_cli import F16_ULP, _jax_build
from test_torch_datasets import _same_value
from test_torch_randla_configs import (YAMLS, _Data, _rel_l2, batch_for,
                                       jax_variables, yaml_cfg)
from test_torch_train import _FixedDropout
from torch_threads import one_torch_thread  # noqa: F401

READERS = {"s3dis": "S3DIS", "semantic3d": "Semantic3D",
           "toronto3d": "Toronto3D", "parislille3d": "ParisLille3D",
           "pandaset": "Pandaset"}
CLOUD, TEST_CLOUD = 2500, 4000
# the YAMLs' widths at 1,024-point patches, float32, the loader in this
# thread
SMALL = ["--model.num_points", "1024", "--model.compute_dtype", "float32",
         "--pipeline.num_workers", "0", "--device", "cpu"]
SAMPLER_SEED = 4


def _argv(name, root, *extra):
    return ["-c", str(chip_smoke.REPO / chip_smoke.RC_CONFIGS[READERS[name]]),
            "--dataset.dataset_path", str(root / "data"),
            "--dataset.cache_dir", str(root / "cache"),
            "--dataset.test_result_folder", str(root / "test"),
            "--main_log_dir", str(root / "logs"),
            "--pipeline.train_sum_dir", str(root / "tb"), *SMALL, *extra]


@pytest.mark.parametrize("name", list(READERS))
def test_writers_feed_both_readers(name, tmp_path):
    """``chip_smoke.write_rc_data``'s files: both packages' readers list
    the same clouds in every split and give the same arrays, bit for
    bit; the test split holds the one cloud ``write_rc_data`` names."""
    reader = READERS[name]
    cloud, _ = chip_smoke.write_rc_data(reader, tmp_path, 600, 900)
    kwargs = {"dataset_path": str(tmp_path)}
    if reader == "S3DIS":
        kwargs["test_area_idx"] = 5  # the YAML's
    port = getattr(port_datasets, reader)(**kwargs)
    jaxd = getattr(jax_datasets, reader)(**kwargs)
    for split in ("training", "validation", "test"):
        got, want = port.get_split(split), jaxd.get_split(split)
        assert len(got) == len(want) > 0, split
        for i in range(len(want)):
            assert got.get_attr(i) == want.get_attr(i)
            g, w = got.get_data(i), want.get_data(i)
            assert set(g) == set(w)
            for key, value in w.items():
                _same_value(g[key], value, f"{split} {i} {key}")
    assert [port.get_split("test").get_attr(0)["name"]] == [cloud]


def test_cli_trains_and_tests_pandaset(tmp_path):
    """``run_pipeline`` on ``randlanet_pandaset.yml`` with
    ``chip_smoke.RC_CLI_EXTRAS`` (3 + 1 input channels: the reader gives
    the intensity as a feature) on ``chip_smoke.write_pandaset``'s
    frames: ``--split train`` (4 steps of 4 patches, 2 validation steps of
    2) writes a checkpoint and the six scalars; ``--split test`` with it
    labels every point of the test frame, in [0, 39), in
    ``<test_result_folder>/115_00.npy`` (no dataset folder, no label
    shifted in)."""
    cloud, test_n = chip_smoke.write_rc_data("Pandaset", tmp_path / "data",
                                             CLOUD, TEST_CLOUD)
    extras = chip_smoke.RC_CLI_EXTRAS["Pandaset"]
    run_pipeline.main(_argv("pandaset", tmp_path, *extras, "--split",
                            "train", "--pipeline.max_epoch", "0",
                            "--dataset.steps_per_epoch_train", "16",
                            "--dataset.steps_per_epoch_valid", "4"))
    ckpt = (tmp_path / "logs" / "RandLANet_Pandaset_torch" / "checkpoint" /
            "ckpt_00000.pth")
    assert ckpt.exists()
    (run,) = (tmp_path / "tb").iterdir()
    acc = EventAccumulator(str(run))
    acc.Reload()
    assert set(chip_smoke.TB_SCALARS) == set(acc.Tags()["scalars"])
    run_pipeline.main(_argv("pandaset", tmp_path, *extras, "--split", "test",
                            "--ckpt_path", str(ckpt)))
    assert cloud == "115_00" and test_n == CLOUD
    pred = chip_smoke.read_predictions("Pandaset", tmp_path / "test", cloud)
    assert pred.shape == (test_n,)
    assert pred.min() >= 0 and pred.max() < 39


def _jax_step(cfg, dataset, variables, batch):
    """Loss, gradients, BN statistics and the dropout keep mask of one JAX
    fused training step."""
    model = jrl.RandLANet(**cfg)
    net = model.get_net()
    loss_obj = JaxSemSegLoss(None, model, _Data(JaxConfig, dataset))
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
    tree = jax.tree.map(np.asarray, {"grads": grads, "stats": stats})
    return {"loss": float(loss),
            "grads": jax_to_state_dict({"params": tree["grads"]}),
            "stats": jax_to_state_dict({"batch_stats": tree["stats"]}),
            "keep": np.asarray(dropped) != 0}


@pytest.mark.parametrize("name", YAMLS)
def test_train_step_matches_jax(name):
    """One float32 fused step at ``tests/test_torch_train.py``'s size (2 x
    2,560 points, ``dim_output`` 8, 16, 32, 32) with the YAML's channels,
    classes, class weights and ignored labels, the JAX dropout mask: the
    loss within 1e-6, the gradients within 1e-5 relative L2 over all, the
    running statistics within 1e-6 of each tensor's largest entry. (At
    2,048 points and widths of 16 the float32 gradients of both packages
    lie 1e-4 to 1e-3 apart: the deep levels' BatchNorm over a few points
    is ill-conditioned there.)"""
    cfg, dataset = yaml_cfg(name, num_points=2560, dim_output=[8, 16, 32, 32])
    batch = batch_for(cfg, 31)
    jbatch = {k: jnp.asarray(batch[k]) for k in ("coords", "features")}
    variables = jax_variables(jrl.RandLANet(**cfg).get_net(), jbatch, 13)
    ref = _jax_step(cfg, dataset, variables, batch)

    model = RandLANet(**cfg)
    data = _Data(Config, dataset)
    pipe = SemanticSegmentation(model, dataset=data, device="cpu", seed=0,
                                optimizer={"lr": 1e-3})
    load_jax_variables(pipe.net, variables)
    pipe.net.dropout = _FixedDropout(torch.from_numpy(ref["keep"]))
    pipe.optimizer, pipe.scheduler = model.get_optimizer(pipe.cfg, pipe.net)
    loss, _ = pipe._train_step({k: torch.from_numpy(v)
                                for k, v in batch.items()},
                               SemSegLoss(pipe, model, data))
    assert abs(float(loss) - ref["loss"]) <= 1e-6 * abs(ref["loss"])
    names = sorted(ref["grads"])
    got = np.concatenate([dict(pipe.net.named_parameters())[k].grad.numpy()
                          .ravel() for k in names])
    want = np.concatenate([ref["grads"][k].numpy().ravel() for k in names])
    assert _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)
    sd = pipe.net.state_dict()
    for key, value in ref["stats"].items():
        err = np.abs(sd[key].numpy() - value.numpy()).max()
        assert err <= 1e-6 * np.abs(value.numpy()).max(), key


@pytest.mark.parametrize("name", YAMLS)
def test_cli_trains_and_tests(name, tmp_path):
    """``run_pipeline`` on the YAML: ``--split train`` (4 steps of 4
    patches, 2 validation steps of 2) writes a checkpoint and the six
    scalars; ``--split test`` with it labels every point of the test
    cloud, saved in the reader's format (Semantic3D ``.labels`` text,
    the others ``.npy``) with the ignored label shifted in."""
    reader = READERS[name]
    cloud, test_n = chip_smoke.write_rc_data(reader, tmp_path / "data",
                                             CLOUD, TEST_CLOUD)
    run_pipeline.main(_argv(name, tmp_path, "--split", "train",
                            "--pipeline.max_epoch", "0",
                            "--dataset.steps_per_epoch_train", "16",
                            "--dataset.steps_per_epoch_valid", "4"))
    ckpt = (tmp_path / "logs" / f"RandLANet_{reader}_torch" / "checkpoint" /
            "ckpt_00000.pth")
    state = torch.load(ckpt, weights_only=True)
    assert all(torch.isfinite(v).all() for v in state["model"].values()
               if v.is_floating_point())
    (run,) = (tmp_path / "tb").iterdir()
    acc = EventAccumulator(str(run))
    acc.Reload()
    assert set(chip_smoke.TB_SCALARS) == set(acc.Tags()["scalars"])
    run_pipeline.main(_argv(name, tmp_path, "--split", "test",
                            "--ckpt_path", str(ckpt)))
    pred = chip_smoke.read_predictions(reader, tmp_path / "test", cloud)
    cfg = RandLANet(**yaml_cfg(name)[0]).cfg
    ignored = len(cfg.ignored_label_inds)
    assert pred.shape == (test_n,)
    assert pred.min() >= ignored
    assert pred.max() < cfg.num_classes + ignored


@pytest.mark.parametrize("name", YAMLS)
def test_test_predictions_match_jax(name, tmp_path, monkeypatch):
    """Both packages' pipelines from the YAML and the same overrides, the
    JAX eval net's variables in the port, ``run_test_on_split`` over the
    test split with the samplers seeded alike: the float16 scores within
    one float16 ulp at 1, the labels equal where a point's two top scores
    are further apart."""
    monkeypatch.setenv("OPEN3D_ML_TPU_COMPILE_CACHE", "0")
    reader = READERS[name]
    chip_smoke.write_rc_data(reader, tmp_path / "data", CLOUD, TEST_CLOUD)
    argv = _argv(name, tmp_path, "--split", "test", "--seed", "3",
                 "--dataset.use_cache", "false")
    tpipe, split = run_pipeline.build_pipeline(
        *run_pipeline.parse_args(argv))
    jpipe = _jax_build(argv, monkeypatch)
    assert split == "test"
    cfg = tpipe.model.cfg
    batch = {"coords": jnp.zeros((1, cfg.num_points, 3), jnp.float32),
             "features": jnp.zeros((1, cfg.num_points, cfg.in_channels),
                                   jnp.float32)}
    variables = jax_variables(jpipe.model.get_eval_net(), batch, 17)
    jpipe.state = TrainState(params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=(), step=jnp.zeros((), jnp.int32))
    load_jax_variables(tpipe.net, variables)

    results = []
    for pipe, loader in ((jpipe, JaxLoader), (tpipe, PointCloudDataloader)):
        test_split = pipe.dataset.get_split("test")
        test_split.sampler.rng = np.random.default_rng(SAMPLER_SEED)
        data = loader(dataset=test_split, preprocess=pipe.model.preprocess,
                      transform=pipe.model.transform,
                      sampler=test_split.sampler, use_cache=False)
        results.append(pipe.run_test_on_split(data, test_split.sampler))
    want, got = results
    assert sorted(got) == sorted(want) == [0]
    ws, gs = want[0]["predict_scores"], got[0]["predict_scores"]
    assert gs.dtype == ws.dtype == np.float16
    assert gs.shape == (TEST_CLOUD, cfg.num_classes)
    np.testing.assert_allclose(gs.astype(np.float32), ws.astype(np.float32),
                               rtol=0, atol=F16_ULP)
    top2 = np.sort(ws.astype(np.float32), axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > F16_ULP
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[0]["predict_labels"][clear],
                                  want[0]["predict_labels"][clear])


def test_chip_smoke_configs_are_the_shipped_yamls():
    """``chip_smoke``'s five YAMLs are the port's copies, equal to the JAX
    package's, and its models take their model sections whole."""
    for reader, path in chip_smoke.RC_CONFIGS.items():
        port = Config.load_from_file(chip_smoke.REPO / path)
        jax_cfg = JaxConfig.load_from_file(
            chip_smoke.REPO / path.replace("open3d_ml_tpu_torch",
                                           "open3d_ml_tpu"))
        assert port.dataset.name == reader
        assert port.to_dict() == jax_cfg.to_dict()
        cfg = chip_smoke.randla_yaml(reader).cfg
        for key, value in port.model.to_dict().items():
            if key != "name":
                assert cfg[key] == value, (reader, key)
