"""The port's command line (``python -m open3d_ml_tpu_torch.run_pipeline``)
on the CPU at small shapes: RandLA-Net trains from the port's
``randlanet_semantickitti.yml`` on a SemanticKITTI tree in ``tmp_path``
and tests its checkpoint, writing SemanticKITTI ``.label`` files; the test
predictions equal the JAX pipeline's, built through the JAX command line's
config route from the same YAML and overrides, on the same weights;
SparseConvUnet trains from ``sparseconvunet_scannet.yml`` on ScanNet
rooms; the seed draws, the split dispatch and the refusals (``--device
tpu``, ``cuda`` with no card, ``--distributed`` outside torchrun,
SparseConvUnet's test and valid splits, which the pipeline itself
refuses).

Every run overrides ``--model.in_channels 4``: SemanticKITTI's reader
gives each point's remission as a feature (in the JAX package too), so
the shipped YAML's 3 makes ``transform`` refuse the reader's clouds.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from open3d_ml_tpu.dataloaders.dataloader import (
    PointCloudDataloader as JaxLoader)
from open3d_ml_tpu.pipelines.semantic_segmentation import TrainState
from open3d_ml_tpu.utils import Config as JaxConfig
from open3d_ml_tpu.utils import get_module as jax_get_module
from open3d_ml_tpu_torch import run_pipeline
from open3d_ml_tpu_torch.dataloaders import PointCloudDataloader
from open3d_ml_tpu_torch.datasets import Scannet
from open3d_ml_tpu_torch.datasets._resources.semantickitti import (
    LEARNING_MAP_INV)
from open3d_ml_tpu_torch.models.sparseconvunet import SparseConvUnet
from open3d_ml_tpu_torch.pipelines.semantic_segmentation import (
    SemanticSegmentation)
from open3d_ml_tpu_torch.utils import load_jax_variables

from test_torch_eval import _init
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RANDLANET_YML = REPO / chip_smoke.CLI_CONFIGS["randlanet"]
SCU_YML = REPO / chip_smoke.CLI_CONFIGS["scu"]
SCAN_POINTS = 3000
# small shapes: 2,048-point patches (levels of 512, 128, 32 and 8 points)
# at the YAML's widths, float32, the loader in this thread
SMALL = ["--model.in_channels", "4", "--model.num_points", "2048",
         "--model.compute_dtype", "float32", "--pipeline.num_workers", "0"]
SCU_SMALL = ["--model.num_levels", "3", "--model.multiplier", "4",
             "--model.num_points", "2048", "--model.max_voxels", "2048",
             "--pipeline.num_workers", "0"]
SAMPLER_SEED = 4
# float16 accumulators: one unit in the last place at 1
F16_ULP = 2.0 ** -10


def _kitti_argv(root, *extra):
    return ["-c", str(RANDLANET_YML), "--device", "cpu",
            "--dataset.dataset_path", str(root / "kitti"),
            "--dataset.cache_dir", str(root / "cache"),
            "--dataset.test_result_folder", str(root / "test"),
            "--main_log_dir", str(root / "logs"), *SMALL, *extra]


def test_cli_trains_and_tests_semantickitti(tmp_path):
    scans = chip_smoke.write_semantickitti(tmp_path / "kitti", SCAN_POINTS,
                                           {"00": 2, "08": 1, "11": 2})
    run_pipeline.main(_kitti_argv(
        tmp_path, "--split", "train", "--pipeline.max_epoch", "0",
        "--dataset.steps_per_epoch_train", "4",
        "--dataset.steps_per_epoch_valid", "2"))
    ckpt = (tmp_path / "logs" / "RandLANet_SemanticKITTI_torch" /
            "checkpoint" / "ckpt_00000.pth")
    assert ckpt.exists()
    state = torch.load(ckpt, weights_only=True)
    assert state["epoch"] == 0
    assert all(torch.isfinite(v).all() for v in state["model"].values()
               if v.is_floating_point())
    run_pipeline.main(_kitti_argv(tmp_path, "--split", "test",
                                  "--ckpt_path", str(ckpt)))
    written = sorted((tmp_path / "test" / "sequences" / "11" /
                      "predictions").glob("*.label"))
    assert [p.stem for p in written] == [p.stem for p in scans["11"]]
    raw = set(LEARNING_MAP_INV.values())
    for path in written:
        pred = np.fromfile(path, np.uint32)
        assert pred.shape == (SCAN_POINTS,)
        assert set(np.unique(pred).tolist()) <= raw


def _jax_cli_module():
    spec = importlib.util.spec_from_file_location(
        "jax_run_pipeline", REPO / "scripts" / "run_pipeline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_build(argv, monkeypatch):
    """The JAX command line's build (``scripts/run_pipeline.py:78-101``):
    its own argument parser, config merge, registries and seed draws."""
    monkeypatch.setattr(sys, "argv", ["run_pipeline.py", *argv])
    args, extra = _jax_cli_module().parse_args()
    rng = np.random.default_rng(args.seed)
    cfg = JaxConfig.load_from_file(args.cfg_file)
    cfg_dataset, cfg_model, cfg_pipeline = JaxConfig.merge_cfg_file(
        cfg, args, extra)
    model_kwargs = cfg_model.to_dict()
    pipe_kwargs = cfg_pipeline.to_dict()
    model_kwargs.setdefault("seed", int(rng.integers(1 << 31)))
    pipe_kwargs.setdefault("seed", int(rng.integers(1 << 31)))
    dataset = jax_get_module("dataset", cfg.dataset.name)(
        **cfg_dataset.to_dict())
    model = jax_get_module("model", cfg.model.name)(**model_kwargs)
    return jax_get_module("pipeline", cfg.pipeline.name)(
        model, dataset, **pipe_kwargs)


def test_cli_test_predictions_match_jax(tmp_path, monkeypatch):
    """Both packages' pipelines from the same YAML and overrides, the JAX
    eval net's variables copied into the port, ``run_test_on_split`` over
    the test split with the samplers seeded alike: the float16 scores
    agree within one float16 ulp at 1, and the labels are equal but where
    a cloud's two top scores lie within it."""
    monkeypatch.setenv("OPEN3D_ML_TPU_COMPILE_CACHE", "0")
    chip_smoke.write_semantickitti(tmp_path / "kitti", SCAN_POINTS,
                                   {"11": 2})
    argv = _kitti_argv(tmp_path, "--split", "test", "--seed", "3",
                       "--dataset.use_cache", "false")
    tpipe, split = run_pipeline.build_pipeline(
        *run_pipeline.parse_args(argv))
    jpipe = _jax_build(argv, monkeypatch)
    assert split == "test"
    assert tpipe.model.cfg.seed == jpipe.model.cfg.seed
    assert tpipe.cfg.seed == jpipe.cfg.seed == 3

    jmodel, tmodel = jpipe.model, tpipe.model
    coords = jnp.zeros((1, tmodel.cfg.num_points, 3), jnp.float32)
    feats = jnp.zeros((1, tmodel.cfg.num_points, 4), jnp.float32)
    variables = _init(jmodel.get_eval_net(),
                      {"coords": coords, "features": feats})
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
    assert sorted(got) == sorted(want) == [0, 1]
    for cid in want:
        ws, gs = want[cid]["predict_scores"], got[cid]["predict_scores"]
        assert gs.dtype == ws.dtype == np.float16
        assert gs.shape == (SCAN_POINTS, 19) and np.isfinite(gs).all()
        np.testing.assert_allclose(gs.astype(np.float32),
                                   ws.astype(np.float32), rtol=0,
                                   atol=F16_ULP)
        top2 = np.sort(ws.astype(np.float32), axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > F16_ULP
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got[cid]["predict_labels"][clear],
                                      want[cid]["predict_labels"][clear])


def test_cli_trains_scu_on_scannet_rooms(tmp_path):
    chip_smoke.write_scannet_rooms(tmp_path / "scannet", 2048,
                                   {"train": 2, "val": 1})
    run_pipeline.main([
        "-c", str(SCU_YML), "--device", "cpu",
        "--dataset.dataset_path", str(tmp_path / "scannet"),
        "--main_log_dir", str(tmp_path / "logs"), "--split", "train",
        "--pipeline.max_epoch", "0", "--pipeline.batch_size", "2",
        "--pipeline.val_batch_size", "1", *SCU_SMALL])
    ckpt = (tmp_path / "logs" / "SparseConvUnet_Scannet_torch" /
            "checkpoint" / "ckpt_00000.pth")
    assert ckpt.exists()


@pytest.mark.parametrize("split", ["test", "valid", "validation"])
def test_cli_refuses_scu_test_and_valid(split, tmp_path):
    """SparseConvUnet's test and valid splits raise in the pipeline before
    its possibility-map loop starts, which would never end."""
    chip_smoke.write_scannet_rooms(tmp_path / "scannet", 256,
                                   {"val": 1, "test": 1})
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        run_pipeline.main(["-c", str(SCU_YML), "--device", "cpu",
                           "--dataset.dataset_path",
                           str(tmp_path / "scannet"),
                           "--main_log_dir", str(tmp_path / "logs"),
                           "--split", split, *SCU_SMALL])


@pytest.mark.parametrize("entry", ["run_test", "run_inference"])
def test_pipeline_refuses_scu_patch_loop(entry, tmp_path):
    """``SemanticSegmentation`` itself refuses SparseConvUnet's test and
    inference: its ``transform`` never advances the possibility map."""
    chip_smoke.write_scannet_rooms(tmp_path / "scannet", 256, {"test": 1})
    model = SparseConvUnet(num_levels=3, multiplier=4, num_points=256,
                           max_voxels=256)
    pipeline = SemanticSegmentation(
        model, Scannet(dataset_path=str(tmp_path / "scannet")),
        device="cpu", main_log_dir=str(tmp_path / "logs"))
    rng = np.random.default_rng(0)
    data = {"point": rng.uniform(0, 2, (256, 3)).astype(np.float32),
            "feat": rng.uniform(0, 255, (256, 3)).astype(np.float32),
            "label": np.zeros(256, np.int32)}
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        if entry == "run_test":
            pipeline.run_test()
        else:
            pipeline.run_inference(data)


@pytest.mark.parametrize("device,error", [("tpu", ValueError),
                                          ("TPU", ValueError),
                                          ("gpu", ValueError),
                                          ("cuda", RuntimeError),
                                          ("cuda:0", RuntimeError)])
def test_cli_refuses_devices(device, error, tmp_path, monkeypatch):
    """No device but cuda and cpu, and cuda only with a card visible:
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match="--device"):
        run_pipeline.main(_kitti_argv(tmp_path)[:2] + [
            "--device", device, "--dataset.dataset_path", str(tmp_path)])


def test_cli_refuses_distributed(tmp_path, monkeypatch):
    """``--distributed`` outside torchrun's environment raises, naming the
    launcher; the ranks' runs are ``test_torch_parallel_cli.py``'s."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        run_pipeline.main(_kitti_argv(tmp_path, "--distributed"))


def test_cli_defaults_to_cuda_and_runs_as_a_module(tmp_path):
    """``python -m open3d_ml_tpu_torch.run_pipeline`` with no --device runs
    on cuda: with no card visible it exits non-zero and says so."""
    args, _ = run_pipeline.parse_args(["-c", "x.yml"])
    assert args.device == "cuda" and args.seed == 0
    run = subprocess.run(
        [sys.executable, "-m", "open3d_ml_tpu_torch.run_pipeline", "-c",
         str(RANDLANET_YML), "--dataset.dataset_path", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert run.returncode != 0
    assert "no CUDA device is visible" in run.stderr


def test_cli_seed_draws(tmp_path):
    """``--seed`` seeds the pipeline; the model's seed is the first draw of
    ``np.random.default_rng(--seed)``, as in the JAX command line."""
    chip_smoke.write_semantickitti(tmp_path / "kitti", 300, {})
    pipeline, split = run_pipeline.build_pipeline(*run_pipeline.parse_args(
        _kitti_argv(tmp_path, "--seed", "11", "--split", "valid")))
    first = int(np.random.default_rng(11).integers(1 << 31))
    assert pipeline.model.cfg.seed == first
    assert pipeline.cfg.seed == 11 and split == "valid"
    assert pipeline.device == torch.device("cpu")
    assert pipeline.model.cfg.in_channels == 4
    assert pipeline.dataset.cfg.cache_dir == str(tmp_path / "cache")


class _Pipeline:
    def __init__(self):
        self.ran = []

    def run_train(self):
        self.ran.append("train")

    def run_test(self):
        self.ran.append("test")


class _PipelineWithValid(_Pipeline):
    def run_valid(self):
        self.ran.append("valid")


@pytest.mark.parametrize("split,plain,with_valid", [
    ("train", "train", "train"), ("training", "train", "train"),
    ("valid", "test", "valid"), ("validation", "test", "valid"),
    ("test", "test", "test"), ("testing", "test", "test")])
def test_cli_split_dispatch(split, plain, with_valid):
    for cls, want in ((_Pipeline, plain), (_PipelineWithValid, with_valid)):
        pipeline = cls()
        run_pipeline.run(pipeline, split)
        assert pipeline.ran == [want]


def _jax_build_from_names(argv, monkeypatch):
    """The JAX command line's build without -c
    (``scripts/run_pipeline.py:102-113``)."""
    monkeypatch.setattr(sys, "argv", ["run_pipeline.py", *argv])
    args, _ = _jax_cli_module().parse_args()
    dataset = jax_get_module("dataset", args.dataset)(
        dataset_path=args.dataset_path)
    model = jax_get_module("model", args.model)(ckpt_path=args.ckpt_path)
    return jax_get_module("pipeline", args.pipeline)(
        model, dataset, main_log_dir=args.main_log_dir or "./logs")


def test_cli_builds_from_names_as_jax(tmp_path, monkeypatch):
    """Without -c, -d/-m/-p build the classes from --dataset_path,
    --ckpt_path and --main_log_dir alone, as the JAX command line does:
    the dataset's and pipeline's configs equal JAX's but for the
    pipeline's own log directory (the device is an argument of the port's
    pipeline, not a key of its config); the dotted extras, the
    seed and the three --cfg_* files are parsed and ignored."""
    chip_smoke.write_semantickitti(tmp_path / "kitti", 300, {})
    argv = ["-d", "SemanticKITTI", "-m", "RandLANet",
            "--dataset_path", str(tmp_path / "kitti"),
            "--ckpt_path", str(tmp_path / "none.pth"),
            "--main_log_dir", str(tmp_path / "logs"), "--seed", "5",
            "--model.num_points", "2048", "--cfg_model"]
    default_cfg = Path("configs") / "default_cfgs" / "randlanet.yml"
    tpipe, split = run_pipeline.build_pipeline(*run_pipeline.parse_args(
        ["--device", "cpu", *argv,
         str(REPO / "open3d_ml_tpu_torch" / default_cfg)]))
    jpipe = _jax_build_from_names(
        [*argv, str(REPO / "open3d_ml_tpu" / default_cfg)], monkeypatch)
    assert split == "train" and tpipe.device == torch.device("cpu")
    assert type(tpipe).__name__ == type(jpipe).__name__
    assert dict(tpipe.dataset.cfg) == dict(jpipe.dataset.cfg)
    # where the two RandLANet classes' own defaults differ: the port
    # recentres by default and lacks four options of the TPU layout
    tmodel, jmodel = dict(tpipe.model.cfg), dict(jpipe.model.cfg)
    assert tmodel.pop("augment") == {"recenter": {"dim": [0, 1]}}
    assert jmodel.pop("augment") == {}
    assert set(jmodel) - set(tmodel) == {"gather_qblock", "grid_cells",
                                         "presorted", "up_segs"}
    assert tmodel == {k: v for k, v in jmodel.items() if k in tmodel}
    assert tpipe.model.cfg.num_points == 45056
    assert tpipe.model.cfg.get("seed") is None
    tcfg, jcfg = dict(tpipe.cfg), dict(jpipe.cfg)
    assert tcfg.pop("logs_dir") == str(
        tmp_path / "logs" / "RandLANet_SemanticKITTI_torch")
    jcfg.pop("logs_dir", None)
    assert tcfg == {k: v for k, v in jcfg.items() if k in tcfg}
    with pytest.raises(ValueError, match="Provide -c"):
        run_pipeline.build_pipeline(*run_pipeline.parse_args(
            ["--device", "cpu"]))
