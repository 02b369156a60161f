"""The port's command line with ``--distributed``: ``torchrun
--nproc-per-node 2 -m open3d_ml_tpu_torch.run_pipeline ... --device cpu
--distributed``, two ``gloo`` ranks on the CPU, trains RandLA-Net on a tiny
``Custom3D`` set and PointPillars on ``SyntheticBoxes``. Rank 0 alone
writes the log file, the TensorBoard run and the checkpoint, and the
checkpoint equals that of the same command in one process. Each run is
bounded by ``communicate(timeout=...)``.
"""

import subprocess
import sys
from pathlib import Path

import torch
import yaml

from open3d_ml_tpu_torch import run_pipeline
from open3d_ml_tpu_torch.models import PointPillars, RandLANet

from test_torch_scu_train import _write_rooms
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300

RANDLA = {
    # seeded, so that the one-process run draws the same patches
    "dataset": {"name": "Custom3D", "seed": 3, "steps_per_epoch_train": 4,
                "steps_per_epoch_valid": 2},
    # test_torch_randlanet's SMALL widths at 1,024 points, float32; the
    # rooms' RGB as features
    "model": {"name": "RandLANet", "num_points": 1024, "num_classes": 5,
              "ignored_label_inds": [], "in_channels": 6,
              "dim_output": [8, 16, 32, 32], "seg": 32, "block": 64,
              "num_segs": 8, "gather_segs": 4, "infer_num_segs": 6,
              "infer_gather_segs": 4, "compute_dtype": "float32"},
    "pipeline": {"name": "SemanticSegmentation", "batch_size": 4,
                 "val_batch_size": 2, "max_epoch": 0, "num_workers": 0}}
POINTPILLARS = {
    "dataset": {"name": "SyntheticBoxes",
                "num_clouds": {"training": 2, "validation": 2, "test": 1}},
    # the JAX dry run's net widths on the synthetic scenes' classes
    "model": {"name": "PointPillars", "compute_dtype": "float32",
              "classes": ["Pedestrian", "Cyclist", "Car"],
              "point_cloud_range": [0, -16, -3, 32, 16, 1],
              "voxelize": {"max_num_points": 8, "voxel_size": [1.0, 1.0, 4],
                           "max_voxels": [1024, 1024]},
              "voxel_encoder": {"in_channels": 4, "feat_channels": [16],
                                "voxel_size": [1.0, 1.0, 4]},
              "scatter": {"in_channels": 16, "output_shape": [32, 32]},
              "backbone": {"in_channels": 16, "out_channels": [16, 32],
                           "layer_nums": [1, 1], "layer_strides": [2, 2]},
              "neck": {"in_channels": [16, 32], "out_channels": [16, 16],
                       "upsample_strides": [1, 2]},
              "head": {"ranges": [[0, -16, -0.6, 32, 16, -0.6],
                                  [0, -16, -0.6, 32, 16, -0.6],
                                  [0, -16, -1.78, 32, 16, -1.78]],
                       "sizes": [[0.6, 0.8, 1.73], [0.6, 1.76, 1.73],
                                 [1.6, 3.9, 1.56]],
                       "rotations": [0, 1.5707963]},
              "max_points": 4096, "max_gt": 16},
    "pipeline": {"name": "ObjectDetection", "batch_size": 2,
                 "val_batch_size": 1, "max_epoch": 0, "num_workers": 0,
                 "save_ckpt_freq": 1, "overlaps": [0.1, 0.1, 0.2],
                 "difficulties": [0]}}


def _config(tmp, cfg, data_root):
    path = tmp / "cfg.yml"
    cfg = {k: dict(v) for k, v in cfg.items()}
    cfg["dataset"]["dataset_path"] = str(data_root)
    cfg["dataset"]["cache_dir"] = str(tmp / "cache")
    path.write_text(yaml.safe_dump(cfg))
    return path


def _argv(cfg, run):
    return ["-c", str(cfg), "--device", "cpu", "--split", "train",
            "--main_log_dir", str(run / "logs"),
            "--pipeline.train_sum_dir", str(run / "tb")]


def _torchrun(argv):
    """(exit code, standard error) of the command line on 2 CPU ranks
    under torchrun."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "open3d_ml_tpu_torch.run_pipeline",
         *argv, "--distributed"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, err


def _written(run, logs_name):
    """The run's log files, TensorBoard runs and checkpoints."""
    logs = run / "logs" / logs_name
    return (sorted(logs.glob("log_train_*.txt")),
            sorted((run / "tb").iterdir()),
            sorted((logs / "checkpoint").glob("ckpt_*.pth")))


def _two_ranks_and_one(tmp_path, cfg, data_root, logs_name):
    """(the 2-rank run's checkpoint, the one-process run's), after checking
    that the 2-rank run wrote one log file, one TensorBoard run and one
    checkpoint."""
    path = _config(tmp_path, cfg, data_root)
    code, err = _torchrun(_argv(path, tmp_path / "ranks"))
    assert code == 0, err[-4000:]
    run_pipeline.main(_argv(path, tmp_path / "one"))
    logs, tb, ckpts = _written(tmp_path / "ranks", logs_name)
    assert len(logs) == 1 and len(tb) == 1 and len(ckpts) == 1
    assert "Started training" in logs[0].read_text()
    one = _written(tmp_path / "one", logs_name)
    assert [p.name for p in one[2]] == [p.name for p in ckpts]
    return (torch.load(ckpts[0], weights_only=True),
            torch.load(one[2][0], weights_only=True))


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def assert_first_step_alike(got, want, names):
    """Checkpoints after one Adam (or AdamW) step from the same weights:
    the step moves a weight by lr * g / (|g| + eps), lr times the sign of
    the gradient g where |g| >> eps (1e-8), so the weights agree within
    1e-6 where the first moment in the checkpoint, 0.1 g, exceeds 1e-6
    and 1% of its tensor's largest, and within 2 lr elsewhere, where
    float32 noise may flip the sign (as in ``test_torch_parallel.py``).
    Each parameter took one step on both sides."""
    state = want["optimizer"]["state"]
    assert sorted(state) == list(range(len(names)))
    group = want["optimizer"]["param_groups"][0]
    lr = group.get("initial_lr", group["lr"])
    for i, name in enumerate(names):
        moment = state[i]["exp_avg"]
        big = moment.abs() > max(1e-6, 1e-2 * float(moment.abs().max()))
        diff = (got["model"][name] - want["model"][name]).abs()
        if big.any():
            assert float(diff[big].max()) <= 1e-6, name
        assert float(diff.max()) <= 2 * lr * (1 + 1e-6), name
        assert int(got["optimizer"]["state"][i]["step"]) == 1, name


def _names(model_cfg, model):
    cfg = {k: v for k, v in model_cfg.items() if k != "name"}
    return [n for n, _ in model(**cfg).get_net().named_parameters()]


def test_randlanet_trains_on_two_ranks(tmp_path):
    """RandLA-Net, one step of 4 patches on 2 ranks and a validation step
    of 2: the checkpoint's BatchNorm statistics within 1e-6 (relative L2)
    of the one-process run's, its weights as ``assert_first_step_alike``
    says, its schedule alike."""
    root = _write_rooms(tmp_path / "data", {"train": 2, "val": 1,
                                            "test": 1}, n=3000)
    got, want = _two_ranks_and_one(tmp_path, RANDLA, root,
                                   "RandLANet_Custom3D_torch")
    assert got["epoch"] == want["epoch"] == 0
    for key, value in want["model"].items():
        if key.endswith(("running_mean", "running_var")):
            assert _rel_l2(got["model"][key], value) <= 1e-6, key
    assert_first_step_alike(got, want, _names(RANDLA["model"], RandLANet))
    assert got["scheduler"] == want["scheduler"]


def test_pointpillars_trains_on_two_ranks(tmp_path):
    """PointPillars, one step of 2 frames on 2 ranks (1 + 1) and a
    validation over 2 frames, each rank detecting one, gathered: the
    checkpoint's BatchNorm statistics within 1e-6 (relative L2) of the
    one-process run's and its weights as ``assert_first_step_alike``
    says."""
    got, want = _two_ranks_and_one(tmp_path, POINTPILLARS,
                                   tmp_path / "synthetic",
                                   "PointPillars_SyntheticBoxes_torch")
    for key, value in want["model"].items():
        if key.endswith(("running_mean", "running_var")):
            assert _rel_l2(got["model"][key], value) <= 1e-6, key
    assert_first_step_alike(got, want,
                            _names(POINTPILLARS["model"], PointPillars))


def test_other_models_refuse_two_ranks_on_the_command_line(tmp_path):
    """SparseConvUnet through the command line on 2 ranks: every rank
    raises, naming ROADMAP queue 1 item 7, and torchrun exits non-zero."""
    cfg = {"dataset": {"name": "Custom3D"},
           "model": {"name": "SparseConvUnet"},
           "pipeline": {"name": "SemanticSegmentation", "num_workers": 0}}
    root = _write_rooms(tmp_path / "data", {"train": 1, "val": 1})
    path = _config(tmp_path, cfg, root)
    code, err = _torchrun(_argv(path, tmp_path))
    assert code != 0
    assert err.count("ROADMAP queue 1 item 7") >= 2, err[-4000:]
