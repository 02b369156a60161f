"""The port's PointPillars YAMLs through its command line on the CPU.

``python -m open3d_ml_tpu_torch.run_pipeline -c
open3d_ml_tpu_torch/configs/pointpillars_{kitti,lyft,nuscenes}.yml`` with
scalar overrides that keep a CPU run short: frames of 3,000 points cut to
4,096, batches of 1, 8 gt boxes a frame, the loader in this thread.
nuScenes runs its YAML as shipped, at its 400 x 400 canvas. KITTI and
Lyft run a copy of theirs whose canvas is cut to ``CUT`` x ``CUT`` cells
around the sensor (the lists cannot be overridden on the command line),
all else as shipped, on frames of boxes inside it. ``--split train`` takes one AdamW step and validates on
one frame; ``--split test`` detects in the test frames from the
checkpoint. KITTI writes its result files; nuScenes and Lyft fail to
write theirs as KITTI lines, as the JAX pipeline does (their frames carry
no camera matrix: ROADMAP queue 3). The nets, targets, losses and decode
of these configs are held to the JAX package in
``test_torch_pp_configs.py``; the Waymo and Argoverse configs fail as
the JAX package fails, pinned there.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from open3d_ml_tpu_torch import run_pipeline
from open3d_ml_tpu_torch.datasets import KITTI
from open3d_ml_tpu_torch.datasets.synthetic import make_objdet_scene
from open3d_ml_tpu_torch.datasets.utils.bev_box import NO_CAMERA_FAULT
from open3d_ml_tpu_torch.pipelines import ObjectDetection
from open3d_ml_tpu_torch.utils import Config, collect_bboxes
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--pipeline.num_workers", "0",
         "--pipeline.batch_size", "1", "--pipeline.max_epoch", "0",
         "--model.max_points", "4096", "--model.max_gt", "8"]
FRAME_POINTS = 3000
CUT = 128  # cells a side of a cut YAML's canvas
CUT_CONFIGS = ("kitti", "lyft")


def _yaml(name, root):
    """The path of the YAML that config ``name`` runs: the port's, or for
    ``CUT_CONFIGS`` a copy in ``root`` whose point cloud range, anchor
    ranges (their heights kept), range filter and canvas are cut to
    ``CUT`` x ``CUT`` cells around the sensor, inside the range."""
    path = REPO / f"open3d_ml_tpu_torch/configs/pointpillars_{name}.yml"
    if name not in CUT_CONFIGS:
        return path
    cfg = yaml.safe_load(path.read_text())
    model = cfg["model"]
    pr = model["point_cloud_range"]
    half = [CUT / 2 * v for v in model["voxelize"]["voxel_size"][:2]]
    lo = [max(pr[i], -half[i]) for i in range(2)]
    hi = [lo[i] + 2 * half[i] for i in range(2)]
    model["point_cloud_range"] = [*lo, pr[2], *hi, pr[5]]
    model["head"]["ranges"] = [[*lo, r[2], *hi, r[5]]
                               for r in model["head"]["ranges"]]
    model["scatter"]["output_shape"] = [CUT, CUT]
    if "ObjectRangeFilter" in model.get("augment", {}):
        model["augment"]["ObjectRangeFilter"]["point_cloud_range"] = \
            model["point_cloud_range"]
    out = root / f"pointpillars_{name}.yml"
    out.write_text(yaml.safe_dump(cfg))
    return out


def _model(name, root):
    """The model section of the YAML that config ``name`` runs, as
    ``chip_smoke``'s frame writers take it."""
    cfg = Config.load_from_file(_yaml(name, root)).model.to_dict()
    return {k: v for k, v in cfg.items()
            if k not in ("name", "ckpt_path", "augment")}


def _argv(name, root, *extra):
    return ["-c", str(_yaml(name, root)),
            "--dataset.dataset_path", str(root / "data"),
            "--dataset.test_result_folder", str(root / "test"),
            "--main_log_dir", str(root / "logs"),
            "--pipeline.train_sum_dir", str(root / "tb"), *SMALL, *extra]


def _write(name, root):
    """One train, one validation and two test frames (KITTI's two
    training frames split one and one); KITTI's with a gt database for
    ObjectSample. Returns the extra arguments."""
    data = root / "data"
    if name == "kitti":
        reach = 0.9 * _model(name, root)["point_cloud_range"][3]

        def scene(seed):
            return make_objdet_scene(seed, r_max=reach)

        for i in range(2):
            chip_smoke.write_kitti_frame(data, "training", i, 100 + i, scene)
        for i in range(2):
            chip_smoke.write_kitti_frame(data, "testing", i, i, scene)
        db = root / "bboxes.pkl"
        collect_bboxes.collect(KITTI(dataset_path=str(data), val_split=1),
                               db)
        return ["--dataset.val_split", "1",
                "--dataset.steps_per_epoch_train", "1",
                "--model.augment.ObjectSample.pickle_path", str(db)]
    chip_smoke.write_nuscenes(data, _model(name, root),
                              {"train": [1], "val": [2], "test": [3, 4]},
                              FRAME_POINTS)
    return []


@pytest.fixture
def recorded(monkeypatch):
    """The pipeline's steps' losses, validations' mAP and detected
    frames, as the command line runs them."""
    seen = {"losses": [], "valid": [], "frames": 0}
    step, valid, detect = (ObjectDetection._train_step,
                           ObjectDetection.run_valid,
                           ObjectDetection._detect)

    def train_step(self, inputs):
        losses = step(self, inputs)
        seen["losses"].append({k: float(v) for k, v in losses.items()})
        return losses

    def run_valid(self, *args, **kwargs):
        out = valid(self, *args, **kwargs)
        seen["valid"].append(out)
        return out

    def _detect(self, batch):
        out = detect(self, batch)
        seen["frames"] += len(out)
        return out

    monkeypatch.setattr(ObjectDetection, "_train_step", train_step)
    monkeypatch.setattr(ObjectDetection, "run_valid", run_valid)
    monkeypatch.setattr(ObjectDetection, "_detect", _detect)
    return seen


@pytest.mark.parametrize("name", ["kitti", "lyft", "nuscenes"])
def test_cli_trains_and_tests_the_port_yaml(name, tmp_path, recorded):
    """``--split train``: one finite step, a validation mAP of the YAML's
    classes, a checkpoint of finite weights; ``--split test`` from it:
    every test frame detected, then KITTI's result files, and nuScenes'
    and Lyft's KITTI lines refused for want of a camera (the JAX fault)."""
    extra = _write(name, tmp_path)
    run_pipeline.main(_argv(name, tmp_path, "--split", "train", *extra))
    assert len(recorded["losses"]) == 1
    assert all(np.isfinite(v) for v in recorded["losses"][0].values())
    (ap_bev, ap_3d), = recorded["valid"]
    classes = Config.load_from_file(_argv(name, tmp_path)[1]).model.classes
    assert ap_bev.shape[0] == ap_3d.shape[0] == len(classes)
    assert np.isfinite(ap_bev).all() and np.isfinite(ap_3d).all()
    (ckpt,) = (tmp_path / "logs").glob("**/ckpt_00000.pth")
    state = torch.load(ckpt, weights_only=True)["model"]
    assert all(torch.isfinite(v).all() for v in state.values()
               if v.is_floating_point())

    recorded["frames"] = 0
    test = _argv(name, tmp_path, "--split", "test", "--ckpt_path", str(ckpt),
                 *extra)
    if name == "kitti":
        run_pipeline.main(test)
        assert len(list((tmp_path / "test").glob("*.txt"))) == 2
    else:
        with pytest.raises(TypeError) as err:
            run_pipeline.main(test)
        assert NO_CAMERA_FAULT in str(err.value)
    assert recorded["frames"] == 2
