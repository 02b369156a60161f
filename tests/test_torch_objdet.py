"""The port's detection data, metric and pipeline (``open3d_ml_tpu_torch``)
against the JAX package, on the CPU.

KITTI-format frames are written into a temporary directory by
``chip_smoke.write_kitti_frame`` (``make_objdet_scene`` scenes, their
boxes as label files through a KITTI calib); the same frames, scenes and
box dicts go through the JAX and the port's readers, datasets, batcher,
mAP and ``ObjectDetection`` pipelines. The models are the small config
of ``test_torch_pointpillars.py``, with the JAX net's variables.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from open3d_ml_tpu.dataloaders import DefaultBatcher as JaxBatcher
from open3d_ml_tpu.datasets import KITTI as JaxKITTI
from open3d_ml_tpu.datasets import SyntheticBoxes as JaxSyntheticBoxes
from open3d_ml_tpu.datasets.synthetic import \
    make_objdet_scene as jax_objdet_scene
from open3d_ml_tpu.datasets.utils import BEVBox3D as JaxBEVBox3D
from open3d_ml_tpu.metrics import mAP as jax_mAP
from open3d_ml_tpu.models import PointPillars as JaxPointPillars
from open3d_ml_tpu.pipelines import ObjectDetection as JaxObjectDetection
from open3d_ml_tpu.pipelines.semantic_segmentation import TrainState
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu_torch import DATASET, MODEL, PIPELINE
from open3d_ml_tpu_torch.dataloaders import DefaultBatcher
from open3d_ml_tpu_torch.datasets import KITTI, SyntheticBoxes
from open3d_ml_tpu_torch.datasets.synthetic import make_objdet_scene
from open3d_ml_tpu_torch.datasets.utils import BEVBox3D
from open3d_ml_tpu_torch.metrics import mAP
from open3d_ml_tpu_torch.models import PointPillars
from open3d_ml_tpu_torch.pipelines import ObjectDetection
from open3d_ml_tpu_torch.utils import load_jax_variables

from test_torch_pointpillars import SMALL, jax_variables
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CLASSES = ["Pedestrian", "Cyclist", "Car"]
MODEL_CFG = dict(SMALL, classes=CLASSES, ckpt_path=None,
                 point_cloud_range=[0, -16, -3, 32, 16, 1],
                 voxelize=dict(SMALL["voxelize"], voxel_size=[1.0, 1.0, 4]),
                 head=dict(SMALL["head"],
                           ranges=[[0, -16, -0.6, 32, 16, -0.6],
                                   [0, -16, -0.6, 32, 16, -0.6],
                                   [0, -16, -1.78, 32, 16, -1.78]],
                           sizes=[[0.6, 0.8, 1.73], [0.6, 1.76, 1.73],
                                  [1.6, 3.9, 1.56]]))
PIPE = dict(val_batch_size=1, test_batch_size=1, num_workers=0,
            overlaps=[0.1, 0.1, 0.2], difficulties=[0, 1, 2],
            similar_classes={"Van": "Car", "Person_sitting": "Pedestrian"})


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Frames 0-3 of 'training' (val_split 2: two of them validation) and
    0-1 of 'testing'."""
    root = tmp_path_factory.mktemp("kitti")
    for i in range(4):
        chip_smoke.write_kitti_frame(root, "training", i, 10 + i)
    for i in range(2):
        chip_smoke.write_kitti_frame(root, "testing", i, 20 + i)
    return root


def assert_boxes_equal(got, want, exact=True):
    assert len(got) == len(want)
    check = (np.testing.assert_array_equal if exact else
             lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5,
                                                     atol=1e-4))
    for g, w in zip(got, want):
        assert g.label_class == w.label_class
        check(g.to_xyzwhlr(), w.to_xyzwhlr())
        check(g.to_camera(), w.to_camera())
        check(np.float64(g.confidence), np.float64(w.confidence))
        assert g.level == w.level


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("seed", [0, 7])
def test_make_objdet_scene_bit_equal(seed):
    points, boxes = make_objdet_scene(seed)
    jpoints, jboxes = jax_objdet_scene(seed)
    np.testing.assert_array_equal(points, jpoints)
    assert len(boxes) == len(jboxes)
    for b, j in zip(boxes, jboxes):
        assert b["label_class"] == j["label_class"] and b["yaw"] == j["yaw"]
        np.testing.assert_array_equal(b["center"], j["center"])
        np.testing.assert_array_equal(b["size"], j["size"])


@pytest.mark.parametrize("split", ["training", "validation", "test"])
def test_synthetic_boxes_bit_equal(split, tmp_path):
    port = SyntheticBoxes(seed=3).get_split(split)
    ref = JaxSyntheticBoxes(seed=3).get_split(split)
    assert len(port) == len(ref) and port.sampler is None
    for i in range(len(port)):
        assert port.get_attr(i) == ref.get_attr(i)
        got, want = port.get_data(i), ref.get_data(i)
        np.testing.assert_array_equal(got["point"], want["point"])
        assert_boxes_equal(got["bounding_boxes"], want["bounding_boxes"])
    assert DATASET.get("SyntheticBoxes") is SyntheticBoxes


def test_kitti_reader(kitti_root):
    """Splits, points (cut to the camera's view), calib and the label
    files' ``Object3d`` boxes: difficulty, truncation, occlusion, box2d
    and ``to_xyzwhlr`` equal to the JAX reader's."""
    port = KITTI(dataset_path=str(kitti_root), val_split=2)
    ref = JaxKITTI(dataset_path=str(kitti_root), val_split=2)
    levels = set()
    for split in ("training", "validation", "test"):
        p, r = port.get_split(split), ref.get_split(split)
        assert len(p) == len(r) == 2
        for i in range(len(p)):
            assert p.get_attr(i) == r.get_attr(i)
            got, want = p.get_data(i), r.get_data(i)
            for key in ("point", "full_point"):
                np.testing.assert_array_equal(got[key], want[key])
            assert len(got["point"]) < len(got["full_point"])
            for key in ("world_cam", "cam_img"):
                np.testing.assert_array_equal(got["calib"][key],
                                              want["calib"][key])
            assert_boxes_equal(got["bounding_boxes"], want["bounding_boxes"])
            for g, w in zip(got["bounding_boxes"], want["bounding_boxes"]):
                assert (g.truncation, g.occlusion, g.level_str) == \
                    (w.truncation, w.occlusion, w.level_str)
                np.testing.assert_array_equal(g.box2d, w.box2d)
                levels.add(g.level)
    assert len(levels) >= 3  # the written frames reach several difficulties
    box = port.get_split("training").get_data(0)["bounding_boxes"][0]
    scene_box = make_objdet_scene(10)[1][0]
    # label files keep 2 decimals
    np.testing.assert_allclose(box.to_xyzwhlr()[:2],
                               scene_box["center"][:2], atol=0.01)
    assert DATASET.get("KITTI") is KITTI


def test_batcher_collates_detection_samples(kitti_root):
    """point and point_count stack; the calib dicts become a dict of
    stacked arrays; the boxes stay one list per sample; the attrs' ints
    become an array: as the JAX batcher does."""
    port_model, jax_model = PointPillars(**MODEL_CFG), \
        JaxPointPillars(**MODEL_CFG)
    split = KITTI(dataset_path=str(kitti_root),
                  val_split=2).get_split("validation")
    samples, jsamples = [], []
    for i in range(len(split)):
        attr = split.get_attr(i)
        data = split.get_data(i)
        t = port_model.transform(port_model.preprocess(data, attr), attr)
        j = jax_model.transform(jax_model.preprocess(data, attr), attr)
        for key in ("point", "point_count", "bboxes", "labels",
                    "bbox_count"):
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        samples.append({"data": t, "attr": dict(attr, idx=i)})
        jsamples.append({"data": j, "attr": dict(attr, idx=i)})
    got = DefaultBatcher().collate_fn(samples)
    want = JaxBatcher().collate_fn(jsamples)
    assert got["data"]["point"].shape == (2, MODEL_CFG["max_points"], 4)
    assert got["data"]["point_count"].dtype == np.int64
    for key in ("point", "point_count", "bboxes", "labels", "bbox_count"):
        np.testing.assert_array_equal(got["data"][key], want["data"][key])
    for key in ("world_cam", "cam_img"):
        assert got["data"]["calib"][key].shape == (2, 4, 4)
        np.testing.assert_array_equal(got["data"]["calib"][key],
                                      want["data"]["calib"][key])
    assert [len(b) for b in got["data"]["bbox_objs"]] == \
        [len(b) for b in want["data"]["bbox_objs"]]
    np.testing.assert_array_equal(got["attr"]["idx"], want["attr"]["idx"])
    assert got["attr"]["name"] == want["attr"]["name"]


def test_preprocess_and_transform_test_split():
    data = {"point": make_objdet_scene(5)[0], "calib": None}
    attr = {"split": "test"}
    port, ref = PointPillars(**MODEL_CFG), JaxPointPillars(**MODEL_CFG)
    got = port.transform(port.preprocess(data, attr), attr)
    want = ref.transform(ref.preprocess(data, attr), attr)
    assert set(got) == set(want) == {"point", "point_count", "calib"}
    np.testing.assert_array_equal(got["point"], want["point"])
    assert got["point_count"] == want["point_count"] > 0


def test_mAP_equals_jax(kitti_root):
    """Predictions near the gt boxes (some far off, some of a similar
    class, scores with ties) over every difficulty, BEV and 3D."""
    rng = np.random.default_rng(0)
    split = KITTI(dataset_path=str(kitti_root),
                  val_split=0).get_split("validation")
    pred, gt = [], []
    for i in range(len(split)):
        boxes = split.get_data(i)["bounding_boxes"]
        boxes[0].label_class = "Van"  # counts neither as TP nor as miss
        found = []
        for b in boxes:
            if rng.uniform() < 0.2:
                continue
            shift = rng.normal(0, 0.3, 3) * (5 if rng.uniform() < 0.2 else 1)
            label = b.label_class if b.label_class != "Van" else "Car"
            found.append(BEVBox3D(b.center + shift, b.size,
                                  b.yaw + rng.normal(0, 0.1), label,
                                  float(np.round(rng.uniform(), 1)),
                                  b.world_cam, b.cam_img))
        pred.append(BEVBox3D.to_dicts(found))
        gt.append(BEVBox3D.to_dicts(boxes))
        jfound = [JaxBEVBox3D(b.center, b.size, b.yaw, b.label_class,
                              b.confidence, b.world_cam, b.cam_img)
                  for b in found]
        for key, value in JaxBEVBox3D.to_dicts(jfound).items():
            np.testing.assert_array_equal(pred[-1][key], value)
    for bev in (True, False):
        kw = dict(difficulties=[0, 1, 2], min_overlap=[0.5, 0.5, 0.7],
                  bev=bev, similar_classes=PIPE["similar_classes"])
        got = mAP(pred, gt, CLASSES, **kw)
        want = jax_mAP(pred, gt, CLASSES, **kw)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (3, 3, 1) and got.max() > 0


# --------------------------------------------------------------- pipeline

@pytest.fixture(scope="module")
def pipelines(kitti_root, tmp_path_factory):
    """A JAX and a port ObjectDetection on the KITTI frames, the port's
    net loaded with the JAX state's variables."""
    logs = tmp_path_factory.mktemp("logs")
    jmodel = JaxPointPillars(**MODEL_CFG)
    batch = {"point": jnp.zeros((1, MODEL_CFG["max_points"], 4)),
             "point_count": jnp.full((1,), 10, jnp.int32)}
    variables = jax_variables(jmodel.get_eval_net(), batch, training=False)
    jds = JaxKITTI(dataset_path=str(kitti_root), val_split=2,
                   test_result_folder=str(logs / "jax_test"))
    jpipe = JaxObjectDetection(jmodel, dataset=jds,
                               main_log_dir=str(logs / "jax"), **PIPE)
    jpipe.state = TrainState(params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=None, step=0)
    ds = KITTI(dataset_path=str(kitti_root), val_split=2,
               test_result_folder=str(logs / "port_test"))
    pipe = ObjectDetection(PointPillars(**MODEL_CFG), dataset=ds,
                           device="cpu", main_log_dir=str(logs / "port"),
                           **PIPE)
    load_jax_variables(pipe.net, variables)
    return jpipe, pipe


def test_run_inference(pipelines, kitti_root):
    jpipe, pipe = pipelines
    data = KITTI(dataset_path=str(kitti_root)).get_split(
        "test").get_data(1)
    got = pipe.run_inference(data)
    want = jpipe.run_inference(data)
    assert len(got) > 0
    assert_boxes_equal(got, want, exact=False)


def test_run_valid(pipelines):
    """The same mAP BEV and 3D from the same weights."""
    jpipe, pipe = pipelines
    got = pipe.run_valid()
    want = jpipe.run_valid()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-9)
    assert pipe.valid_map_bev == pytest.approx(jpipe.valid_map_bev)


def test_run_test_and_checkpoint(pipelines, tmp_path):
    """run_test writes one KITTI result file a frame, with the JAX
    pipeline's boxes; a checkpoint saved and loaded by a fresh pipeline
    gives the same weights and detections."""
    jpipe, pipe = pipelines
    got = pipe.run_test()
    want = jpipe.run_test()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_boxes_equal(g, w, exact=False)
    files = sorted((Path(pipe.dataset.cfg.test_result_folder)).glob("*.txt"))
    assert [f.name for f in files] == ["000000.txt", "000001.txt"]
    assert len(files[0].read_text().splitlines()) == len(got[0])

    pipe.save_ckpt(3)
    fresh = ObjectDetection(pipe.model, dataset=pipe.dataset, device="cpu",
                            seed=9, main_log_dir=pipe.cfg.main_log_dir,
                            **PIPE)
    assert fresh.load_ckpt() == 4
    for key, value in pipe.net.state_dict().items():
        assert torch.equal(fresh.net.state_dict()[key], value), key
    again = fresh.run_test()
    for g, w in zip(again, got):
        assert_boxes_equal(g, w)


def test_pipeline_registry_and_training_not_ported(tmp_path):
    """The registries and the device; ``run_train``, which raised before
    training was ported, runs one step (one epoch of one batch on
    ``SyntheticBoxes``, no augment section) and saves its checkpoint."""
    assert PIPELINE.get("ObjectDetection") is ObjectDetection
    assert MODEL.get("PointPillars") is PointPillars
    ds = SyntheticBoxes(dataset_path=str(tmp_path), seed=0,
                        num_clouds={"training": 1, "validation": 1,
                                    "test": 1})
    pipe = ObjectDetection(PointPillars(**MODEL_CFG), dataset=ds,
                           device="cpu", batch_size=1, max_epoch=0,
                           main_log_dir=str(tmp_path / "logs"),
                           **dict(PIPE, difficulties=[0]))
    assert pipe.net.training is False
    assert next(pipe.eval_net.parameters()).device.type == "cpu"
    pipe.run_train()
    assert [len(v) for v in pipe.losses.values()] == [1, 1, 1]
    assert next(pipe.net.parameters()).device.type == "cpu"
    assert (Path(pipe.cfg.logs_dir) / "checkpoint" /
            "ckpt_00000.pth").exists()


# --------------------------------------------------------------- chip_smoke

def test_chip_smoke_config_equals_shipped_yaml():
    cfg = Config.load_from_file(
        REPO / "open3d_ml_tpu/configs/pointpillars_kitti.yml")
    model = {k: v for k, v in cfg.model.to_dict().items()
             if k not in ("name", "ckpt_path", "augment")}
    assert chip_smoke.POINTPILLARS_KITTI == model
    for key, value in chip_smoke.POINTPILLARS_PIPELINE.items():
        assert cfg.pipeline[key] == value, key
    net = PointPillars(**chip_smoke.POINTPILLARS_KITTI).get_net()
    assert net.conv_cls.out_channels == 18


def test_chip_smoke_flop_count():
    """273 GFLOP for the bench's batch of 4: the backbone 59.2, the neck
    6.1 and the head 3.0 GFLOP a scan."""
    model = PointPillars(**chip_smoke.POINTPILLARS_KITTI)
    flops = chip_smoke.pp_flops(model, 1)
    assert flops["bf16"] == pytest.approx(65.3e9, rel=2e-3)
    assert flops["float32"] == pytest.approx(2.98e9, rel=1e-2)


def test_port_imports_no_jax():
    """The detection modules of the port, training's included, import
    neither JAX nor the JAX package, nor PyYAML."""
    code = ("import sys\n"
            "import open3d_ml_tpu_torch\n"
            "import open3d_ml_tpu_torch.models.point_pillars\n"
            "import open3d_ml_tpu_torch.models.objdet_helper\n"
            "import open3d_ml_tpu_torch.ops.iou\n"
            "import open3d_ml_tpu_torch.ops.nms\n"
            "import open3d_ml_tpu_torch.ops.bev\n"
            "import open3d_ml_tpu_torch.metrics.mAP\n"
            "import open3d_ml_tpu_torch.datasets.kitti\n"
            "import open3d_ml_tpu_torch.pipelines.object_detection\n"
            "import open3d_ml_tpu_torch.vis.boundingbox\n"
            "import open3d_ml_tpu_torch.modules.losses\n"
            "import open3d_ml_tpu_torch.models.common\n"
            "import open3d_ml_tpu_torch.datasets.augment\n"
            "import open3d_ml_tpu_torch.datasets.utils.operations\n"
            "import open3d_ml_tpu_torch.utils.collect_bboxes\n"
            "import chip_smoke\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'yaml',\n"
            "                   'open3d_ml_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
