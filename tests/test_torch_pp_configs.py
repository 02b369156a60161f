"""PointPillars at its four other shipped configs (nuScenes, Lyft, Waymo,
Argoverse) against the JAX package on the CPU.

* The readers: ``chip_smoke``'s writers put frames in each reader's own
  format into ``tmp_path`` (nuScenes' and Lyft's info pickles and [N, 5]
  sweeps, Waymo's KITTI-layout export, Argoverse's info pickles and PLY
  sweeps); both packages' readers give equal splits, points, calib,
  boxes and attributes, and write equal result files.
* The nets that run (Lyft, nuScenes, Argoverse) at a 64 x 64 canvas: the
  YAML's classes, anchor sizes, rotations, ``iou_thr``, ``max_num_points``,
  voxel size and widths, the point range and the anchor ranges cut in x
  and y to the canvas (z kept), one convolution a backbone stage,
  ``max_voxels`` 2,048, float32, the port's weights carried to JAX by
  ``state_dict_to_jax``: the canvas and compact nets' head outputs,
  ``assign_bboxes``' targets on each frame's boxes, ``get_loss`` and
  ``get_bboxes`` after the CPU NMS; at the YAMLs' full width and depth
  the eval nets (``slow``).
* The faults of the JAX package that the port mirrors (ROADMAP queue 3):
  the Waymo net cannot join its neck, an Argoverse frame has 3 columns
  where ``transform`` takes 4, and the info-format readers' test split
  cannot write its boxes as KITTI lines (no camera matrix). Each fails in
  both packages at the same place, the port's error naming the fault.

The command line on the port's YAMLs is ``test_torch_pp_configs_cli.py``.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import open3d_ml_tpu.datasets as jax_datasets
from open3d_ml_tpu.datasets.utils import BEVBox3D as JaxBox
from open3d_ml_tpu.models import PointPillars as JaxPointPillars
import open3d_ml_tpu_torch.datasets as port_datasets
from open3d_ml_tpu_torch.datasets.utils import BEVBox3D
from open3d_ml_tpu_torch.datasets.utils.bev_box import NO_CAMERA_FAULT
from open3d_ml_tpu_torch.models import PointPillars
from open3d_ml_tpu_torch.models.point_pillars import (COLUMNS_FAULT,
                                                      NECK_FAULT)
from open3d_ml_tpu_torch.utils import Config
from open3d_ml_tpu_torch.utils.convert_jax import (net_layout,
                                                   state_dict_to_jax)
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
READERS = {"nuscenes": ("NuScenes", chip_smoke.write_nuscenes),
           "lyft": ("Lyft", chip_smoke.write_nuscenes),
           "waymo": ("Waymo", chip_smoke.write_waymo),
           "argoverse": ("Argoverse", chip_smoke.write_argoverse)}
SPLITS = {"nuscenes": ("train", "val", "test"),
          "lyft": ("train", "val", "test"),
          "waymo": ("train", "val", "test"),
          "argoverse": ("train", "val", "test", "sample")}
RUNNABLE = ("lyft", "nuscenes", "argoverse")
FRAME_POINTS = 3000
CANVAS = 64
B = 2


def yaml_model(name):
    """The model section of the port's ``pointpillars_{name}.yml``."""
    cfg = Config.load_from_file(
        REPO / f"open3d_ml_tpu_torch/configs/pointpillars_{name}.yml")
    return {k: v for k, v in cfg.model.to_dict().items()
            if k not in ("name", "ckpt_path", "augment")}


def small(name):
    """``yaml_model(name)`` at a ``CANVAS`` x ``CANVAS`` canvas around the
    sensor (see the module's docstring), float32."""
    cfg = copy.deepcopy(yaml_model(name))
    vx, vy = cfg["voxelize"]["voxel_size"][:2]
    hx, hy = CANVAS / 2 * vx, CANVAS / 2 * vy
    pr = cfg["point_cloud_range"]
    cfg["point_cloud_range"] = [-hx, -hy, pr[2], hx, hy, pr[5]]
    cfg["head"]["ranges"] = [[-hx, -hy, r[2], hx, hy, r[5]]
                             for r in cfg["head"]["ranges"]]
    cfg["scatter"]["output_shape"] = [CANVAS, CANVAS]
    cfg["backbone"]["layer_nums"] = [1, 1, 1]
    cfg["voxelize"]["max_voxels"] = [2048, 2048]
    return dict(cfg, max_points=4096, max_gt=16, compute_dtype="float32")


def _write(name, root, frames, n=FRAME_POINTS):
    writer = READERS[name][1]
    writer(root, yaml_model(name), frames, n)


def _readers(name, root):
    cls = READERS[name][0]
    return (getattr(port_datasets, cls)(dataset_path=str(root),
                                         test_result_folder=str(root / "p")),
            getattr(jax_datasets, cls)(dataset_path=str(root),
                                       test_result_folder=str(root / "j")))


def _same_boxes(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        for attr in ("center", "size", "yaw", "label_class", "confidence"):
            np.testing.assert_array_equal(getattr(g, attr), getattr(w, attr),
                                          err_msg=attr)
        np.testing.assert_array_equal(g.to_xyzwhlr(), w.to_xyzwhlr())


def _same_calib(got, want):
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ----------------------------------------------------------------- readers

@pytest.mark.parametrize("name", list(READERS))
def test_readers_equal_jax(name, tmp_path):
    """Every split of frames written in the reader's format: equal
    lengths, points, calib, boxes and attributes; for Waymo, whose frames
    have KITTI's camera, a frame's boxes written by ``save_test_result``
    as equal files."""
    frames = {s: [10 * i + 1, 10 * i + 2]
              for i, s in enumerate(SPLITS[name])}
    if name == "waymo":
        frames["skipped"] = [99]
    _write(name, tmp_path, frames)
    port, ref = _readers(name, tmp_path)
    assert port.num_classes == ref.num_classes
    assert port.get_label_to_names() == ref.get_label_to_names()
    for split in SPLITS[name]:
        got, want = port.get_split(split), ref.get_split(split)
        assert len(got) == len(want) == 2, split
        for i in range(len(want)):
            g, w = got.get_data(i), want.get_data(i)
            assert set(g) == set(w)
            assert g["point"].dtype == np.float32
            np.testing.assert_array_equal(g["point"], w["point"])
            assert g["feat"] is w["feat"] is None
            _same_calib(g["calib"], w["calib"])
            _same_boxes(g["bounding_boxes"], w["bounding_boxes"])
            assert got.get_attr(i) == want.get_attr(i)
    columns = {"nuscenes": 5, "lyft": 5, "waymo": 6, "argoverse": 3}[name]
    assert g["point"].shape == (FRAME_POINTS, columns)
    if name in ("nuscenes", "lyft"):  # the box without points is dropped
        assert len(g["bounding_boxes"]) == chip_smoke.PP_SCENE_BOXES
    if name == "waymo":
        for ds in (port, ref):
            ds.save_test_result([g["bounding_boxes"]], [got.get_attr(1)])
        (p,), (j,) = (sorted((tmp_path / d).iterdir()) for d in "pj")
        assert p.read_text() == j.read_text() != ""


@pytest.mark.parametrize("name", ["nuscenes", "lyft", "argoverse"])
def test_test_split_cannot_write_boxes_in_either_package(name, tmp_path):
    """The JAX fault, mirrored: these readers' frames carry no camera
    matrix, so a box built as ``inference_end`` builds it (the frame's
    ``world_cam``, no ``cam_img``) has no image rectangle and
    ``save_test_result``'s KITTI line fails on it
    (``open3d_ml_tpu/datasets/utils/bev_box.py:44``)."""
    _write(name, tmp_path, {"test": [1]})
    for ds, box in zip(_readers(name, tmp_path), (BEVBox3D, JaxBox)):
        split = ds.get_split("test")
        calib = split.get_data(0)["calib"]
        found = box([1.0, 2.0, -1.0], [1.9, 1.7, 4.5], 0.3, "car", 0.8,
                    None if calib is None else calib["world_cam"], None)
        with pytest.raises(TypeError) as err:
            ds.save_test_result([[found]], [split.get_attr(0)])
        if box is BEVBox3D:
            assert NO_CAMERA_FAULT in str(err.value)
        else:
            assert "not subscriptable" in str(err.value)


def test_info_readers_register_and_lyft_reuses_the_nuscenes_split():
    from open3d_ml_tpu_torch.datasets.nuscenes import NuScenesSplit
    from open3d_ml_tpu_torch.utils import get_module
    for name in ("NuScenes", "Lyft", "Waymo", "Argoverse"):
        assert get_module("dataset", name) is getattr(port_datasets, name)
    assert port_datasets.Lyft.get_label_to_names() == \
        jax_datasets.Lyft.get_label_to_names()
    lyft = port_datasets.Lyft(dataset_path="/nonexistent")
    assert lyft.num_classes == 9 and lyft.name == "Lyft"
    assert isinstance(lyft.get_split("train"), NuScenesSplit)


# ------------------------------------------------------------------ faults

def _few_points(model, n=500, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.zeros((1, 2048, 4), np.float32)
    pr = model.point_cloud_range
    for i in range(3):
        pts[0, :n, i] = rng.uniform(pr[i], pr[i + 3], n)
    return {"point": pts, "point_count": np.array([n], np.int32)}


def test_waymo_net_fails_in_the_neck_in_both_packages():
    """``pointpillars_waymo.yml``'s 468 x 468 canvas: stages of 234, 117
    and 59 cells, neck maps of 234, 234 and 236. The JAX nets' neck
    concatenation fails (``open3d_ml_tpu/models/point_pillars.py:263``),
    and so do the port's serving and eval nets, naming the fault."""
    kw = dict(yaml_model("waymo"), compute_dtype="float32")
    batch = _few_points(PointPillars(**kw))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JaxPointPillars(**kw)
    for jnet in (jmodel.get_net(), jmodel.get_eval_net()):
        with pytest.raises(TypeError, match="concatenate"):
            jax.eval_shape(lambda b, jnet=jnet: jnet.init(
                {"params": jax.random.PRNGKey(0)}, b, training=False),
                jbatch)
    model = PointPillars(**kw)
    x = {k: torch.from_numpy(v) for k, v in batch.items()}
    for net in (model.get_net(), model.get_eval_net()):
        with pytest.raises(RuntimeError) as err, torch.no_grad():
            net.eval()(x)
        assert NECK_FAULT in str(err.value)
        assert "(234, 234), (234, 234), (236, 236)" in str(err.value)


def test_argoverse_frame_fails_in_transform_in_both_packages(tmp_path):
    """The Argoverse reader gives [N, 3]; ``transform`` copies into [P, 4]
    and fails (``open3d_ml_tpu/models/point_pillars.py:546``) in both
    packages, the port naming the fault."""
    _write("argoverse", tmp_path, {"train": [1]})
    kw = yaml_model("argoverse")
    attr = {"split": "train"}
    for ds, model in zip(_readers("argoverse", tmp_path),
                         (PointPillars(**kw), JaxPointPillars(**kw))):
        data = model.preprocess(ds.get_split("train").get_data(0), attr)
        assert data["point"].shape[1] == 3
        with pytest.raises(ValueError) as err:
            model.transform(data, attr)
        assert "could not broadcast" in str(err.value)
        if isinstance(model, PointPillars):
            assert COLUMNS_FAULT in str(err.value)


# ----------------------------------------------------- nets at small shapes

def _frames(name, cfg):
    """A batch of ``B`` transformed frames of ``cfg`` (``pp_scene`` seeds 1
    and 2, the second of 3 boxes), 4 point columns."""
    model = PointPillars(**cfg)
    attr = {"split": "val"}
    samples = []
    for seed, boxes in ((1, 6), (2, 3)):
        pts, found = chip_smoke.pp_scene(cfg, seed, FRAME_POINTS, boxes)
        data = {"point": pts, "calib": None, "bounding_boxes": [
            BEVBox3D(b["center"], b["size"], b["yaw"], b["label_class"], -1)
            for b in found]}
        samples.append(model.transform(model.preprocess(data, attr), attr))
    return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in
            ("point", "point_count", "bboxes", "labels", "bbox_count")}


@pytest.fixture(scope="module", params=RUNNABLE)
def config_case(request):
    """The small config of one YAML, the port's seeded weights and their
    JAX variables, a batch, and both packages' head outputs per net."""
    name = request.param
    cfg = small(name)
    model, jmodel = PointPillars(**cfg), JaxPointPillars(**cfg)
    net = chip_smoke.pp_random_weights(model.get_net())
    variables = state_dict_to_jax(net.state_dict(), **net_layout(net))
    batch = _frames(name, cfg)
    x = {k: torch.from_numpy(batch[k]) for k in ("point", "point_count")}
    jx = {k: jnp.asarray(batch[k]) for k in ("point", "point_count")}
    outs = {}
    for mode, port_net, jnet in (
            ("canvas", net, jmodel.get_net()),
            ("compact", model.get_eval_net(), jmodel.get_eval_net())):
        port_net.load_state_dict(net.state_dict())
        with torch.no_grad():
            got = [o.numpy() for o in port_net.eval()(x)]
        want = jax.jit(lambda v, b, jnet=jnet: jnet.apply(
            v, b, training=False))(variables, jx)
        outs[mode] = (got, [np.asarray(w) for w in want])
    return {"name": name, "cfg": cfg, "model": model, "jmodel": jmodel,
            "batch": batch, "outs": outs}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_nets_equal_jax(config_case):
    """The canvas and the compact net, float32: each head output within
    1e-5 relative L2 of the JAX net's; the head's widths are the YAML's
    classes x sizes x rotations."""
    cfg = config_case["cfg"]
    anchors = len(cfg["head"]["sizes"]) * len(cfg["head"]["rotations"])
    for mode, (got, want) in config_case["outs"].items():
        assert got[0].shape == (B, CANVAS // 2, CANVAS // 2,
                                anchors * len(cfg["classes"]))
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-5, mode


def test_targets_and_loss_equal_jax(config_case):
    """``assign_bboxes`` on the frames' boxes (masks, labels and direction
    targets exact, deltas 1e-6, some positives for every sample) and
    ``get_loss`` on the canvas net's outputs (1e-5)."""
    model, jmodel = config_case["model"], config_case["jmodel"]
    batch = config_case["batch"]
    gt = [batch[k] for k in ("bboxes", "labels", "bbox_count")]
    with torch.no_grad():
        got = model.assign_bboxes(*[torch.from_numpy(g) for g in gt])
    want = jax.jit(jmodel.assign_bboxes)(*[jnp.asarray(g) for g in gt])
    for key in ("pos_mask", "neg_mask", "target_labels", "dir_targets"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["target_deltas"].numpy(),
                               np.asarray(want["target_deltas"]),
                               rtol=1e-6, atol=1e-6)
    pos = got["pos_mask"].numpy().reshape(B, -1)
    assert (pos.sum(1) > 0).all()

    outs = config_case["outs"]["canvas"][0]
    inputs = {k: batch[k] for k in ("bboxes", "labels", "bbox_count")}
    got = model.get_loss([torch.from_numpy(o) for o in outs],
                         {k: torch.from_numpy(v) for k, v in inputs.items()})
    want = jax.jit(jmodel.get_loss)([jnp.asarray(o) for o in outs],
                                    {k: jnp.asarray(v)
                                     for k, v in inputs.items()})
    for key in ("loss_cls", "loss_bbox", "loss_dir"):
        assert np.isfinite(got[key].item())
        assert abs(got[key].item() - float(want[key])) <= \
            1e-5 * abs(float(want[key])), key


def test_get_bboxes_equals_jax(config_case):
    """The decode over the YAML's C classes on the compact net's outputs,
    the CPU NMS: the same kept (class, candidate) set and labels; scores
    and boxes within 1e-6."""
    model, jmodel = config_case["model"], config_case["jmodel"]
    outs = config_case["outs"]["compact"][0]
    got = [t.numpy() for t in model.get_bboxes(
        *[torch.from_numpy(o) for o in outs])]
    want = [np.asarray(t) for t in jax.jit(jax.vmap(jmodel.get_bboxes))(
        *[jnp.asarray(o) for o in outs])]
    m = model.nms_pre * len(config_case["cfg"]["classes"])
    assert got[0].shape == (B, m, 7) and got[3].shape == (B, m)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].sum() > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0][got[3]], want[0][want[3]], atol=1e-6,
                               rtol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("name", RUNNABLE)
def test_eval_net_full_width(name):
    """The YAML's eval net (compact, float32) at its full canvas and
    depth, B=1 on a ``pp_scene`` frame of 32,768 points (Argoverse's with
    a zero intensity), the port's seeded weights: each head output within
    1e-5 relative L2 of the JAX eval net's."""
    kw = yaml_model(name)
    model = PointPillars(**kw)
    pts, _ = chip_smoke.pp_scene(kw, 5, kw["max_points"])
    batch = {"point": pts[None],
             "point_count": np.array([kw["max_points"]], np.int32)}
    net = chip_smoke.pp_random_weights(model.get_eval_net()).eval()
    with torch.no_grad():
        got = [o.numpy() for o in net(
            {k: torch.from_numpy(v) for k, v in batch.items()})]
    jnet = JaxPointPillars(**kw).get_eval_net()
    want = jax.jit(lambda v, b: jnet.apply(v, b, training=False))(
        state_dict_to_jax(net.state_dict(), **net_layout(net)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        assert _rel(g, w) <= 1e-5


def test_chip_smoke_configs_are_the_shipped_yamls():
    """``chip_smoke.PP_CONFIGS`` names the port's YAMLs of the phase."""
    for name, path in chip_smoke.PP_CONFIGS.items():
        assert (REPO / path).exists()
        assert Config.load_from_file(REPO / path).dataset.name == \
            READERS[name][0]
