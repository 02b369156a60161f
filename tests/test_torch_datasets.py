"""The port's dataset readers against the JAX package's, on the same files
written into ``tmp_path``: SemanticKITTI, Scannet, S3DIS, Semantic3D,
Toronto3D and ParisLille3D. For every split: the split list, the length,
every ``get_data`` array (bit-equal, dtype too) and ``get_attr``; then
``save_test_result`` (byte-identical files) and ``is_tested``. Also the
PLY reader and writer across the packages, the SemanticKITTI reader's
label rules, Scannet's ignored label through the loss's remap, and the
preprocess cache's key (a finding mirrored in both packages)."""

import filecmp
import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
import open3d_ml_tpu.datasets as jax_datasets
from open3d_ml_tpu.datasets.utils import ply as jax_ply
from open3d_ml_tpu.dataloaders.dataloader import (
    PointCloudDataloader as JaxLoader)
from open3d_ml_tpu.models.randlanet import RandLANet as JaxRandLANet
from open3d_ml_tpu.modules.losses.semseg_loss import (
    filter_valid_label as jax_filter_valid_label)
import open3d_ml_tpu_torch.datasets as port_datasets
from open3d_ml_tpu_torch.dataloaders import PointCloudDataloader
from open3d_ml_tpu_torch.datasets.utils import ply as port_ply
from open3d_ml_tpu_torch.models import RandLANet
from open3d_ml_tpu_torch.modules.losses import filter_valid_label
from torch_threads import one_torch_thread  # noqa: F401

SPLITS = ("training", "validation", "test", "all")


def _semantickitti(root):
    chip_smoke.write_semantickitti(root, 500, {"00": 2, "08": 1, "11": 1})
    return {}


def _scannet(root):
    rng = np.random.default_rng(0)
    lists = chip_smoke.REPO / "open3d_ml_tpu" / "datasets" / "_resources"
    for split, n in (("train", 80), ("val", 60), ("test", 40)):
        scene = (lists / "scannet" / f"scannetv2_{split}.txt").read_text(
        ).split()[0]
        np.save(root / f"{scene}_vert.npy",
                rng.uniform(0, 4, (n, 6)).astype(np.float32))
        np.save(root / f"{scene}_sem_label.npy",
                rng.choice([0, 1, 3, 4, 5, 39, 40], n))
        np.save(root / f"{scene}_ins_label.npy", rng.integers(0, 5, n))
        boxes = np.zeros((2, 7))
        boxes[:, :3] = rng.uniform(0, 4, (2, 3))
        boxes[:, 3:6] = rng.uniform(0.5, 2, (2, 3))
        boxes[:, 6] = [3, 39]
        np.save(root / f"{scene}_bbox.npy", boxes)
    return {}


def _s3dis(root):
    rng = np.random.default_rng(0)
    os.makedirs(root / "original_pkl")
    for name in ("Area_1_office_1.pkl", "Area_3_office_2.pkl",
                 "Area_3_hallway_1.pkl", "Area_5_lobby_1.pkl"):
        pc = rng.uniform(0, 5, (60, 7)).astype(np.float32)
        pc[:, 6] = rng.integers(0, 13, 60)
        pc[3, 1] = np.nan  # a row the reader drops
        with open(root / "original_pkl" / name, "wb") as f:
            pickle.dump((pc, []), f)
    return {"test_area_idx": 3}


def _semantic3d(root):
    rng = np.random.default_rng(0)
    for name, labelled in (("scan_a", True), ("scan_b", True),
                           ("bildstein_station3_xyz_intensity_rgb", True),
                           ("scan_test", False)):
        pc = rng.uniform(0, 10, (30, 7)).astype(np.float32)
        np.savetxt(root / f"{name}.txt", pc, fmt="%.4f")
        if labelled:
            np.savetxt(root / f"{name}.labels", rng.integers(0, 9, 30),
                       fmt="%d")
    return {}


def _toronto3d(root):
    rng = np.random.default_rng(0)
    for f in ("L001.ply", "L002.ply", "L003.ply", "L004.ply"):
        pts = rng.uniform(0, 10, (50, 3)) + [627285, 4841948, 0]
        rgb = rng.uniform(0, 255, (50, 3)).astype(np.float32)
        lab = rng.integers(0, 9, 50).astype(np.int32)
        port_ply.write_ply(str(root / f), [pts, rgb, lab],
                           ["x", "y", "z", "red", "green", "blue",
                            "scalar_Label"])
    return {}


def _parislille3d(root):
    rng = np.random.default_rng(0)
    os.makedirs(root / "training_10_classes")
    os.makedirs(root / "test_10_classes")
    for f in ("Lille1.ply", "Lille2.ply", "Paris.ply"):
        pts = rng.uniform(0, 10, (40, 3)).astype(np.float32)
        lab = rng.integers(0, 10, 40).astype(np.int32)
        port_ply.write_ply(str(root / "training_10_classes" / f),
                           [pts, lab], ["x", "y", "z", "class"])
    pts = rng.uniform(0, 10, (40, 3)).astype(np.float32)
    port_ply.write_ply(str(root / "test_10_classes" / "T1.ply"), [pts],
                       ["x", "y", "z"])
    return {}


READERS = {"SemanticKITTI": _semantickitti, "Scannet": _scannet,
           "S3DIS": _s3dis, "Semantic3D": _semantic3d,
           "Toronto3D": _toronto3d, "ParisLille3D": _parislille3d}


def _both(name, root, **kwargs):
    kwargs = dict(READERS[name](root), dataset_path=str(root), **kwargs)
    return (getattr(jax_datasets, name)(**kwargs),
            getattr(port_datasets, name)(**kwargs))


def _same_value(got, want, where):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, list) and want and hasattr(want[0], "yaw"):
        # boxes: the packages' own classes, attribute for attribute
        assert len(got) == len(want), where
        for g, w in zip(got, want):
            for attr in ("center", "size", "yaw", "label_class",
                         "confidence"):
                np.testing.assert_array_equal(getattr(g, attr),
                                              getattr(w, attr),
                                              err_msg=f"{where}.{attr}")
    else:
        assert got == want, where


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", list(READERS))
def test_reader_equals_jax(name, split, tmp_path):
    jds, tds = _both(name, tmp_path)
    assert tds.num_classes == jds.num_classes
    assert tds.get_label_to_names() == jds.get_label_to_names()
    want = jds.get_split_list(split)
    assert [str(p) for p in tds.get_split_list(split)] == [
        str(p) for p in want]
    jsplit, tsplit = jds.get_split(split), tds.get_split(split)
    assert len(tsplit) == len(jsplit)
    if split in ("training", "test"):
        assert len(tsplit) > 0, "the fixture fills this split"
    for idx in range(len(jsplit)):
        assert tsplit.get_attr(idx) == jsplit.get_attr(idx)
        try:
            want = jsplit.get_data(idx)
        except FileNotFoundError:
            # Semantic3D's all split reads labels for its test scans too,
            # which have none (a JAX fault, mirrored)
            assert (name, split) == ("Semantic3D", "all")
            with pytest.raises(FileNotFoundError):
                tsplit.get_data(idx)
            continue
        got = tsplit.get_data(idx)
        assert sorted(got) == sorted(want)
        for key in want:
            _same_value(got[key], want[key], f"{name} {split} {idx} {key}")


@pytest.mark.parametrize("name", list(READERS))
def test_save_test_result_equals_jax(name, tmp_path):
    """Each package writes the test split's predictions into its own
    folder: the same files, byte for byte; ``is_tested`` agrees before and
    after."""
    (tmp_path / "data").mkdir()
    jds, tds = _both(name, tmp_path / "data")
    jds.cfg.cfg_dict["test_result_folder"] = str(tmp_path / "jax")
    tds.cfg["test_result_folder"] = str(tmp_path / "port")
    jsplit, tsplit = jds.get_split("test"), tds.get_split("test")
    rng = np.random.default_rng(1)
    for idx in range(len(jsplit)):
        n = jsplit.get_data(idx)["point"].shape[0]
        pred = rng.integers(0, jds.num_classes, n).astype(np.int64)
        jattr, tattr = jsplit.get_attr(idx), tsplit.get_attr(idx)
        assert not tds.is_tested(tattr) and not jds.is_tested(jattr)
        jds.save_test_result({"predict_labels": pred.copy()}, jattr)
        tds.save_test_result({"predict_labels": pred.copy()}, tattr)
        assert tds.is_tested(tattr) and jds.is_tested(jattr)
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*") if p.is_file())
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert got == want and len(got) == len(jsplit) > 0
    for rel in got:
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "jax" / rel,
                           shallow=False), rel


def test_semantickitti_labels(tmp_path):
    """The instance bits are stripped and raw ids mapped; a test scan has
    no labels and reads as 0; a missing label file on a train split
    raises; predictions go back to raw uint32 ids past the ignored
    label."""
    paths = chip_smoke.write_semantickitti(tmp_path, 300, {"00": 1,
                                                           "11": 1})
    label_path = paths["00"][0].parent.parent / "labels" / "000000.label"
    raw = np.fromfile(label_path, np.uint32)
    assert (raw >> 16).any()
    ds = port_datasets.SemanticKITTI(dataset_path=str(tmp_path),
                                     test_result_folder=str(tmp_path / "r"))
    train = ds.get_split("training").get_data(0)
    np.testing.assert_array_equal(train["label"],
                                  ds.remap_lut_val[raw & 0xFFFF])
    assert train["feat"].shape == (300, 1)
    test = ds.get_split("test")
    assert not test.get_data(0)["label"].any()
    assert test.get_attr(0)["name"] == "11_000000"
    os.remove(label_path)
    with pytest.raises(FileNotFoundError):
        ds.get_split("training").get_data(0)
    pred = np.arange(19) % 19
    ds.save_test_result({"predict_labels": pred}, test.get_attr(0))
    written = np.fromfile(tmp_path / "r" / "sequences" / "11" /
                          "predictions" / "000000.label", np.uint32)
    from open3d_ml_tpu_torch.datasets._resources.semantickitti import (
        LEARNING_MAP_INV)
    np.testing.assert_array_equal(
        written, [LEARNING_MAP_INV[int(p) + 1] for p in pred])


def test_scannet_ignored_label_through_the_loss(tmp_path):
    """The reader maps nyu40 ids outside its 18 classes to -1; with the
    ScanNet YAML's ``ignored_label_inds: [-1]`` the loss's remap then
    moves every class down by one (classes 0 and 1 both train as 0), in
    both packages (a JAX fault, mirrored)."""
    _, tds = _both("Scannet", tmp_path)
    labels = tds.get_split("training").get_data(0)["label"]
    assert labels.min() == -1 and labels.max() <= 17
    want, wvalid = jax_filter_valid_label(None, labels, 20, [-1])
    got, gvalid = filter_valid_label(None, torch.from_numpy(labels), 20,
                                     [-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    both = labels[(labels == 0) | (labels == 1)]
    assert both.size and not got.numpy()[(labels == 0) | (labels == 1)].any()


@pytest.mark.parametrize("writer,reader", [
    (port_ply.write_ply, jax_ply.read_ply),
    (jax_ply.write_ply, port_ply.read_ply),
    (port_ply.write_ply, port_ply.read_ply)])
def test_ply_round_trip_across_packages(writer, reader, tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((100, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (100, 3)).astype(np.uint8)
    xyz64 = rng.standard_normal(100)
    labels = rng.integers(0, 9, 100).astype(np.int32)
    names = ["x", "y", "z", "red", "green", "blue", "d", "class"]
    writer(str(tmp_path / "a.ply"), [pts, rgb, xyz64, labels], names)
    jax_ply.write_ply(str(tmp_path / "b.ply"), [pts, rgb, xyz64, labels],
                      names)
    assert filecmp.cmp(tmp_path / "a.ply", tmp_path / "b.ply",
                       shallow=False)
    data = reader(str(tmp_path / "a.ply"))
    assert list(data) == names
    np.testing.assert_array_equal(
        np.stack([data["x"], data["y"], data["z"]], 1), pts)
    np.testing.assert_array_equal(data["d"], xyz64)
    np.testing.assert_array_equal(data["class"], labels)
    np.testing.assert_array_equal(data["red"], rgb[:, 0])


@pytest.mark.parametrize("fmt", ["ascii", "binary_big_endian"])
def test_ply_reader_formats_equal_jax(fmt, tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, (7, 3)).astype(np.float32)
    lab = rng.integers(0, 9, 7).astype(np.int32)
    head = (f"ply\nformat {fmt} 1.0\ncomment written by a test\n"
            "element vertex 7\nproperty float x\nproperty float y\n"
            "property float z\nproperty int label\n"
            "element face 0\nproperty list uchar int vertex_indices\n"
            "end_header\n")
    path = tmp_path / "c.ply"
    if fmt == "ascii":
        rows = "".join(f"{x} {y} {z} {c}\n" for (x, y, z), c in
                       zip(pts.tolist(), lab.tolist()))
        path.write_text(head + rows)
    else:
        rec = np.zeros(7, [("x", ">f4"), ("y", ">f4"), ("z", ">f4"),
                           ("label", ">i4")])
        for i, key in enumerate("xyz"):
            rec[key] = pts[:, i]
        rec["label"] = lab
        path.write_bytes(head.encode() + rec.tobytes())
    got, want = port_ply.read_ply(str(path)), jax_ply.read_ply(str(path))
    assert list(got) == list(want) == ["x", "y", "z", "label"]
    for key in want:
        _same_value(got[key], want[key], key)
    np.testing.assert_array_equal(got["label"], lab)


def test_preprocess_cache_key_is_per_instance(tmp_path):
    """Both packages key the preprocess cache by the hash of
    ``repr(model.preprocess)``, which holds the model's address: two model
    instances of one configuration write two cache directories (a JAX
    fault, mirrored: a new process never reads an old cache)."""
    root = tmp_path / "data"
    root.mkdir()
    jds, tds = _both("Semantic3D", root, use_cache=True,
                     cache_dir=str(tmp_path / "cache"))
    keys = []
    for models, loader, ds in (
            ((JaxRandLANet(in_channels=6), JaxRandLANet(in_channels=6)),
             JaxLoader, jds),
            ((RandLANet(in_channels=6), RandLANet(in_channels=6)),
             PointCloudDataloader, tds)):
        dirs = set()
        for model in models:
            split = ds.get_split("training")
            cached = loader(split, preprocess=model.preprocess,
                            use_cache=True)
            dirs.add(cached.cache_convert.cache_dir)
        keys.append(dirs)
    assert len(keys[0]) == 2 and len(keys[1]) == 2
