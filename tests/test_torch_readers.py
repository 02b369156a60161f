"""The port's remaining readers against the JAX package's, on the same
files written into ``tmp_path``: PandaSet (pandas pickles, plain and
gzipped), ShapeNet (part labels and classes), SUN RGB-D (depth arrays and
box pickles), Matterport objects (joblib files) and TUM-Facade (PCD files,
ascii and binary), and the PCD reader itself. For every split: the split
list, the length, every ``get_data`` array (bit-equal, dtype too), the
boxes attribute by attribute and ``get_attr``; then ``save_test_result``
(byte-identical files) and ``is_tested``.

Also: the PandaSet frame's one feature column against the YAML's
``in_channels: 3`` (``transform`` refuses it in both packages, as it
refuses SemanticKITTI's), the Matterport boxes' KITTI lines, which need a
camera matrix they lack (both packages fail), and the port importing
without ``joblib`` or ``pandas``. ``randlanet_pandaset.yml`` through the
command line is in ``test_torch_randla_configs_cli.py``.
"""

import filecmp
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import joblib
import numpy as np
import pandas as pd
import pytest
import yaml

import open3d_ml_tpu.datasets as jax_datasets
from open3d_ml_tpu.datasets.utils.pcd import read_pcd as jax_read_pcd
from open3d_ml_tpu.models.randlanet import RandLANet as JaxRandLANet
import open3d_ml_tpu_torch.datasets as port_datasets
from open3d_ml_tpu_torch.datasets.utils import read_pcd
from open3d_ml_tpu_torch.datasets.utils.bev_box import NO_CAMERA_FAULT
from open3d_ml_tpu_torch.models import RandLANet
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PANDASET_YML = (REPO / "open3d_ml_tpu_torch" / "configs" /
                "randlanet_pandaset.yml")
SEED = 3  # the dataset generator of the readers that shuffle their lists
PCD_FIELDS = ("FIELDS x y z classification intensity normal\n"
              "SIZE 4 4 4 4 2 8\nTYPE F F F I U F\nCOUNT 1 1 1 1 1 3\n")
PCD_DTYPE = np.dtype([("x", "f4"), ("y", "f4"), ("z", "f4"),
                      ("classification", "i4"), ("intensity", "u2"),
                      ("normal_0", "f8"), ("normal_1", "f8"),
                      ("normal_2", "f8")])


def _pandaset_frame(root, seq, frame, n, rng, suffix=".pkl"):
    (root / seq / "lidar").mkdir(parents=True, exist_ok=True)
    (root / seq / "annotations" / "semseg").mkdir(parents=True,
                                                   exist_ok=True)
    pd.DataFrame({
        "x": rng.uniform(-5, 5, n), "y": rng.uniform(-5, 5, n),
        "z": rng.uniform(-2, 1, n), "i": rng.uniform(0, 255, n),
        "t": rng.uniform(0, 1, n), "d": rng.integers(0, 2, n),
    }).to_pickle(root / seq / "lidar" / f"{frame}{suffix}")
    pd.DataFrame({"class": rng.integers(1, 40, n)}).to_pickle(
        root / seq / "annotations" / "semseg" / f"{frame}{suffix}")


def _pandaset(root):
    rng = np.random.default_rng(0)
    for seq, frame, n, suffix in (("001", "00", 60, ".pkl"),
                                  ("001", "01", 50, ".pkl.gz"),
                                  ("003", "00", 40, ".pkl.gz"),
                                  ("122", "00", 30, ".pkl"),
                                  ("115", "00", 45, ".pkl.gz"),
                                  ("999", "00", 20, ".pkl")):
        _pandaset_frame(root, seq, frame, n, rng, suffix)
    return {}


def _write_pcd(path, rows, data_format):
    header = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n" +
              PCD_FIELDS + f"WIDTH {len(rows)}\nHEIGHT 1\n"
              "VIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {len(rows)}\nDATA {data_format}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if data_format == "binary":
            f.write(rows.tobytes())
        else:
            for r in rows:
                f.write((" ".join(str(r[name]) for name in PCD_DTYPE.names)
                         + "\n").encode("ascii"))


def _pcd_rows(n, rng):
    rows = np.zeros(n, PCD_DTYPE)
    for name in ("x", "y", "z"):
        rows[name] = rng.uniform(0, 4, n)
    rows["classification"] = rng.integers(0, 18, n)
    rows["intensity"] = rng.integers(0, 65535, n)
    for c in range(3):
        rows[f"normal_{c}"] = rng.standard_normal(n)
    return rows


def _tumfacade(root):
    rng = np.random.default_rng(0)
    crs = root / "pointclouds" / "annotatedLocalCRS"
    for folder, names in (("training_files", ("f0", "f1")),
                          ("validation_files", ("f2",)),
                          ("test_files", ("f3",))):
        os.makedirs(crs / folder)
        for i, name in enumerate(names):
            _write_pcd(crs / folder / f"{name}.pcd", _pcd_rows(30 + i, rng),
                       "binary" if i % 2 == 0 else "ascii")
    # a global-CRS cloud without labels
    os.makedirs(root / "pointclouds" / "annotatedGlobalCRS" /
                "training_files")
    (root / "pointclouds" / "annotatedGlobalCRS" / "training_files" /
     "g0.pcd").write_text("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                          "POINTS 2\nDATA ascii\n1 2 3\n4 5 6\n")
    return {}


def _shapenet(root):
    rng = np.random.default_rng(0)
    sub = root / "shapenetcore_partanno_segmentation_benchmark_v0"
    (sub / "train_test_split").mkdir(parents=True)
    cats = {"02691156": "Airplane", "03001627": "Chair"}
    (sub / "synsetoffset2category.txt").write_text(
        "".join(f"{name}\t{cat}\n" for cat, name in cats.items()))
    lists = {"train": [], "test": [], "val": []}
    for c, cat in enumerate(cats):
        (sub / cat / "points").mkdir(parents=True)
        (sub / cat / "points_label").mkdir()
        for t in range(5):
            token = f"m{c}{t}"
            n = 20 + 3 * t
            np.savetxt(sub / cat / "points" / f"{token}.pts",
                       rng.uniform(-1, 1, (n, 3)).astype(np.float32))
            np.savetxt(sub / cat / "points_label" / f"{token}.seg",
                       rng.integers(1, 5, n), fmt="%d")
            which = ("train", "train", "test", "val", "other")[t]
            if which != "other":
                lists[which].append(f"shape_data/{cat}/{token}")
    for split, files in lists.items():
        (sub / "train_test_split" /
         f"shuffled_{split}_file_list.json").write_text(json.dumps(files))
    return {"seed": SEED}


def _sunrgbd(root):
    rng = np.random.default_rng(0)
    os.makedirs(root / "depth")
    os.makedirs(root / "label")
    for i, fid in enumerate(("000001", "000002", "000003", "000004")):
        np.save(root / "depth" / f"{fid}.npy",
                rng.uniform(-3, 3, (40 + i, 6)).astype(np.float32))
        boxes = []
        for b in range(1 + i % 2):
            box = ["bed" if b == 0 else "chair",
                   *rng.uniform(-2, 2, 3), *rng.uniform(0.2, 1.5, 3),
                   *rng.uniform(0.1, 1, 2)]
            if b == 1:
                box += list(rng.uniform(0, 100, 4))  # the 2D box
            boxes.append(box)
        with open(root / "label" / f"{fid}.pkl", "wb") as f:
            pickle.dump(boxes, f)
    (root / "train_data_idx.txt").write_text("000001\n000003\n000004\n")
    (root / "val_data_idx.txt").write_text("000002\n")
    return {}


def _matterport(root):
    rng = np.random.default_rng(0)
    for split, names in (("training", ("s0", "s1", "s2")),
                         ("testing", ("s3",))):
        os.makedirs(root / split / "pc")
        os.makedirs(root / split / "boxes")
        for name in names:
            joblib.dump(rng.uniform(-3, 3, (30, 3)).astype(np.float32),
                        root / split / "pc" / f"{name}.bin")
            boxes = [("chair", 0, 0, 10, 10, *rng.uniform(-2, 2, 3),
                      *rng.uniform(0.3, 1.2, 3), float(rng.uniform(0, 360)))
                     for _ in range(2)]
            joblib.dump(boxes, root / split / "boxes" / f"{name}.txt")
    return {"seed": SEED, "val_split": 1}


READERS = {"Pandaset": _pandaset, "TUMFacade": _tumfacade,
           "ShapeNet": _shapenet, "SunRGBD": _sunrgbd,
           "MatterportObjects": _matterport}
SPLITS = {"Pandaset": ("training", "validation", "test", "all"),
          "TUMFacade": ("training", "validation", "test", "all"),
          "ShapeNet": ("training", "validation", "test", "all"),
          "SunRGBD": ("training", "validation", "test"),
          "MatterportObjects": ("training", "validation", "test", "all")}
CASES = [(name, split) for name, splits in SPLITS.items()
         for split in splits]


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
            assert type(g).__name__ == type(w).__name__, where
            for attr in ("center", "size", "yaw", "label_class",
                         "confidence", "front", "left", "up", "level",
                         "dis_to_cam", "box2d"):
                if hasattr(w, attr):
                    np.testing.assert_array_equal(
                        getattr(g, attr), getattr(w, attr),
                        err_msg=f"{where}.{attr}")
            np.testing.assert_array_equal(g.to_xyzwhlr(), w.to_xyzwhlr())
    else:
        assert got == want, where


@pytest.mark.parametrize("name,split", CASES)
def test_reader_equals_jax(name, split, tmp_path):
    jds, tds = _both(name, tmp_path)
    assert tds.num_classes == jds.num_classes
    assert tds.label_to_names == jds.label_to_names
    want = jds.get_split_list(split)
    assert tds.get_split_list(split) == want
    jsplit, tsplit = jds.get_split(split), tds.get_split(split)
    assert len(tsplit) == len(jsplit)
    if split in ("training", "test"):
        assert len(tsplit) > 0, "the fixture fills this split"
    for idx in range(len(jsplit)):
        assert tsplit.get_attr(idx) == jsplit.get_attr(idx)
        want = jsplit.get_data(idx)
        got = tsplit.get_data(idx)
        assert sorted(got) == sorted(want)
        for key in want:
            _same_value(got[key], want[key], f"{name} {split} {idx} {key}")


def test_splits_the_readers_refuse(tmp_path):
    """SUN RGB-D has no 'all' split; every reader refuses an unknown
    name; ShapeNet refuses an unknown task; TUM-Facade's global CRS reads
    its own folder."""
    for name in READERS:
        root = tmp_path / name
        root.mkdir()
        jds, tds = _both(name, root)
        bad = ("all", "nonsense") if name == "SunRGBD" else ("nonsense",)
        for split in bad:
            for ds in (jds, tds):
                with pytest.raises(ValueError):
                    ds.get_split_list(split)
    for pkg in (jax_datasets, port_datasets):
        with pytest.raises(ValueError):
            pkg.ShapeNet.get_label_to_names("parts")
        ds = pkg.TUMFacade(dataset_path=str(tmp_path / "TUMFacade"),
                           use_global=True)
        data = ds.get_split("training").get_data(0)
        np.testing.assert_array_equal(data["point"], [[1, 2, 3], [4, 5, 6]])
        assert data["label"].dtype == np.int32 and not data["label"].any()


def test_shapenet_segmentation_task(tmp_path):
    jds, tds = _both("ShapeNet", tmp_path, task="segmentation")
    assert tds.num_classes == jds.num_classes == 50
    for split in ("training", "validation", "test"):
        jsplit, tsplit = jds.get_split(split), tds.get_split(split)
        assert tsplit.sampler is None
        for idx in range(len(jsplit)):
            got, want = tsplit.get_data(idx), jsplit.get_data(idx)
            for key in ("point", "label"):
                _same_value(got[key], want[key], f"{split} {idx} {key}")
            assert got["label"].shape == got["point"].shape[:1]


@pytest.mark.parametrize("name", ["Pandaset", "ShapeNet", "TUMFacade"])
def test_semseg_save_test_result_equals_jax(name, tmp_path):
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
        assert tds.is_tested(tattr) == jds.is_tested(jattr) is False
        jds.save_test_result({"predict_labels": pred.copy()}, jattr)
        tds.save_test_result({"predict_labels": pred.copy()}, tattr)
        assert tds.is_tested(tattr) == jds.is_tested(jattr)
    _same_files(tmp_path / "port", tmp_path / "jax", len(jsplit))


def _same_files(port, jax, count):
    got = sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    want = sorted(p.relative_to(jax) for p in jax.rglob("*") if p.is_file())
    assert got == want and len(got) == count > 0
    for rel in got:
        assert filecmp.cmp(port / rel, jax / rel, shallow=False), rel


def test_pandaset_writes_no_dataset_folder(tmp_path):
    """PandaSet's results are ``<test_result_folder>/<seq>_<frame>.npy``,
    the labels as predicted (no shift past an ignored label)."""
    (tmp_path / "data").mkdir()
    ds = port_datasets.Pandaset(**_pandaset(tmp_path / "data"),
                                dataset_path=str(tmp_path / "data"),
                                test_result_folder=str(tmp_path / "out"),
                                ignored_label_inds=[0])
    attr = ds.get_split("test").get_attr(0)
    assert attr["name"] == "115_00"
    ds.save_test_result({"predict_labels": np.arange(5)}, attr)
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "115_00.npy"),
                                  np.arange(5))


def test_detection_save_test_result_equals_jax(tmp_path):
    """SUN RGB-D writes each frame's boxes as [n, 7] arrays, byte-identical
    in both packages; Matterport writes KITTI lines, empty files for no
    box, and fails in both packages on a box: its boxes have no camera
    matrix (ROADMAP.md queue 3, ``NO_CAMERA_FAULT``)."""
    for name in ("SunRGBD", "MatterportObjects"):
        (tmp_path / name).mkdir()
        jds, tds = _both(name, tmp_path / name)
        jds.cfg.cfg_dict["test_result_folder"] = str(tmp_path / "jax" / name)
        tds.cfg["test_result_folder"] = str(tmp_path / "port" / name)
        jsplit, tsplit = jds.get_split("test"), tds.get_split("test")
        jattrs = [jsplit.get_attr(i) for i in range(len(jsplit))]
        tattrs = [tsplit.get_attr(i) for i in range(len(tsplit))]
        assert tattrs == jattrs
        assert not tds.is_tested(tattrs[0]) and not jds.is_tested(jattrs[0])
        if name == "SunRGBD":
            results = [(jsplit.get_data(i)["bounding_boxes"],
                        tsplit.get_data(i)["bounding_boxes"])
                       for i in range(len(jsplit))]
        else:
            results = [([], []) for _ in jattrs]
        jds.save_test_result([r[0] for r in results], jattrs)
        tds.save_test_result([r[1] for r in results], tattrs)
        _same_files(tmp_path / "port" / name, tmp_path / "jax" / name,
                    len(jattrs))
    boxes = (jsplit.get_data(0)["bounding_boxes"],
             tsplit.get_data(0)["bounding_boxes"])
    with pytest.raises(TypeError):
        jds.save_test_result([boxes[0]], jattrs)
    with pytest.raises(TypeError, match="no image rectangle") as err:
        tds.save_test_result([boxes[1]], tattrs)
    assert NO_CAMERA_FAULT in str(err.value)


@pytest.mark.parametrize("data_format", ["ascii", "binary"])
def test_read_pcd_equals_jax(data_format, tmp_path):
    """Every field and type of the header, a field of COUNT 3 split in
    three, ascii and binary data: the same arrays, dtypes and order."""
    rows = _pcd_rows(25, np.random.default_rng(5))
    _write_pcd(tmp_path / "a.pcd", rows, data_format)
    got, want = read_pcd(tmp_path / "a.pcd"), jax_read_pcd(tmp_path / "a.pcd")
    assert list(got) == list(want) == list(PCD_DTYPE.names)
    for key in want:
        _same_value(got[key], want[key], key)
    np.testing.assert_array_equal(got["classification"],
                                  rows["classification"])
    (tmp_path / "c.pcd").write_text("FIELDS x\nSIZE 4\nTYPE F\nPOINTS 1\n"
                                    "DATA binary_compressed\n")
    for reader in (read_pcd, jax_read_pcd):
        with pytest.raises(ValueError):
            reader(tmp_path / "c.pcd")


def test_pandaset_feature_width_fault_in_both_packages(tmp_path):
    """A PandaSet frame's ``feat`` is its intensity, one column, so
    ``randlanet_pandaset.yml``'s ``in_channels: 3`` makes ``transform``
    refuse the reader's frames in both packages (as SemanticKITTI's, a
    JAX fault mirrored: ROADMAP.md queue 3); 3 + 1 channels run."""
    shipped = yaml.safe_load(PANDASET_YML.read_text())["model"]
    assert shipped["in_channels"] == 3
    for ds, cls in zip(_both("Pandaset", tmp_path),
                       (JaxRandLANet, RandLANet)):
        split = ds.get_split("training")
        data, attr = split.get_data(0), split.get_attr(0)
        assert data["feat"].shape == (data["point"].shape[0], 1)
        for channels in (3, 4):
            model = cls(num_points=32, in_channels=channels)
            model.trans_point_sampler = split.sampler.get_point_sampler()
            pre = model.preprocess(data, attr)
            if channels == 3:
                with pytest.raises(RuntimeError,
                                   match="Wrong feature dimension"):
                    model.transform(pre, attr)
            else:
                out = model.transform(pre, attr)
                assert out["features"].shape == (32, 4)


def test_port_imports_without_joblib_and_pandas(tmp_path):
    """With ``joblib`` and ``pandas`` unimportable the port and its new
    readers import, and a Matterport dataset lists its files; only
    reading one needs ``joblib``."""
    _matterport(tmp_path)
    code = ("import sys\n"
            "sys.modules['joblib'] = None\n"
            "sys.modules['pandas'] = None\n"
            "import open3d_ml_tpu_torch\n"
            "from open3d_ml_tpu_torch.datasets import (MatterportObjects,\n"
            "    Pandaset, ShapeNet, SunRGBD, TUMFacade)\n"
            f"ds = MatterportObjects(dataset_path={str(tmp_path)!r},\n"
            "                       val_split=1)\n"
            "assert len(ds.get_split('training')) == 2\n"
            "try:\n"
            "    ds.get_split('training').get_data(0)\n"
            "except ImportError:\n"
            "    print('refused')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         check=True, timeout=120, capture_output=True,
                         text=True)
    assert out.stdout.strip() == "refused"
