"""Procedural semantic segmentation scenes (numpy only).

Counterpart of ``open3d_ml_tpu/datasets/synthetic.py``. Semantic
segmentation (``make_semseg_scene``, ``SyntheticShapes``): seeded scenes whose
labels are functions of local geometry (roughness, curvature radius, 1-D,
2-D or 3-D structure, density, slab thickness), so a point's class is
predictable only through its neighbourhood. A scene has a ground disk with
1/r radial density, shape instances whose point counts fall off as 1/r,
and unlabelled clutter (class 0, ignored). The same seed gives the JAX
package's scene, bit for bit.

Classes (19, class 0 ignored): 0 clutter; 1 ground; 2/3/4 planar patches
of roughness 0.02/0.15/0.45; 5/6/7 sphere shells of radius 0.5/1.5/3.0;
8/9/10 vertical cylinder shells of radius 0.3/1.0/2.5; 11/12 wires of
thickness 0.02/0.25; 13/14 solid balls of radius 0.8/2.0; 15/16 flat and
tall Gaussian blobs; 17 double plane; 18 sparse planar patch.

Object detection (``make_objdet_scene``, ``SyntheticBoxes``): KITTI-like
front-sector scenes of cars, pedestrians and cyclists as point shells of
their boxes over a ground plane, with clutter; the same seed gives the
JAX package's scene and boxes, bit for bit.
"""

from os.path import exists, join

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset, BaseDatasetSplit
from .utils import BEVBox3D

_SPLIT_SEEDS = {"train": 0, "training": 0, "val": 1, "validation": 1,
                "test": 2, "testing": 2, "all": 3}


def _unit(v):
    return v / (np.linalg.norm(v) + 1e-12)


def _radial_centers(rng, k, r_min=3.0, r_max=42.0):
    """k cluster centers with ~1/r radial density (lidar-like)."""
    # p(r) ~ 1/r  =>  r = r_min * (r_max/r_min)**u
    r = r_min * (r_max / r_min) ** rng.uniform(0, 1, k)
    th = rng.uniform(0, 2 * np.pi, k)
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=1), r


def _ground(rng, n, r_min=2.0, r_max=45.0):
    r = r_min * (r_max / r_min) ** rng.uniform(0, 1, n)
    th = rng.uniform(0, 2 * np.pi, n)
    x, y = r * np.cos(th), r * np.sin(th)
    z = (0.15 * np.sin(0.11 * x) * np.cos(0.13 * y) +
         rng.normal(0, 0.02, n))
    return np.stack([x, y, z], axis=1)


def _plane_patch(rng, n, sigma, extent):
    normal = _unit(rng.normal(0, 1, 3) + [0, 0, 2.0])  # mostly-horizontal
    a = _unit(np.cross(normal, [1.0, 0.0, 0.0] if abs(normal[0]) < 0.9
                       else [0.0, 1.0, 0.0]))
    b = np.cross(normal, a)
    uv = rng.uniform(-extent, extent, (n, 2))
    return (uv[:, :1] * a + uv[:, 1:2] * b +
            rng.normal(0, sigma, (n, 1)) * normal)

def _sphere_shell(rng, n, radius):
    v = rng.normal(0, 1, (n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    return v * radius + rng.normal(0, 0.02, (n, 3))


def _cylinder_shell(rng, n, radius, height):
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(0, height, n)
    return np.stack([radius * np.cos(th), radius * np.sin(th), z],
                    axis=1) + rng.normal(0, 0.02, (n, 3))


def _wire(rng, n, thickness, length):
    d = _unit(rng.normal(0, 1, 3))
    t = rng.uniform(-length / 2, length / 2, (n, 1))
    return t * d + rng.normal(0, thickness, (n, 3))


def _ball(rng, n, radius):
    v = rng.normal(0, 1, (n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-12
    return v * radius * rng.uniform(0, 1, (n, 1)) ** (1 / 3)


def _blob(rng, n, sigmas):
    return rng.normal(0, 1, (n, 3)) * np.asarray(sigmas)


def _double_plane(rng, n, gap=0.3, extent=1.5):
    pts = _plane_patch(rng, n, 0.02, extent)
    sheet = rng.integers(0, 2, n).astype(np.float64) * gap
    return pts + sheet[:, None] * np.array([0.0, 0.0, 1.0])


# class id -> (points_per_instance_base, z_lift, generator)
_SEMSEG_SHAPES = {
    2: (480, 0.0, lambda rng, n: _plane_patch(rng, n, 0.02, 2.0)),
    3: (480, 0.0, lambda rng, n: _plane_patch(rng, n, 0.15, 2.0)),
    4: (480, 0.0, lambda rng, n: _plane_patch(rng, n, 0.45, 2.0)),
    5: (360, 0.5, lambda rng, n: _sphere_shell(rng, n, 0.5)),
    6: (480, 1.5, lambda rng, n: _sphere_shell(rng, n, 1.5)),
    7: (600, 3.0, lambda rng, n: _sphere_shell(rng, n, 3.0)),
    8: (360, 0.0, lambda rng, n: _cylinder_shell(rng, n, 0.3, 3.0)),
    9: (480, 0.0, lambda rng, n: _cylinder_shell(rng, n, 1.0, 3.0)),
    10: (600, 0.0, lambda rng, n: _cylinder_shell(rng, n, 2.5, 3.0)),
    11: (300, 2.0, lambda rng, n: _wire(rng, n, 0.02, 6.0)),
    12: (300, 2.0, lambda rng, n: _wire(rng, n, 0.25, 6.0)),
    13: (420, 0.8, lambda rng, n: _ball(rng, n, 0.8)),
    14: (540, 2.0, lambda rng, n: _ball(rng, n, 2.0)),
    15: (420, 0.3, lambda rng, n: _blob(rng, n, (1.2, 1.2, 0.1))),
    16: (420, 1.5, lambda rng, n: _blob(rng, n, (0.3, 0.3, 1.5))),
    17: (480, 0.0, lambda rng, n: _double_plane(rng, n, gap=0.5)),
    18: (96, 0.0, lambda rng, n: _plane_patch(rng, n, 0.02, 2.0)),
}

NUM_SEMSEG_CLASSES = 19


def make_semseg_scene(n_points, seed, ground_frac=0.30, clutter_frac=0.02,
                      instances=140):
    """One labeled scene: (points [n,3] f32, labels [n] int32).

    Deterministic in (n_points, seed). Instance classes cycle through all
    17 shape classes so every class appears in every scene.
    """
    rng = np.random.default_rng(seed)
    parts, labels = [], []

    n_ground = int(n_points * ground_frac)
    parts.append(_ground(rng, n_ground))
    labels.append(np.full(n_ground, 1, np.int32))

    centers, radii = _radial_centers(rng, instances)
    class_ids = [2 + (i % (NUM_SEMSEG_CLASSES - 2))
                 for i in range(instances)]
    rng.shuffle(class_ids)
    for (cx, cy), r, cid in zip(centers, radii, class_ids):
        base, lift, gen = _SEMSEG_SHAPES[cid]
        n_i = max(24, int(base * 6.0 / r))  # ~1/r points per instance
        pts = gen(rng, n_i)
        pts = pts + np.array([cx, cy, lift])
        parts.append(pts)
        labels.append(np.full(n_i, cid, np.int32))

    n_clutter = int(n_points * clutter_frac)
    cl, _ = _radial_centers(rng, n_clutter, r_min=2.0, r_max=45.0)
    clutter = np.concatenate(
        [cl, rng.uniform(0, 4, (n_clutter, 1))], axis=1)
    parts.append(clutter)
    labels.append(np.zeros(n_clutter, np.int32))

    points = np.concatenate(parts, axis=0).astype(np.float32)
    labels = np.concatenate(labels, axis=0)
    # trim/top-up to exactly n_points (top-up duplicates ground points)
    if len(points) >= n_points:
        sel = rng.permutation(len(points))[:n_points]
    else:
        extra = rng.integers(0, n_ground, n_points - len(points))
        sel = np.concatenate([np.arange(len(points)), extra])
        rng.shuffle(sel)
    return points[sel], labels[sel].astype(np.int32)


def _split_names(num_clouds, split):
    """The cloud names of ``split``: '<split>_0000' on, as many as
    ``num_clouds`` gives it (2 where it names none)."""
    counts = dict(num_clouds)
    alias = {"train": "training", "val": "validation",
             "test": "testing" if "testing" in counts else "test"}
    key = alias.get(split, split)
    if key == "all":
        n = sum(int(v) for v in counts.values())
    else:
        n = int(counts.get(key, counts.get(
            {"testing": "test", "test": "testing"}.get(key, key), 2)))
    return [f"{key}_{i:04d}" for i in range(n)]


class _SyntheticSplit(BaseDatasetSplit):

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        seed = (int(self.cfg.get("seed", 0) or 0) * 100003 +
                _SPLIT_SEEDS.get(self.split, 3) * 7919 + idx)
        points, labels = make_semseg_scene(self.cfg.num_points_per_cloud,
                                           seed)
        return {"point": points, "feat": None, "label": labels}

    def get_attr(self, idx):
        return {"idx": idx, "name": self.path_list[idx],
                "path": self.path_list[idx], "split": self.split}


@DATASET.register_module()
class SyntheticShapes(BaseDataset):
    """Procedural semseg dataset; no files, fully seeded. Scene ``idx`` of
    a split is ``make_semseg_scene(num_points_per_cloud, seed * 100003 +
    split seed * 7919 + idx)``."""

    def __init__(self,
                 dataset_path="synthetic://shapes",
                 name="SyntheticShapes",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 num_points_per_cloud=54000,
                 num_clouds={"training": 16, "validation": 2, "test": 2},
                 ignored_label_inds=[0],
                 test_result_folder="./test",
                 seed=0,
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         num_points_per_cloud=num_points_per_cloud,
                         num_clouds=num_clouds,
                         ignored_label_inds=ignored_label_inds,
                         test_result_folder=test_result_folder,
                         seed=seed,
                         **kwargs)
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.label_to_names)

    @staticmethod
    def get_label_to_names():
        names = {
            0: "clutter", 1: "ground", 2: "plane_smooth", 3: "plane_rough",
            4: "plane_very_rough", 5: "sphere_small", 6: "sphere_mid",
            7: "sphere_large", 8: "cyl_small", 9: "cyl_mid", 10: "cyl_large",
            11: "wire_thin", 12: "wire_thick", 13: "ball_small",
            14: "ball_large", 15: "blob_flat", 16: "blob_tall",
            17: "double_plane", 18: "plane_sparse"
        }
        return names

    def get_split(self, split):
        return _SyntheticSplit(self, split=split)

    def get_split_list(self, split):
        return _split_names(self.cfg.num_clouds, split)

    def is_tested(self, attr):
        return exists(join(self.cfg.test_result_folder,
                           attr["name"] + ".npy"))

    def save_test_result(self, results, attr):
        make_dir(self.cfg.test_result_folder)
        pred = np.asarray(results["predict_labels"]).copy()
        # channel space -> label space (predictions index the dense class
        # axis with ignored labels compacted out; reference convention,
        # ml3d/datasets/semantickitti.py:186-188)
        for ign in self.cfg.ignored_label_inds:
            pred[pred >= ign] += 1
        np.save(join(self.cfg.test_result_folder, attr["name"] + ".npy"),
                pred)


# --------------------------------------------------------------------- objdet

_OBJ_CLASSES = {
    # class -> ((w, l, h) mean, (w, l, h) jitter, base points)
    "Car": ((1.6, 3.9, 1.56), (0.15, 0.35, 0.1), 320),
    "Pedestrian": ((0.6, 0.8, 1.73), (0.08, 0.1, 0.12), 90),
    "Cyclist": ((0.6, 1.76, 1.73), (0.08, 0.15, 0.12), 140),
}


def make_objdet_scene(seed, n_objects=12, r_max=38.0):
    """A KITTI-like scene: (points [N, 4] float32, list of box dicts).

    The points lie in the front sector (x > 0, |y| < x, as KITTI's camera
    sees); each object is a point shell of its box (walls and top); a box
    is {'center', 'size' (w, h, l), 'yaw', 'label_class'}.
    """
    rng = np.random.default_rng(seed)
    parts = []

    n_ground = 9000
    x = 2.0 + (r_max - 2.0) * rng.uniform(0, 1, n_ground) ** 1.5
    y = x * rng.uniform(-0.55, 0.55, n_ground)
    z = rng.normal(-1.7, 0.03, n_ground)
    inten = rng.uniform(0, 0.4, n_ground)
    parts.append(np.stack([x, y, z, inten], axis=1))

    boxes = []
    names = list(_OBJ_CLASSES)
    for _ in range(n_objects):
        cls = names[rng.integers(0, len(names))]
        (w0, l0, h0), (jw, jl, jh), base = _OBJ_CLASSES[cls]
        w = w0 + rng.uniform(-jw, jw)
        l = l0 + rng.uniform(-jl, jl)
        h = h0 + rng.uniform(-jh, jh)
        cx = rng.uniform(6, r_max)
        cy = cx * rng.uniform(-0.5, 0.5)
        cz = -1.7 + h / 2
        yaw = rng.uniform(-np.pi, np.pi)

        n_i = max(16, int(base * 12.0 / cx))
        # points on the box's sides and top, axis-aligned, then rotated
        face = rng.integers(0, 5, n_i)
        u = rng.uniform(-0.5, 0.5, n_i)
        v = rng.uniform(-0.5, 0.5, n_i)
        px = np.where(face == 0, -w / 2, np.where(face == 1, w / 2, u * w))
        py = np.where(face == 2, -l / 2, np.where(face == 3, l / 2, v * l))
        pz = np.where(face == 4, h / 2, v * h)
        py = np.where(face < 2, u * l, py)
        pz = np.where(face < 4, rng.uniform(-0.5, 0.5, n_i) * h, pz)
        c, s = np.cos(yaw), np.sin(yaw)
        rx = c * px - s * py
        ry = s * px + c * py
        pts = np.stack([cx + rx, cy + ry, cz + pz,
                        rng.uniform(0.3, 1.0, n_i)], axis=1)
        pts[:, :3] += rng.normal(0, 0.02, (n_i, 3))
        parts.append(pts)
        boxes.append({"center": np.array([cx, cy, cz]),
                      "size": np.array([w, h, l]),
                      "yaw": yaw, "label_class": cls})

    n_clutter = 400
    x = rng.uniform(2, r_max, n_clutter)
    y = x * rng.uniform(-0.55, 0.55, n_clutter)
    z = rng.uniform(-1.7, 1.0, n_clutter)
    parts.append(np.stack([x, y, z,
                           rng.uniform(0, 1, n_clutter)], axis=1))

    points = np.concatenate(parts, axis=0).astype(np.float32)
    return points[rng.permutation(len(points))], boxes


class _SyntheticBoxSplit(BaseDatasetSplit):
    """A split of ``SyntheticBoxes``; detection draws no patches, so it
    has no sampler."""

    def __init__(self, dataset, split="training"):
        self.cfg = dataset.cfg
        self.path_list = dataset.get_split_list(split)
        self.split = split
        self.dataset = dataset
        self.sampler = None

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        seed = (int(self.cfg.get("seed", 0) or 0) * 100003 +
                _SPLIT_SEEDS.get(self.split, 3) * 7919 + idx)
        points, boxes = make_objdet_scene(seed)
        bboxes = [BEVBox3D(b["center"], b["size"], b["yaw"],
                           b["label_class"], -1.0) for b in boxes]
        return {"point": points, "feat": None, "calib": None,
                "bounding_boxes": bboxes}

    def get_attr(self, idx):
        return {"idx": idx, "name": self.path_list[idx],
                "path": self.path_list[idx], "split": self.split}


@DATASET.register_module()
class SyntheticBoxes(BaseDataset):
    """Procedural detection dataset (KITTI-like front sector); no files,
    fully seeded. Scene ``idx`` of a split is ``make_objdet_scene(seed *
    100003 + split seed * 7919 + idx)``."""

    def __init__(self,
                 dataset_path="synthetic://boxes",
                 name="SyntheticBoxes",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 num_clouds={"training": 16, "validation": 2, "test": 2},
                 test_result_folder="./test",
                 seed=0,
                 **kwargs):
        super().__init__(dataset_path=dataset_path, name=name,
                         cache_dir=cache_dir, use_cache=use_cache,
                         num_clouds=num_clouds,
                         test_result_folder=test_result_folder, seed=seed,
                         **kwargs)
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.label_to_names)

    @staticmethod
    def get_label_to_names():
        return {0: "Pedestrian", 1: "Cyclist", 2: "Car"}

    def get_split(self, split):
        return _SyntheticBoxSplit(self, split=split)

    def get_split_list(self, split):
        return _split_names(self.cfg.num_clouds, split)

    def is_tested(self, attr):
        return exists(join(self.cfg.test_result_folder,
                           attr["name"] + ".txt"))

    def save_test_result(self, results, attrs):
        """Write each frame's boxes as a KITTI label file; ``results`` and
        ``attrs`` are lists over frames, as ``ObjectDetection.run_test``
        passes them (the JAX class takes one frame)."""
        make_dir(self.cfg.test_result_folder)
        for boxes, attr in zip(results, attrs):
            path = join(self.cfg.test_result_folder, attr["name"] + ".txt")
            with open(path, "w") as f:
                for box in boxes:
                    f.write(box.to_kitti_format(box.confidence) + "\n")
