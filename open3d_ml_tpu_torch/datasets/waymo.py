"""Waymo Open Dataset reader (KITTI-format export).

Counterpart of ``open3d_ml_tpu/datasets/waymo.py``, the same code: frames
that the reference's Waymo converter exports in KITTI's layout,
``velodyne/*.bin`` as [N, 6] float32 (x, y, z, intensity, elongation,
timestamp), KITTI calib files and the boxes of ``label_all/``, split by
the file name's ``train``, ``val`` or ``test``; KITTI-format result
files. Its splits draw no patches, so they have no sampler.
"""

import logging
from glob import glob
from os.path import join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset
from .kitti import KITTI, KITTISplit, Object3d

log = logging.getLogger(__name__)


@DATASET.register_module()
class Waymo(BaseDataset):
    """Waymo: 4 classes; one directory of frames, split by file name."""

    def __init__(self,
                 dataset_path,
                 name="Waymo",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         test_result_folder=test_result_folder,
                         **kwargs)
        cfg = self.cfg
        self.num_classes = 4
        self.label_to_names = self.get_label_to_names()
        self.shuffle = kwargs.get("shuffle", False)

        self.all_files = sorted(
            glob(join(cfg.dataset_path, "velodyne", "*.bin")))
        self.train_files, self.val_files, self.test_files = [], [], []
        for f in self.all_files:
            base = Path(f).name
            if "train" in base:
                self.train_files.append(f)
            elif "val" in base:
                self.val_files.append(f)
            elif "test" in base:
                self.test_files.append(f)
            else:
                log.warning(f"Skipping {f}: prefix must be train/val/test.")
        if self.shuffle:
            self.rng.shuffle(self.train_files)

    @staticmethod
    def get_label_to_names():
        return {0: "PEDESTRIAN", 1: "VEHICLE", 2: "CYCLIST", 3: "SIGN"}

    @staticmethod
    def read_lidar(path):
        """[N, 6]: x, y, z, intensity, elongation, timestamp."""
        return np.fromfile(path, dtype=np.float32).reshape(-1, 6)

    @staticmethod
    def read_calib(path):
        return KITTI.read_calib(path)

    @staticmethod
    def read_label(path, calib):
        """The label file's boxes as ``Object3d`` (world frame), or None
        where the frame has no label file."""
        if not Path(path).exists():
            return None
        with open(path, "r") as f:
            lines = f.readlines()
        objects = []
        for line in lines:
            label = line.strip().split(" ")
            center = np.array(
                [float(label[11]), float(label[12]), float(label[13]), 1.0])
            points = center @ np.linalg.inv(calib["world_cam"])
            size = [float(label[9]), float(label[8]), float(label[10])]
            center = [points[0], points[1], size[1] / 2 + points[2]]
            objects.append(Object3d(center, size, label, calib))
        return objects

    def get_split(self, split):
        return WaymoSplit(self, split=split)

    def get_split_list(self, split):
        if split in ("train", "training"):
            return self.train_files
        if split in ("test", "testing"):
            return self.test_files
        if split in ("val", "validation"):
            return self.val_files
        if split == "all":
            return self.train_files + self.val_files + self.test_files
        raise ValueError(f"Invalid split {split}")

    def is_tested(self, attr):
        return False

    def save_test_result(self, results, attrs):
        """Write KITTI-format .txt result files."""
        make_dir(self.cfg.test_result_folder)
        for attr, res in zip(attrs, results):
            path = join(self.cfg.test_result_folder, attr["name"] + ".txt")
            with open(path, "w") as f:
                for box in res:
                    f.write(box.to_kitti_format(box.confidence))
                    f.write("\n")


class WaymoSplit(KITTISplit):
    """A KITTI split that reads ``label_all/`` and keeps every point."""

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        label_path = ("label_all".join(
            pc_path.rsplit("velodyne", 1))).replace(".bin", ".txt")
        calib_path = "calib".join(label_path.rsplit("label_all", 1))
        pc = self.dataset.read_lidar(pc_path)
        calib = self.dataset.read_calib(calib_path)
        label = self.dataset.read_label(label_path, calib)
        return {
            "point": pc,
            "feat": None,
            "calib": calib,
            "bounding_boxes": label,
        }
