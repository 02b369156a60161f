"""Argoverse 3D tracking dataset reader (info pickles).

Counterpart of ``open3d_ml_tpu/datasets/argoverse.py``, the same code:
info pickles that list each log's lidar ``.ply`` sweeps and box dicts,
the sweeps read by the port's PLY reader as [N, 3] float32 (x, y, z;
the sweeps carry no intensity), and KITTI-format result files. Its
splits draw no patches, so they have no sampler.
"""

import logging
import os
import pickle
from os.path import join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset
from .utils import BEVBox3D
from .utils.ply import read_ply

log = logging.getLogger(__name__)


class Object3d(BEVBox3D):
    """An Argoverse box with its source dict (``info``)."""

    def __init__(self, center, size, yaw, name, box):
        super().__init__(center, size, yaw, name, -1.0)
        self.info = box


@DATASET.register_module()
class Argoverse(BaseDataset):
    """Argoverse: 15 classes; the splits are the info pickles under
    ``info_path`` (``dataset_path`` when not given)."""

    def __init__(self,
                 dataset_path,
                 info_path=None,
                 name="Argoverse",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 test_result_folder="./test",
                 **kwargs):
        if info_path is None:
            info_path = dataset_path
        super().__init__(dataset_path=dataset_path,
                         info_path=info_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         test_result_folder=test_result_folder,
                         **kwargs)
        self.num_classes = 15
        self.label_to_names = self.get_label_to_names()

        self.train_info = []
        self.val_info = []
        self.test_info = []
        self.sample_info = []
        for split, attr in (("train", "train_info"), ("val", "val_info"),
                            ("test", "test_info"),
                            ("sample", "sample_info")):
            path = join(info_path, f"infos_{split}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    setattr(self, attr, pickle.load(f))

    @staticmethod
    def get_label_to_names():
        return {
            0: "ignore", 1: "VEHICLE", 2: "PEDESTRIAN",
            3: "ON_ROAD_OBSTACLE", 4: "LARGE_VEHICLE", 5: "BICYCLE",
            6: "BICYCLIST", 7: "BUS", 8: "OTHER_MOVER", 9: "TRAILER",
            10: "MOTORCYCLIST", 11: "MOPED", 12: "MOTORCYCLE",
            13: "STROLLER", 14: "EMERGENCY_VEHICLE", 15: "ANIMAL"
        }

    @staticmethod
    def read_lidar(path):
        """[N, 3]: x, y, z."""
        assert Path(path).exists()
        data = read_ply(path)
        return np.stack([data["x"], data["y"], data["z"]],
                        axis=1).astype(np.float32)

    @staticmethod
    def read_label(bboxes):
        """The box dicts as ``Object3d``, the yaw from the box's first two
        BEV corners."""
        objects = []
        for box in bboxes:
            name = box["label_class"]
            center = box["center"]
            size = [box["w"], box["h"], box["l"]]
            box2d = box["2d_coord"]
            yaw = np.pi / 2 + np.arctan(
                (box2d[0][0] - box2d[1][0]) / (box2d[0][1] - box2d[1][1]))
            objects.append(Object3d(center, size, yaw, name, box))
        return objects

    def get_split(self, split):
        return ArgoverseSplit(self, split=split)

    def get_split_list(self, split):
        if split in ("train", "training"):
            return self.train_info
        if split in ("test", "testing"):
            return self.test_info
        if split in ("val", "validation"):
            return self.val_info
        if split == "sample":
            return self.sample_info
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


class ArgoverseSplit:
    """One split: the sweeps of every log its infos list, in order."""

    def __init__(self, dataset, split="train"):
        self.cfg = dataset.cfg
        infos = dataset.get_split_list(split)
        self.num_pc = 0
        self.path_list = []
        self.bboxes = []
        for info in infos:
            self.num_pc += info["num_pc"]
            self.path_list += info["lidar_path"]
            self.bboxes += info["bbox"]
        self.split = split
        self.dataset = dataset
        log.info(f"Found {self.num_pc} pointclouds for {split}")

    def __len__(self):
        return self.num_pc

    def get_data(self, idx):
        pc = self.dataset.read_lidar(self.path_list[idx])
        label = self.dataset.read_label(self.bboxes[idx])
        return {"point": pc, "feat": None, "calib": None,
                "bounding_boxes": label}

    def get_attr(self, idx):
        pc_path = self.path_list[idx]
        name = Path(pc_path).name.split(".")[0]
        return {"name": name, "path": str(pc_path), "split": self.split}
