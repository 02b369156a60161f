"""SUN RGB-D: indoor depth frames with 3D boxes of 10 classes.

Counterpart of ``open3d_ml_tpu/datasets/sunrgbd.py``. Frames are
preprocessed into ``depth/<idx>.npy`` (x, y, z, then r, g, b) and
``label/<idx>.pkl`` (a list of boxes: name, center, half sizes, the
heading vector, and optionally the 2D box); ``train_data_idx.txt`` and
``val_data_idx.txt`` in the root list each split's frames. The
validation list is also the test split. A frame's ``feat`` is its colour
as b, g, r; its boxes are ``SunRGBDObject``s (a ``BEVBox3D`` with its 2D
box).
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

log = logging.getLogger(__name__)


class SunRGBDObject(BEVBox3D):

    def __init__(self, name, center, size, yaw, box2d):
        super().__init__(center, size, yaw, name, -1.0)
        self.box2d = box2d


@DATASET.register_module()
class SunRGBD(BaseDataset):

    def __init__(self,
                 dataset_path,
                 name="SunRGBD",
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
        self.dataset_path = self.cfg.dataset_path
        self.classes = [
            "bed", "table", "sofa", "chair", "toilet", "desk", "dresser",
            "night_stand", "bookshelf", "bathtub"
        ]
        self.cat2label = {c: i for i, c in enumerate(self.classes)}
        self.label2cat = {v: k for k, v in self.cat2label.items()}
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.classes)

        available = [
            f.split(".")[0] for f in os.listdir(join(dataset_path, "depth"))
            if f.endswith(".npy")
        ]
        with open(join(dataset_path, "train_data_idx.txt")) as f:
            train_files = set(f.read().split("\n"))
        with open(join(dataset_path, "val_data_idx.txt")) as f:
            val_files = set(f.read().split("\n"))
        self.train_idx = [i for i in available if i in train_files]
        self.val_idx = [i for i in available if i in val_files]

    def get_label_to_names(self):
        return self.label2cat

    @staticmethod
    def read_lidar(path):
        assert Path(path).exists()
        return np.load(path)

    def read_label(self, path):
        assert Path(path).exists()
        with open(path, "rb") as f:
            bboxes = pickle.load(f)
        objects = []
        for box in bboxes:
            name = box[0]
            center = box[1:4]
            size = [box[4] * 2, box[6] * 2, box[5] * 2]  # w, h, l
            orientation = [box[7], box[8]]
            yaw = -1 * np.arctan(orientation[1] / orientation[0])
            if len(box) > 9:
                box2d = [box[9], box[10], box[9] + box[11],
                         box[10] + box[12]]
            else:
                box2d = []
            objects.append(SunRGBDObject(name, center, size, yaw, box2d))
        return objects

    def get_split(self, split):
        return SunRGBDSplit(self, split=split)

    def get_split_list(self, split):
        if split in ("train", "training"):
            return self.train_idx
        if split in ("test", "testing", "val", "validation"):
            return self.val_idx
        raise ValueError(f"Invalid split {split}")

    def is_tested(self, attr):
        return False

    def save_test_result(self, results, attrs):
        make_dir(self.cfg.test_result_folder)
        for attr, res in zip(attrs, results):
            np.save(join(self.cfg.test_result_folder, attr["name"] + ".npy"),
                    np.asarray([b.to_xyzwhlr() for b in res]))


class SunRGBDSplit:
    """A split of whole frames: no patch sampler draws from it."""

    def __init__(self, dataset, split="train"):
        self.cfg = dataset.cfg
        self.path_list = dataset.get_split_list(split)
        self.split = split
        self.dataset = dataset
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        fid = self.path_list[idx]
        pc = self.dataset.read_lidar(
            join(self.cfg.dataset_path, f"depth/{fid}.npy"))
        feat = pc[:, 3:]
        pc = pc[:, :3]
        bboxes = self.dataset.read_label(
            join(self.cfg.dataset_path, f"label/{fid}.pkl"))
        return {"point": pc, "feat": feat[:, [2, 1, 0]], "calib": None,
                "bounding_boxes": bboxes}

    def get_attr(self, idx):
        fid = self.path_list[idx]
        return {"name": str(fid), "path": str(fid), "split": self.split}
