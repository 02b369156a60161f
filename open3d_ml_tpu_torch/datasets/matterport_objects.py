"""Matterport3D objects: point clouds of rooms with boxes of chairs.

Counterpart of ``open3d_ml_tpu/datasets/matterport_objects.py``. The
clouds are ``{training,testing}/pc/<name>.bin`` and the boxes
``boxes/<name>.txt``, both written by ``joblib.dump``; a box is (name, the
2D box's left, top, right, bottom, cx, cy, cz, l, w, h, yaw in degrees).
The training files are shuffled by the dataset's generator (``seed``) and
the last ``val_split`` of them are the validation split. ``joblib`` is
imported only to read a file, so the package imports without it.
``save_test_result`` writes KITTI lines, which need a camera matrix that
these boxes lack: a result with a box fails, in JAX too (ROADMAP.md queue
3, ``NO_CAMERA_FAULT``).
"""

import logging
from glob import glob
from os.path import join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset
from .utils import BEVBox3D

log = logging.getLogger(__name__)


@DATASET.register_module()
class MatterportObjects(BaseDataset):

    def __init__(self,
                 dataset_path,
                 name="MatterportObjects",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 val_split=5000,
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         val_split=val_split,
                         test_result_folder=test_result_folder,
                         **kwargs)
        cfg = self.cfg
        self.num_classes = 1
        self.label_to_names = self.get_label_to_names()

        self.all_files = sorted(
            glob(join(cfg.dataset_path, "training", "pc", "*.bin")))
        self.rng.shuffle(self.all_files)
        if cfg.val_split < len(self.all_files):
            self.train_files = self.all_files[:-cfg.val_split]
            self.val_files = self.all_files[-cfg.val_split:]
        else:
            self.train_files = self.all_files
            self.val_files = []
        self.test_files = sorted(
            glob(join(cfg.dataset_path, "testing", "pc", "*.bin")))

    @staticmethod
    def get_label_to_names():
        return {0: "chair"}

    @staticmethod
    def read_lidar(path):
        import joblib
        assert Path(path).exists()
        return joblib.load(path)

    @staticmethod
    def read_label(path):
        import joblib
        assert Path(path).exists()
        boxes = joblib.load(path)
        objects = []
        for b in boxes:
            (name, img_left, img_top, img_right, img_bottom, cx, cy, cz, l,
             w, h, yaw) = b
            yaw = -np.deg2rad(np.float32(yaw))
            size = np.array([l, h, w], np.float32)
            center = np.array([cx, cy, cz], np.float32)
            objects.append(BEVBox3D(center, size, yaw, name, 1))
        return objects

    def get_split(self, split):
        return MatterportObjectsSplit(self, split=split)

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
        make_dir(self.cfg.test_result_folder)
        for attr, res in zip(attrs, results):
            path = join(self.cfg.test_result_folder, attr["name"] + ".txt")
            with open(path, "w") as f:
                for box in res:
                    f.write(box.to_kitti_format(box.confidence))
                    f.write("\n")


class MatterportObjectsSplit:
    """A split of whole clouds: no patch sampler draws from it."""

    def __init__(self, dataset, split="train"):
        self.cfg = dataset.cfg
        self.path_list = dataset.get_split_list(split)
        self.split = split
        self.dataset = dataset
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        label_path = ("boxes".join(pc_path.rsplit("pc", 1))).replace(
            ".bin", ".txt")
        pc = self.dataset.read_lidar(pc_path)
        label = self.dataset.read_label(label_path)
        return {"point": pc, "feat": None, "calib": {},
                "bounding_boxes": label}

    def get_attr(self, idx):
        pc_path = self.path_list[idx]
        name = Path(pc_path).name.split(".")[0]
        return {"name": name, "path": str(pc_path), "split": self.split}
