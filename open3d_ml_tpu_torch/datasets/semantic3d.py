"""Semantic3D: terrestrial laser scans, 8 classes and unlabeled.

Counterpart of ``open3d_ml_tpu/datasets/semantic3d.py``. A scan is a
whitespace ``.txt`` file of x y z intensity r g b rows with its labels in
a ``.labels`` file beside it; scans without labels are the test split, and
the scans named in ``val_files`` the validation split.
"""

import glob
import logging
from os.path import exists, join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset, BaseDatasetSplit

log = logging.getLogger(__name__)


@DATASET.register_module()
class Semantic3D(BaseDataset):

    def __init__(self,
                 dataset_path,
                 name="Semantic3D",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 num_points=65536,
                 class_weights=[
                     5181602, 5012952, 6830086, 1311528, 10476365, 946982,
                     334860, 269353
                 ],
                 ignored_label_inds=[0],
                 val_files=["bildstein_station3_xyz_intensity_rgb"],
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         num_points=num_points,
                         class_weights=class_weights,
                         ignored_label_inds=ignored_label_inds,
                         val_files=val_files,
                         test_result_folder=test_result_folder,
                         **kwargs)
        cfg = self.cfg
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.label_to_names)

        all_files = glob.glob(join(cfg.dataset_path, "*.txt"))
        self.train_files = sorted([
            f for f in all_files
            if exists(str(Path(f).parent / Path(f).name.replace(
                ".txt", ".labels")))
        ])
        self.test_files = sorted(
            [f for f in all_files if f not in self.train_files])
        self.val_files = [
            f for f in self.train_files
            if Path(f).name.replace(".txt", "") in cfg.val_files
        ]
        self.train_files = [
            f for f in self.train_files if f not in self.val_files
        ]

    @staticmethod
    def get_label_to_names():
        return {
            0: "unlabeled", 1: "man-made terrain", 2: "natural terrain",
            3: "high vegetation", 4: "low vegetation", 5: "buildings",
            6: "hard scape", 7: "scanning artefacts", 8: "cars"
        }

    def get_split(self, split):
        return Semantic3DSplit(self, split=split)

    def get_split_list(self, split):
        if split in ("train", "training"):
            return self.train_files
        if split in ("val", "validation"):
            return self.val_files
        if split in ("test", "testing"):
            return self.test_files
        if split == "all":
            return self.train_files + self.val_files + self.test_files
        raise ValueError(f"Invalid split {split}")

    def is_tested(self, attr):
        path = join(self.cfg.test_result_folder, self.name)
        return exists(join(path, attr["name"] + ".labels"))

    def save_test_result(self, results, attr):
        path = join(self.cfg.test_result_folder, self.name)
        make_dir(path)
        pred = np.asarray(results["predict_labels"]).copy()
        for ign in self.cfg.ignored_label_inds:
            pred[pred >= ign] += 1
        np.savetxt(join(path, attr["name"] + ".labels"), pred, fmt="%d")


class Semantic3DSplit(BaseDatasetSplit):

    def __init__(self, dataset, split="training"):
        super().__init__(dataset, split=split)
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        pc = np.loadtxt(pc_path, dtype=np.float32)
        points = pc[:, 0:3]
        feat = pc[:, [4, 5, 6]]
        if self.split not in ("test", "testing"):
            labels = np.loadtxt(str(pc_path).replace(".txt", ".labels"),
                                dtype=np.int32).reshape(-1)
        else:
            labels = np.zeros((points.shape[0],), np.int32)
        return {"point": np.ascontiguousarray(points),
                "feat": np.ascontiguousarray(feat),
                "label": labels}

    def get_attr(self, idx):
        pc_path = Path(self.path_list[idx])
        return {"idx": idx, "name": pc_path.name.replace(".txt", ""),
                "path": str(pc_path), "split": self.split}
