"""Paris-Lille-3D: mobile lidar of two cities, 9 classes and
unclassified.

Counterpart of ``open3d_ml_tpu/datasets/parislille3d.py``. Training
``.ply`` files (x, y, z, class) live in ``training_10_classes/``, test
files in ``test_10_classes/``; the training files named in ``val_files``
are the validation split.
"""

import glob
import logging
from os.path import exists, join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset, BaseDatasetSplit
from .utils import read_ply

log = logging.getLogger(__name__)


@DATASET.register_module()
class ParisLille3D(BaseDataset):

    def __init__(self,
                 dataset_path,
                 name="ParisLille3D",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 num_points=65536,
                 class_weights=[
                     5181602, 5012952, 6830086, 1311528, 10476365, 946982,
                     334860, 269353, 37299
                 ],
                 ignored_label_inds=[0],
                 val_files=["Lille2.ply"],
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

        all_train = glob.glob(
            join(cfg.dataset_path, "training_10_classes", "*.ply"))
        self.val_files = [
            f for f in all_train if Path(f).name in cfg.val_files
        ]
        self.train_files = [f for f in all_train if f not in self.val_files]
        self.test_files = glob.glob(
            join(cfg.dataset_path, "test_10_classes", "*.ply"))

    @staticmethod
    def get_label_to_names():
        return {
            0: "unclassified", 1: "ground", 2: "building",
            3: "pole-road_sign-traffic_light", 4: "bollard-small_pole",
            5: "trash_can", 6: "barrier", 7: "pedestrian", 8: "car",
            9: "natural-vegetation"
        }

    def get_split(self, split):
        return ParisLille3DSplit(self, split=split)

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
        return exists(join(path, attr["name"] + ".npy"))

    def save_test_result(self, results, attr):
        path = join(self.cfg.test_result_folder, self.name)
        make_dir(path)
        pred = np.asarray(results["predict_labels"]).copy()
        for ign in self.cfg.ignored_label_inds:
            pred[pred >= ign] += 1
        np.save(join(path, attr["name"] + ".npy"), pred)


class ParisLille3DSplit(BaseDatasetSplit):

    def __init__(self, dataset, split="training"):
        super().__init__(dataset, split=split)
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        data = read_ply(pc_path)
        points = np.stack([data["x"], data["y"], data["z"]],
                          axis=1).astype(np.float32)
        if self.split not in ("test", "testing") and "class" in data:
            labels = data["class"].astype(np.int32).reshape(-1)
        else:
            labels = np.zeros((points.shape[0],), np.int32)
        return {"point": points, "feat": None, "label": labels}

    def get_attr(self, idx):
        pc_path = Path(self.path_list[idx])
        return {"idx": idx, "name": pc_path.name.replace(".ply", ""),
                "path": str(pc_path), "split": self.split}
