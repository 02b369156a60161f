"""Toronto-3D: mobile lidar of a Toronto street, 8 classes and
unclassified.

Counterpart of ``open3d_ml_tpu/datasets/toronto3d.py``. The four tiles
``L00{1-4}.ply`` hold x, y, z in UTM coordinates (``UTM_OFFSET`` is
subtracted in float64 before the cast to float32), red, green, blue and
``scalar_Label``; the splits are lists of file names.
"""

import logging
from os.path import exists, join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset, BaseDatasetSplit
from .utils import read_ply

log = logging.getLogger(__name__)


@DATASET.register_module()
class Toronto3D(BaseDataset):

    UTM_OFFSET = [627285, 4841948, 0]

    def __init__(self,
                 dataset_path,
                 name="Toronto3D",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 num_points=65536,
                 class_weights=[
                     35391894., 1449308., 4650919., 18252779., 589856.,
                     743579., 4311631., 356463.
                 ],
                 ignored_label_inds=[0],
                 train_files=["L001.ply", "L003.ply", "L004.ply"],
                 val_files=["L002.ply"],
                 test_files=["L002.ply"],
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         num_points=num_points,
                         class_weights=class_weights,
                         ignored_label_inds=ignored_label_inds,
                         train_files=train_files,
                         val_files=val_files,
                         test_files=test_files,
                         test_result_folder=test_result_folder,
                         **kwargs)
        cfg = self.cfg
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.label_to_names)
        self.train_files = [join(cfg.dataset_path, f)
                            for f in cfg.train_files]
        self.val_files = [join(cfg.dataset_path, f) for f in cfg.val_files]
        self.test_files = [join(cfg.dataset_path, f) for f in cfg.test_files]

    @staticmethod
    def get_label_to_names():
        return {
            0: "Unclassified", 1: "Ground", 2: "Road_markings", 3: "Natural",
            4: "Building", 5: "Utility_line", 6: "Pole", 7: "Car", 8: "Fence"
        }

    def get_split(self, split):
        return Toronto3DSplit(self, split=split)

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


class Toronto3DSplit(BaseDatasetSplit):

    def __init__(self, dataset, split="training"):
        super().__init__(dataset, split=split)
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        data = read_ply(pc_path)
        points = np.stack([data["x"], data["y"], data["z"]],
                          axis=1).astype(np.float64)
        points = (points - self.dataset.UTM_OFFSET).astype(np.float32)
        feat = np.stack(
            [data.get("red"), data.get("green"), data.get("blue")],
            axis=1).astype(np.float32)
        label_key = "scalar_Label" if "scalar_Label" in data else "label"
        labels = data.get(label_key,
                          np.zeros(len(points))).astype(np.int32).reshape(-1)
        return {"point": points, "feat": feat, "label": labels}

    def get_attr(self, idx):
        pc_path = Path(self.path_list[idx])
        name = pc_path.name.replace(".ply", "")
        return {"idx": idx, "name": name, "path": str(pc_path),
                "split": self.split}
