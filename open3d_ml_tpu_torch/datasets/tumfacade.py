"""TUM-Facade: facade segmentation of the TUM-MLS-2016 scans, 18 classes.

Counterpart of ``open3d_ml_tpu/datasets/tumfacade.py``. The clouds are
PCD files under ``pointclouds/annotated{Global,Local}CRS/{training,
validation,test}_files``, read by the port's ``read_pcd``; a cloud's
labels are its ``classification`` field (0 where it has none), and it has
no features.
"""

import glob
import logging
from os.path import join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset, BaseDatasetSplit
from .utils.pcd import read_pcd

log = logging.getLogger(__name__)


@DATASET.register_module()
class TUMFacade(BaseDataset):

    def __init__(self,
                 dataset_path,
                 info_path=None,
                 name="TUM_Facade",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 use_global=False,
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         info_path=info_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         use_global=use_global,
                         **kwargs)
        cfg = self.cfg
        self.dataset_path = cfg.dataset_path
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.label_to_names)
        self.use_global = cfg.use_global
        crs = ("annotatedGlobalCRS" if self.use_global else
               "annotatedLocalCRS")
        base = Path(cfg.dataset_path) / "pointclouds" / crs
        self.trainFiles = sorted(
            glob.glob(str(base / "training_files" / "*.pcd")))
        self.valFiles = sorted(
            glob.glob(str(base / "validation_files" / "*.pcd")))
        self.testFiles = sorted(
            glob.glob(str(base / "test_files" / "*.pcd")))

    @staticmethod
    def get_label_to_names():
        return {
            0: "not_assigned", 1: "wall", 2: "window", 3: "door",
            4: "balcony", 5: "molding", 6: "deco", 7: "column", 8: "arch",
            9: "drainpipe", 10: "stairs", 11: "ground_surface",
            12: "terrain", 13: "roof", 14: "blinds",
            15: "outer_ceiling_surface", 16: "interior", 17: "other"
        }

    def get_split(self, split):
        return TUMFacadeSplit(self, split=split)

    def get_split_list(self, split):
        if split in ("train", "training"):
            return self.trainFiles
        if split in ("test", "testing"):
            return self.testFiles
        if split in ("val", "validation"):
            return self.valFiles
        if split == "all":
            return self.trainFiles + self.valFiles + self.testFiles
        raise ValueError(f"Invalid split {split}")

    def is_tested(self, attr):
        return False

    def save_test_result(self, results, attr):
        path = join(self.cfg.get("test_result_folder", "./test"), self.name)
        make_dir(path)
        np.save(join(path, attr["name"] + ".npy"),
                np.asarray(results["predict_labels"]))


class TUMFacadeSplit(BaseDatasetSplit):

    def __init__(self, dataset, split="train"):
        super().__init__(dataset, split=split)
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        data = read_pcd(self.path_list[idx])
        points = np.stack([data["x"], data["y"], data["z"]],
                          axis=1).astype(np.float32)
        labels = data.get(
            "classification",
            np.zeros(len(points))).astype(np.int32).reshape(-1)
        return {"point": points, "feat": None, "label": labels}

    def get_attr(self, idx):
        pc_path = str(self.path_list[idx])
        name = pc_path.replace(".pcd", "").split("/")[-1]
        return {"idx": idx, "name": name, "path": pc_path,
                "split": self.split}
