"""Custom3D: a reader for user point clouds stored as .npy files.

Counterpart of ``open3d_ml_tpu/datasets/customdataset.py``: each cloud is a
.npy file holding a dict {'point', 'feat', 'label'} (or an [N, 3 + d]
array of points and features); the splits are the subdirectories train,
val and test of ``dataset_path``.
"""

import glob
import logging
from os.path import basename, exists, join

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset, BaseDatasetSplit

log = logging.getLogger(__name__)


class Custom3DSplit(BaseDatasetSplit):
    """One split of ``Custom3D``: its files, in sorted order."""

    def __init__(self, dataset, split="training"):
        super().__init__(dataset, split=split)
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        data = np.load(pc_path, allow_pickle=True)
        if isinstance(data, np.ndarray) and data.dtype == object:
            data = data.item()
        if isinstance(data, dict):
            points = np.asarray(data["point"], np.float32)
            feat = data.get("feat")
            feat = None if feat is None else np.asarray(feat, np.float32)
            label = data.get("label")
            label = (np.zeros(points.shape[0], np.int32)
                     if label is None else np.asarray(label, np.int32))
        else:
            arr = np.asarray(data, np.float32)
            points, feat = arr[:, :3], arr[:, 3:] if arr.shape[1] > 3 else None
            label = np.zeros(points.shape[0], np.int32)
        return {"point": points, "feat": feat, "label": label}

    def get_attr(self, idx):
        pc_path = str(self.path_list[idx])
        name = basename(pc_path)[:-4]
        return {"idx": idx, "name": name, "path": pc_path,
                "split": self.split}


@DATASET.register_module()
class Custom3D(BaseDataset):
    """Point clouds as .npy files under ``dataset_path``/{train,val,test};
    the predictions of a test run go to ``test_result_folder``."""

    def __init__(self,
                 dataset_path,
                 name="Custom3D",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 num_points=65536,
                 ignored_label_inds=(),
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         num_points=num_points,
                         ignored_label_inds=list(ignored_label_inds),
                         test_result_folder=test_result_folder,
                         **kwargs)
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.label_to_names)

    @staticmethod
    def get_label_to_names():
        return {
            0: "Unclassified", 1: "Ground", 2: "Road_markings",
            3: "Natural", 4: "Building", 5: "Utility_line", 6: "Pole",
            7: "Car", 8: "Fence"
        }

    def get_split(self, split):
        return Custom3DSplit(self, split=split)

    def get_split_list(self, split):
        path = self.cfg.dataset_path
        if split in ("train", "training"):
            folder = "train"
        elif split in ("val", "validation"):
            folder = "val"
        elif split in ("test", "testing"):
            folder = "test"
        elif split == "all":
            return sorted(glob.glob(join(path, "**", "*.npy"),
                                    recursive=True))
        else:
            raise ValueError(f"Invalid split {split}")
        return sorted(glob.glob(join(path, folder, "*.npy")))

    def is_tested(self, attr):
        return exists(join(self.cfg.test_result_folder,
                           attr["name"] + ".npy"))

    def save_test_result(self, results, attr):
        make_dir(self.cfg.test_result_folder)
        pred = np.asarray(results["predict_labels"])
        np.save(join(self.cfg.test_result_folder, attr["name"] + ".npy"),
                pred)
