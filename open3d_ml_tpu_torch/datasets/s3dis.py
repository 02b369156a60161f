"""S3DIS (Stanford Large-Scale 3D Indoor Spaces): rooms of six areas, 13
classes.

Counterpart of ``open3d_ml_tpu/datasets/s3dis.py``. A room is a pickle
``<dataset_path>/original_pkl/<Area_i_room>.pkl`` of (an [N, 7] array of
x, y, z, r, g, b, label, its boxes); the area ``test_area_idx`` is the
test and validation split, the others train. The JAX package's
``scripts/preprocess_s3dis.py`` writes the pickles from the raw
Annotations files.
"""

import glob
import logging
import pickle
from os.path import exists, join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset, BaseDatasetSplit

log = logging.getLogger(__name__)


@DATASET.register_module()
class S3DIS(BaseDataset):

    def __init__(self,
                 dataset_path,
                 name="S3DIS",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 class_weights=[
                     3370714, 2856755, 4919229, 318158, 375640, 478001,
                     974733, 650464, 791496, 88727, 1284130, 229758, 2272837
                 ],
                 num_points=40960,
                 test_area_idx=3,
                 ignored_label_inds=[],
                 ignored_objects=["wall", "floor", "ceiling"],
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         class_weights=class_weights,
                         num_points=num_points,
                         test_area_idx=test_area_idx,
                         ignored_label_inds=ignored_label_inds,
                         ignored_objects=ignored_objects,
                         test_result_folder=test_result_folder,
                         **kwargs)
        cfg = self.cfg
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.label_to_names)
        self.pc_path = join(cfg.dataset_path, "original_pkl")
        self.all_files = sorted(glob.glob(join(self.pc_path, "*.pkl")))

    @staticmethod
    def get_label_to_names():
        return {
            0: "ceiling", 1: "floor", 2: "wall", 3: "beam", 4: "column",
            5: "window", 6: "door", 7: "table", 8: "chair", 9: "sofa",
            10: "bookcase", 11: "board", 12: "clutter"
        }

    def get_split(self, split):
        return S3DISSplit(self, split=split)

    def get_split_list(self, split):
        cfg = self.cfg
        area = f"Area_{cfg.test_area_idx}"
        if split in ("train", "training"):
            return [f for f in self.all_files if area not in f]
        if split in ("test", "testing", "val", "validation"):
            return [f for f in self.all_files if area in f]
        if split == "all":
            return list(self.all_files)
        raise ValueError(f"Invalid split {split}")

    def read_bboxes(self, bboxes, ignored_objects):
        """Filter pickled gt boxes by ignored object classes."""
        return [bb for bb in (bboxes or [])
                if getattr(bb, "label_class", None) not in ignored_objects]

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


class S3DISSplit(BaseDatasetSplit):

    def __init__(self, dataset, split="training"):
        super().__init__(dataset, split=split)
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        with open(pc_path, "rb") as f:
            data = pickle.load(f)
        pc, bboxes = data
        pc = pc[~np.isnan(pc).any(1)]
        bboxes = self.dataset.read_bboxes(bboxes,
                                          self.cfg.ignored_objects)
        return {
            "point": np.array(pc[:, :3], np.float32),
            "feat": np.array(pc[:, 3:6], np.float32),
            "label": np.array(pc[:, 6], np.int32).reshape(-1),
            "bounding_boxes": bboxes,
        }

    def get_attr(self, idx):
        pc_path = Path(self.path_list[idx])
        return {"idx": idx, "name": pc_path.name.replace(".pkl", ""),
                "path": str(pc_path), "split": self.split}
