"""SemanticKITTI: velodyne scans of 22 drive sequences with per-point
semantic labels.

Counterpart of ``open3d_ml_tpu/datasets/semantickitti.py``. A scan is
``<dataset_path>/dataset/sequences/<seq>/velodyne/<frame>.bin`` (float32
x, y, z, remission), its labels ``../labels/<frame>.label`` (uint32: the
raw class in the lower 16 bits, the instance in the upper 16), mapped to
19 training classes and 0 (unlabeled, ignored) through ``LEARNING_MAP``.
A scan without labels reads as class 0 in the test and all splits, and
raises in the others. ``save_test_result`` writes SemanticKITTI's
submission format: ``<test_result_folder>/sequences/<seq>/predictions/
<frame>.label``, one raw uint32 class id a point.
"""

import logging
import os
from os.path import exists, join
from os.path import split as path_split

import numpy as np

from ..utils import DATASET, make_dir
from ._resources.semantickitti import LABELS, LEARNING_MAP, LEARNING_MAP_INV
from .base_dataset import BaseDataset, BaseDatasetSplit
from .utils import DataProcessing

log = logging.getLogger(__name__)


@DATASET.register_module()
class SemanticKITTI(BaseDataset):
    """SemanticKITTI's sequences; the splits are lists of sequence ids."""

    def __init__(self,
                 dataset_path,
                 name="SemanticKITTI",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 class_weights=(
                     55437630, 320797, 541736, 2578735, 3274484, 552662,
                     184064, 78858, 240942562, 17294618, 170599734, 6369672,
                     230413074, 101130274, 476491114, 9833174, 129609852,
                     4506626, 1168181),
                 ignored_label_inds=(0,),
                 test_result_folder="./test",
                 test_split=("11", "12", "13", "14", "15", "16", "17", "18",
                             "19", "20", "21"),
                 training_split=("00", "01", "02", "03", "04", "05", "06",
                                 "07", "09", "10"),
                 validation_split=("08",),
                 all_split=("00", "01", "02", "03", "04", "05", "06", "07",
                            "09", "08", "10", "11", "12", "13", "14", "15",
                            "16", "17", "18", "19", "20", "21"),
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         class_weights=list(class_weights),
                         ignored_label_inds=list(ignored_label_inds),
                         test_result_folder=test_result_folder,
                         test_split=list(test_split),
                         training_split=list(training_split),
                         validation_split=list(validation_split),
                         all_split=list(all_split),
                         **kwargs)
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.label_to_names)

        # raw -> training class, applied when labels are read
        remap_lut_val = np.zeros((max(LEARNING_MAP) + 100,), dtype=np.int32)
        remap_lut_val[list(LEARNING_MAP.keys())] = list(LEARNING_MAP.values())
        self.remap_lut_val = remap_lut_val
        # training class -> raw, applied when predictions are written
        remap_lut = np.zeros((max(LEARNING_MAP_INV) + 100,), dtype=np.int32)
        remap_lut[list(LEARNING_MAP_INV.keys())] = list(
            LEARNING_MAP_INV.values())
        self.remap_lut = remap_lut

    @staticmethod
    def get_label_to_names():
        return dict(LABELS)

    def get_split(self, split):
        return SemanticKITTISplit(self, split=split)

    def get_split_list(self, split):
        """The scans of the split's sequences, each sequence's in sorted
        order."""
        cfg = self.cfg
        if split in ("train", "training"):
            seq_list = cfg.training_split
        elif split in ("test", "testing"):
            seq_list = cfg.test_split
        elif split in ("val", "validation"):
            seq_list = cfg.validation_split
        elif split == "all":
            seq_list = cfg.all_split
        else:
            raise ValueError(f"Invalid split {split}")

        file_list = []
        for seq_id in seq_list:
            pc_path = join(cfg.dataset_path, "dataset", "sequences", seq_id,
                           "velodyne")
            file_list.append(
                [join(pc_path, f) for f in np.sort(os.listdir(pc_path))])
        return np.concatenate(file_list, axis=0)

    def _result_path(self, attr):
        name_seq, name_points = attr["name"].split("_")
        return join(self.cfg.test_result_folder, "sequences", name_seq,
                    "predictions", name_points + ".label")

    def is_tested(self, attr):
        store_path = self._result_path(attr)
        if exists(store_path):
            log.info(f"{store_path} already exists.")
            return True
        return False

    def save_test_result(self, results, attr):
        """Write the predicted training classes as raw uint32 ids: each
        class at or past an ignored label shifts up by one, then goes
        through ``remap_lut``."""
        save_path = self._result_path(attr)
        make_dir(os.path.dirname(save_path))
        pred = np.asarray(results["predict_labels"]).copy()
        for ign in self.cfg.ignored_label_inds:
            pred[pred >= ign] += 1
        pred = self.remap_lut[pred].astype(np.uint32)
        pred.tofile(save_path)


class SemanticKITTISplit(BaseDatasetSplit):
    """One split of ``SemanticKITTI``."""

    def __init__(self, dataset, split="training"):
        super().__init__(dataset, split=split)
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")
        self.remap_lut_val = dataset.remap_lut_val

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        points = DataProcessing.load_pc_kitti(pc_path)

        folder, file = path_split(pc_path)
        label_path = join(folder, "..", "labels", file[:-4] + ".label")
        if not exists(label_path):
            if self.split not in ("test", "all"):
                raise FileNotFoundError(f"Label file {label_path} not found")
            labels = np.zeros(points.shape[0], dtype=np.int32)
        else:
            labels = DataProcessing.load_label_kitti(label_path,
                                                     self.remap_lut_val)
        return {"point": points[:, 0:3], "feat": points[:, 3:],
                "label": labels}

    def get_attr(self, idx):
        """{'idx', 'name': '<seq>_<frame>', 'path', 'split'}."""
        pc_path = str(self.path_list[idx])
        folder, file = path_split(pc_path)
        _, seq = path_split(path_split(folder)[0])
        return {"idx": idx, "name": f"{seq}_{file[:-4]}", "path": pc_path,
                "split": self.split}
