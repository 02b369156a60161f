"""ShapeNet part segmentation and classification.

Counterpart of ``open3d_ml_tpu/datasets/shapenet.py``. The layout is
``shapenetcore_partanno_segmentation_benchmark_v0``: a folder a category
(named in ``synsetoffset2category.txt``) with ``points/<token>.pts`` and
``points_label/<token>.seg``, and the json lists of
``train_test_split/shuffled_{train,test,val}_file_list.json``. A shape in
neither the train nor the test list is a validation shape. Each split's
order is shuffled by the dataset's generator (``seed``). A sample's
label is its part labels (``task: segmentation``) or its category index
[1] (``classification``).
"""

import json
import logging
import os
from os.path import exists, join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset

log = logging.getLogger(__name__)


@DATASET.register_module()
class ShapeNet(BaseDataset):

    def __init__(self,
                 dataset_path,
                 name="ShapeNet",
                 task="classification",
                 class_weights=[],
                 ignored_label_inds=[],
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         task=task,
                         class_weights=class_weights,
                         ignored_label_inds=ignored_label_inds,
                         test_result_folder=test_result_folder,
                         **kwargs)
        assert task in ("classification", "segmentation")
        self.task = task
        self.label_to_names = self.get_label_to_names(task)
        self.num_classes = len(self.label_to_names)
        self.dataset_path = join(
            dataset_path, "shapenetcore_partanno_segmentation_benchmark_v0")

        self.cat = {}
        with open(join(self.dataset_path, "synsetoffset2category.txt")) as f:
            for idx, line in enumerate(f):
                self.cat[idx] = line.strip().split()[1]

        meta = {}
        for item in self.cat:
            meta[item] = []
            dir_point = join(self.dataset_path, self.cat[item], "points")
            dir_seg = join(self.dataset_path, self.cat[item],
                           "points_label")
            for fn in sorted(os.listdir(dir_point)):
                token = os.path.splitext(os.path.basename(fn))[0]
                meta[item].append((join(dir_point, token + ".pts"),
                                   join(dir_seg, token + ".seg")))

        splits = []
        splits_path = join(self.dataset_path, "train_test_split")
        for split in ("shuffled_train_file_list.json",
                      "shuffled_test_file_list.json",
                      "shuffled_val_file_list.json"):
            with open(join(splits_path, split)) as source:
                splits.append(
                    {i.split("/")[-1] for i in json.loads(source.read())})
        train_split, test_split, _ = splits

        self.all_files, self.train_files = [], []
        self.val_files, self.test_files = [], []
        for item in self.cat:
            for fn in meta[item]:
                entry = (item, fn[0], fn[1])
                self.all_files.append(entry)
                file = fn[0].split("/")[-1].split(".")[0]
                if file in train_split:
                    self.train_files.append(entry)
                elif file in test_split:
                    self.test_files.append(entry)
                else:
                    self.val_files.append(entry)
        self.rng.shuffle(self.train_files)
        self.rng.shuffle(self.test_files)
        self.rng.shuffle(self.val_files)

    @staticmethod
    def get_label_to_names(task="classification"):
        if task == "classification":
            return {
                0: "Airplane", 1: "Bag", 2: "Cap", 3: "Car", 4: "Chair",
                5: "Earphone", 6: "Guitar", 7: "Knife", 8: "Lamp",
                9: "Laptop", 10: "Motorbike", 11: "Mug", 12: "Pistol",
                13: "Rocket", 14: "Skateboard", 15: "Table"
            }
        if task == "segmentation":
            return {i: f"Part{i}" for i in range(50)}
        raise ValueError(f"Invalid task {task}")

    def get_split(self, split):
        return ShapeNetSplit(self, split=split, task=self.task)

    def get_split_list(self, split):
        if split in ("test", "testing"):
            return self.test_files
        if split in ("train", "training"):
            return self.train_files
        if split in ("val", "validation"):
            return self.val_files
        if split == "all":
            return self.val_files + self.train_files + self.test_files
        raise ValueError(f"Invalid split {split}")

    def is_tested(self, attr):
        return exists(
            join(self.cfg.test_result_folder, attr["name"] + ".npy"))

    def save_test_result(self, results, attr):
        make_dir(self.cfg.test_result_folder)
        np.save(join(self.cfg.test_result_folder, attr["name"] + ".npy"),
                np.asarray(results["predict_labels"]))


class ShapeNetSplit:
    """A split of whole shapes: no patch sampler draws from it."""

    def __init__(self, dataset, split="training", task="classification"):
        self.cfg = dataset.cfg
        self.path_list = dataset.get_split_list(split)
        self.split = split
        self.dataset = dataset
        self.task = task
        self.sampler = None
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        path = self.path_list[idx]
        points = np.loadtxt(path[1], dtype=np.float32)
        label = (np.loadtxt(path[2], dtype=np.int64)
                 if self.task == "segmentation" else
                 np.array([np.int64(path[0])]))
        return {"point": points, "feat": None, "label": label}

    def get_attr(self, idx):
        name = self.path_list[idx][1].split("/")[-1].split(".")[0]
        return {"name": name, "path": str(Path(self.path_list[idx][1])),
                "split": self.split}
