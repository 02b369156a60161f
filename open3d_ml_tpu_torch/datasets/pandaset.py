"""PandaSet: lidar sweeps of city streets, 39 classes, from pandas pickles.

Counterpart of ``open3d_ml_tpu/datasets/pandaset.py``. Each sequence
folder holds ``lidar/<frame>.pkl[.gz]`` (a DataFrame of x, y, z, i, t, d)
and ``annotations/semseg/<frame>.pkl[.gz]`` (one ``class`` column, 1-39);
the splits are lists of sequence names. A frame's ``feat`` is its
intensity column [N, 1]. ``save_test_result`` writes
``<test_result_folder>/<seq>_<frame>.npy``, with no folder of the
dataset's name, and leaves the labels as predicted. ``pandas`` is
imported only to read a frame.
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
class Pandaset(BaseDataset):

    def __init__(self,
                 dataset_path,
                 name="Pandaset",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 ignored_label_inds=[],
                 test_result_folder="./logs/test_log",
                 test_split=["115", "116", "117", "119", "120", "124",
                             "139", "149", "158"],
                 training_split=[
                     "001", "002", "003", "005", "011", "013", "015", "016",
                     "017", "019", "021", "023", "024", "027", "028", "029",
                     "030", "032", "033", "034", "035", "037", "038", "039",
                     "040", "041", "042", "043", "044", "046", "052", "053",
                     "054", "056", "057", "058", "064", "065", "066", "067",
                     "070", "071", "072", "073", "077", "078", "080", "084",
                     "088", "089", "090", "094", "095", "097", "098", "101",
                     "102", "103", "105", "106", "109", "110", "112", "113"
                 ],
                 validation_split=["122", "123"],
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         ignored_label_inds=ignored_label_inds,
                         test_result_folder=test_result_folder,
                         test_split=test_split,
                         training_split=training_split,
                         validation_split=validation_split,
                         **kwargs)
        self.label_to_names = self.get_label_to_names()
        self.num_classes = len(self.label_to_names)

    @staticmethod
    def get_label_to_names():
        return {
            1: "Reflection", 2: "Vegetation", 3: "Ground", 4: "Road",
            5: "Lane Line Marking", 6: "Stop Line Marking",
            7: "Other Road Marking", 8: "Sidewalk", 9: "Driveway",
            10: "Car", 11: "Pickup Truck", 12: "Medium-sized Truck",
            13: "Semi-truck", 14: "Towed Object", 15: "Motorcycle",
            16: "Other Vehicle - Construction Vehicle",
            17: "Other Vehicle - Uncommon",
            18: "Other Vehicle - Pedicab", 19: "Emergency Vehicle",
            20: "Bus", 21: "Personal Mobility Device",
            22: "Motorized Scooter", 23: "Bicycle", 24: "Train",
            25: "Trolley", 26: "Tram / Subway", 27: "Pedestrian",
            28: "Pedestrian with Object", 29: "Animals - Bird",
            30: "Animals - Other", 31: "Pylons", 32: "Road Barriers",
            33: "Signs", 34: "Cones", 35: "Construction Signs",
            36: "Temporary Construction Barriers", 37: "Rolling Containers",
            38: "Building", 39: "Other Static Object"
        }

    def get_split(self, split):
        return PandasetSplit(self, split=split)

    def get_split_list(self, split):
        cfg = self.cfg
        if split in ("train", "training"):
            seq_list = cfg.training_split
        elif split in ("test", "testing"):
            seq_list = cfg.test_split
        elif split in ("val", "validation"):
            seq_list = cfg.validation_split
        elif split == "all":
            seq_list = (list(cfg.training_split) +
                        list(cfg.validation_split) + list(cfg.test_split))
        else:
            raise ValueError(f"Invalid split {split}")
        file_list = []
        for seq in seq_list:
            file_list += (
                glob.glob(join(cfg.dataset_path, seq, "lidar", "*.pkl.gz")) +
                glob.glob(join(cfg.dataset_path, seq, "lidar", "*.pkl")))
        return sorted(file_list)

    def is_tested(self, attr):
        return exists(
            join(self.cfg.test_result_folder, attr["name"] + ".npy"))

    def save_test_result(self, results, attr):
        make_dir(self.cfg.test_result_folder)
        np.save(join(self.cfg.test_result_folder, attr["name"] + ".npy"),
                np.asarray(results["predict_labels"]))


class PandasetSplit(BaseDatasetSplit):

    def __init__(self, dataset, split="training"):
        super().__init__(dataset, split=split)
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        import pandas as pd
        pc_path = self.path_list[idx]
        label_path = pc_path.replace("lidar", "annotations/semseg")
        points = pd.read_pickle(pc_path)
        labels = pd.read_pickle(label_path)
        intensity = points["i"].to_numpy().astype(np.float32)
        points = points.drop(columns=["i", "t", "d"]).to_numpy().astype(
            np.float32)
        labels = labels.to_numpy().astype(np.int32).reshape(-1)
        return {"point": points, "feat": intensity.reshape(-1, 1),
                "intensity": intensity, "label": labels}

    def get_attr(self, idx):
        pc_path = Path(self.path_list[idx])
        seq = pc_path.parent.parent.name
        name = f"{seq}_{pc_path.name.split('.')[0]}"
        return {"idx": idx, "name": name, "path": str(pc_path),
                "split": self.split}
