"""nuScenes 3D object detection dataset reader (info pickles).

Counterpart of ``open3d_ml_tpu/datasets/nuscenes.py``, the same code: the
``infos_{train,val,test}.pkl`` files that the reference's nuScenes
converter writes (each entry a lidar path, the lidar-to-ego pose and the
gt boxes), the sweeps as [N, 5] float32 (x, y, z, intensity, ring), the
boxes with lidar points in them, and KITTI-format result files. Its
splits draw no patches, so they have no sampler.
"""

import logging
import os
import pickle
from os.path import join
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset
from .utils import BEVBox3D

log = logging.getLogger(__name__)


@DATASET.register_module()
class NuScenes(BaseDataset):
    """nuScenes: 10 detection classes; the splits are the info pickles
    under ``info_path`` (``dataset_path`` when not given)."""

    NUM_CLASSES = 10

    def __init__(self,
                 dataset_path,
                 info_path=None,
                 name="NuScenes",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 test_result_folder="./test",
                 **kwargs):
        if info_path is None:
            info_path = dataset_path
        super().__init__(dataset_path=dataset_path,
                         info_path=info_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         test_result_folder=test_result_folder,
                         **kwargs)
        self.num_classes = self.NUM_CLASSES
        self.label_to_names = self.get_label_to_names()

        self.train_info = {}
        self.test_info = {}
        self.val_info = {}
        for split, attr in (("train", "train_info"), ("val", "val_info"),
                            ("test", "test_info")):
            path = join(info_path, f"infos_{split}.pkl")
            if os.path.exists(path):
                with open(path, "rb") as f:
                    setattr(self, attr, pickle.load(f))

    @staticmethod
    def get_label_to_names():
        return {
            0: "ignore", 1: "barrier", 2: "bicycle", 3: "bus", 4: "car",
            5: "construction_vehicle", 6: "motorcycle", 7: "pedestrian",
            8: "traffic_cone", 9: "trailer", 10: "truck"
        }

    @staticmethod
    def read_lidar(path):
        assert Path(path).exists()
        return np.fromfile(path, dtype=np.float32).reshape(-1, 5)

    @staticmethod
    def read_label(info, calib):
        """The info's boxes that hold lidar points, as ``BEVBox3D``: the
        size reordered to (w, h, l) and the yaw as the info stores it."""
        mask = info["num_lidar_pts"] != 0
        boxes = info["gt_boxes"][mask]
        names = info["gt_names"][mask]
        objects = []
        for name, box in zip(names, boxes):
            center = [float(box[0]), float(box[1]), float(box[2])]
            size = [float(box[3]), float(box[5]), float(box[4])]
            ry = float(box[6])
            yaw = ry - np.pi
            yaw = yaw - np.floor(yaw / (2 * np.pi) + 0.5) * 2 * np.pi
            objects.append(
                BEVBox3D(center, size, yaw, name, -1.0, calib["world_cam"]))
            objects[-1].yaw = ry
        return objects

    def get_split(self, split):
        return NuScenesSplit(self, split=split)

    def get_split_list(self, split):
        if split in ("train", "training"):
            return self.train_info
        if split in ("test", "testing"):
            return self.test_info
        if split in ("val", "validation"):
            return self.val_info
        raise ValueError(f"Invalid split {split}")

    def is_tested(self, attr):
        return False

    def save_test_result(self, results, attrs):
        """Write KITTI-format .txt result files."""
        make_dir(self.cfg.test_result_folder)
        for attr, res in zip(attrs, results):
            path = join(self.cfg.test_result_folder, attr["name"] + ".txt")
            with open(path, "w") as f:
                for box in res:
                    f.write(box.to_kitti_format(box.confidence))
                    f.write("\n")


class NuScenesSplit:
    """One split of an info-pickle dataset (nuScenes, Lyft)."""

    def __init__(self, dataset, split="train"):
        self.cfg = dataset.cfg
        self.infos = dataset.get_split_list(split)
        self.split = split
        self.dataset = dataset
        log.info(f"Found {len(self.infos)} pointclouds for {split}")

    def __len__(self):
        return len(self.infos)

    def get_data(self, idx):
        info = self.infos[idx]
        world_cam = np.eye(4)
        world_cam[:3, :3] = Rotation.from_quat(
            info["lidar2ego_rot"]).as_matrix()
        world_cam[:3, -1] = info["lidar2ego_tr"]
        calib = {"world_cam": world_cam.T}
        pc = self.dataset.read_lidar(info["lidar_path"])
        label = self.dataset.read_label(info, calib)
        return {"point": pc, "feat": None, "calib": calib,
                "bounding_boxes": label}

    def get_attr(self, idx):
        info = self.infos[idx]
        name = Path(info["lidar_path"]).name.split(".")[0]
        return {"name": name, "path": str(info["lidar_path"]),
                "split": self.split}
