"""KITTI 3D object detection dataset reader.

Counterpart of ``open3d_ml_tpu/datasets/kitti.py``, the same code: velodyne
``.bin`` frames, the calib file's projection matrices, label-file boxes
in the camera frame turned into world-frame ``Object3d`` boxes, the points
cut to the camera's view, and KITTI-format result files. Its splits
draw no patches, so they have no sampler.
"""

import logging
from glob import glob
from os.path import join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset, BaseDatasetSplit
from .utils import BEVBox3D, DataProcessing

log = logging.getLogger(__name__)


@DATASET.register_module()
class KITTI(BaseDataset):
    """KITTI 3D: ~7.5k annotated lidar frames with Car/Pedestrian/Cyclist
    boxes; train/val split by frame index (val_split)."""

    def __init__(self,
                 dataset_path,
                 name="KITTI",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 val_split=3712,
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         val_split=val_split,
                         test_result_folder=test_result_folder,
                         **kwargs)
        cfg = self.cfg
        self.num_classes = 3
        self.label_to_names = self.get_label_to_names()

        self.all_files = sorted(
            glob(join(cfg.dataset_path, "training", "velodyne", "*.bin")))
        self.train_files = []
        self.val_files = []
        for f in self.all_files:
            idx = int(Path(f).name.replace(".bin", ""))
            if idx < cfg.val_split:
                self.train_files.append(f)
            else:
                self.val_files.append(f)
        self.test_files = sorted(
            glob(join(cfg.dataset_path, "testing", "velodyne", "*.bin")))

    @staticmethod
    def get_label_to_names():
        return {
            0: "Pedestrian", 1: "Cyclist", 2: "Car", 3: "Van",
            4: "Person_sitting", 5: "DontCare"
        }

    @staticmethod
    def read_lidar(path):
        assert Path(path).exists()
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    @staticmethod
    def read_label(path, calib):
        """Parse a KITTI label file into Object3d boxes (world frame)."""
        if not Path(path).exists():
            return []
        with open(path, "r") as f:
            lines = f.readlines()
        objects = []
        for line in lines:
            label = line.strip().split(" ")
            center_cam = np.array(
                [float(label[11]), float(label[12]), float(label[13]), 1.0])
            pts = center_cam @ np.linalg.inv(calib["world_cam"])
            size = [float(label[9]), float(label[8]), float(label[10])]
            center = [pts[0], pts[1], size[1] / 2 + pts[2]]
            objects.append(Object3d(center, size, label, calib))
        return objects

    @staticmethod
    def _extend_matrix(mat):
        return np.concatenate(
            [mat, np.array([[0., 0., 1., 0.]], dtype=mat.dtype)], axis=0)

    @staticmethod
    def read_calib(path):
        """Parse a KITTI calib file -> {'world_cam', 'cam_img'} [4,4]
        row-vector-convention matrices."""
        assert Path(path).exists()
        with open(path, "r") as f:
            lines = f.readlines()
        mats = []
        for i in range(4):
            obj = lines[i].strip().split(" ")[1:]
            mats.append(
                KITTI._extend_matrix(
                    np.array(obj, dtype=np.float32).reshape(3, 4)))
        obj = lines[4].strip().split(" ")[1:]
        rect_4x4 = np.eye(4, dtype=np.float32)
        rect_4x4[:3, :3] = np.array(obj, dtype=np.float32).reshape(3, 3)
        obj = lines[5].strip().split(" ")[1:]
        tr_velo_to_cam = np.eye(4, dtype=np.float32)
        tr_velo_to_cam[:3] = np.array(obj, dtype=np.float32).reshape(3, 4)
        world_cam = np.transpose(rect_4x4 @ tr_velo_to_cam)
        cam_img = np.transpose(mats[2])  # P2
        return {"world_cam": world_cam, "cam_img": cam_img}

    def get_split(self, split):
        return KITTISplit(self, split=split)

    def get_split_list(self, split):
        if split in ("train", "training"):
            return self.train_files
        if split in ("test", "testing"):
            return self.test_files
        if split in ("val", "validation"):
            return self.val_files
        if split == "all":
            return self.train_files + self.val_files + self.test_files
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


class KITTISplit(BaseDatasetSplit):

    def __init__(self, dataset, split="train"):
        self.cfg = dataset.cfg
        self.path_list = dataset.get_split_list(split)
        self.split = split
        self.dataset = dataset
        self.sampler = None
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        pc_path = self.path_list[idx]
        label_path = ("label_2".join(
            pc_path.rsplit("velodyne", 1))).replace(".bin", ".txt")
        calib_path = "calib".join(label_path.rsplit("label_2", 1))

        pc = self.dataset.read_lidar(pc_path)
        calib = self.dataset.read_calib(calib_path)
        label = self.dataset.read_label(label_path, calib)
        reduced_pc = DataProcessing.remove_outside_points(
            pc, calib["world_cam"], calib["cam_img"], [375, 1242])
        return {
            "point": reduced_pc,
            "full_point": pc,
            "feat": None,
            "calib": calib,
            "bounding_boxes": label,
        }

    def get_attr(self, idx):
        pc_path = self.path_list[idx]
        name = Path(pc_path).name.split(".")[0]
        return {"name": name, "path": pc_path, "split": self.split}


class Object3d(BEVBox3D):
    """One labeled KITTI object with truncation/occlusion-based difficulty."""

    def __init__(self, center, size, label, calib=None):
        confidence = float(label[15]) if len(label) == 16 else -1.0
        world_cam = calib["world_cam"]
        cam_img = calib["cam_img"]

        # kitti boxes point backwards
        yaw = float(label[14]) - np.pi
        yaw = yaw - np.floor(yaw / (2 * np.pi) + 0.5) * 2 * np.pi

        self.truncation = float(label[1])
        self.occlusion = float(label[2])
        self.alpha = float(label[3])
        self.box2d = np.array(
            (float(label[4]), float(label[5]), float(label[6]),
             float(label[7])), dtype=np.float32)

        class_name = label[0] if label[0] in \
            KITTI.get_label_to_names().values() else "DontCare"
        super().__init__(center, size, yaw, class_name, confidence,
                         world_cam, cam_img)
        self.yaw = float(label[14])

    def get_difficulty(self):
        """KITTI difficulty from projected height/truncation/occlusion."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = "Easy"
            return 0
        elif height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = "Moderate"
            return 1
        elif height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = "Hard"
            return 2
        self.level_str = "UnKnown"
        return -1


