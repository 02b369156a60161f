"""ScanNet v2: indoor RGB-D scenes with semantic and instance labels.

Counterpart of ``open3d_ml_tpu/datasets/scannet.py``. A scene is four
files under ``dataset_path``: ``<scene>_vert.npy`` (x, y, z, r, g, b),
``<scene>_sem_label.npy`` (nyu40 ids), ``<scene>_ins_label.npy`` and
``<scene>_bbox.npy`` (center, size, nyu40 id); each scene falls in the
split whose official list (``_resources/scannet``) names it. The reader
has 18 classes: the nyu40 ids of its detection classes map to 0-17 and
every other id to -1 (ignored), as in the JAX reader, whatever
``num_classes`` the model is given.
"""

import logging
import os
from os.path import exists, join
from pathlib import Path

import numpy as np

from ..utils import DATASET, make_dir
from .base_dataset import BaseDataset, BaseDatasetSplit
from .utils import BEVBox3D

log = logging.getLogger(__name__)


@DATASET.register_module()
class Scannet(BaseDataset):
    """ScanNet scenes; the predictions of a test run go to
    ``<test_result_folder>/Scannet/<scene>.npy``."""

    def __init__(self,
                 dataset_path,
                 name="Scannet",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         test_result_folder=test_result_folder,
                         **kwargs)
        cfg = self.cfg
        self.dataset_path = cfg.dataset_path
        self.num_classes = 18
        self.classes = [
            "cabinet", "bed", "chair", "sofa", "table", "door", "window",
            "bookshelf", "picture", "counter", "desk", "curtain",
            "refrigerator", "showercurtrain", "toilet", "sink", "bathtub",
            "garbagebin"
        ]
        self.cat2label = {c: i for i, c in enumerate(self.classes)}
        self.cat2label["ignored"] = -1
        self.label2cat = {v: k for k, v in self.cat2label.items()}
        # nyu40 ids of the classes
        self.cat_ids = np.array(
            [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36,
             39])
        self.cat_ids2class = {int(n): i for i, n in enumerate(self.cat_ids)}
        self.semantic_ids = list(self.cat_ids)
        self.label_to_names = self.get_label_to_names()

        available = sorted({
            f[:12] for f in os.listdir(cfg.dataset_path)
            if f.startswith("scene") and f.endswith(".npy")
        })
        res = Path(__file__).parent / "_resources" / "scannet"
        split_lists = {}
        for s in ("train", "val", "test"):
            p = res / f"scannetv2_{s}.txt"
            split_lists[s] = (set(p.read_text().split("\n")) if p.exists()
                              else set())
        self.train_scenes, self.val_scenes, self.test_scenes = [], [], []
        for scene in available:
            if scene in split_lists["train"]:
                self.train_scenes.append(join(cfg.dataset_path, scene))
            elif scene in split_lists["val"]:
                self.val_scenes.append(join(cfg.dataset_path, scene))
            elif scene in split_lists["test"]:
                self.test_scenes.append(join(cfg.dataset_path, scene))

    def get_label_to_names(self):
        return self.label2cat

    @staticmethod
    def read_lidar(path):
        assert Path(path).exists()
        return np.load(path)

    def read_label(self, scene):
        """(the scene's boxes, semantic classes in -1..17, instances)."""
        instance_mask = np.load(scene + "_ins_label.npy")
        semantic_mask = np.load(scene + "_sem_label.npy")
        bboxes = np.load(scene + "_bbox.npy")

        remapper = np.full(150, -1, np.int64)
        for i, x in enumerate(self.semantic_ids):
            remapper[x] = i
        semantic_mask = remapper[semantic_mask]

        objects = []
        for box in bboxes:
            name = self.label2cat[self.cat_ids2class[int(box[-1])]]
            center = box[:3]
            size = [box[3], box[5], box[4]]  # w, h, l
            objects.append(BEVBox3D(center, size, 0.0, name, -1.0))
        return objects, semantic_mask, instance_mask

    def get_split(self, split):
        return ScannetSplit(self, split=split)

    def get_split_list(self, split):
        if split in ("train", "training"):
            return self.train_scenes
        if split in ("test", "testing"):
            return self.test_scenes
        if split in ("val", "validation"):
            return self.val_scenes
        if split == "all":
            return self.train_scenes + self.val_scenes + self.test_scenes
        raise ValueError(f"Invalid split {split}")

    def is_tested(self, attr):
        path = join(self.cfg.test_result_folder, self.name)
        return exists(join(path, attr["name"] + ".npy"))

    def save_test_result(self, results, attr):
        path = join(self.cfg.test_result_folder, self.name)
        make_dir(path)
        np.save(join(path, attr["name"] + ".npy"),
                np.asarray(results["predict_labels"]))


class ScannetSplit(BaseDatasetSplit):
    """One split of ``Scannet``."""

    def __init__(self, dataset, split="training"):
        super().__init__(dataset, split=split)
        log.info(f"Found {len(self.path_list)} pointclouds for {split}")

    def __len__(self):
        return len(self.path_list)

    def get_data(self, idx):
        scene = self.path_list[idx]
        pc = self.dataset.read_lidar(scene + "_vert.npy")
        feat = pc[:, 3:]
        pc = pc[:, :3]
        if self.split in ("test", "testing"):
            n = pc.shape[0]
            return {"point": pc, "feat": feat, "calib": None,
                    "bounding_boxes": [],
                    "label": np.zeros((n,), np.int32),
                    "instance": np.zeros((n,), np.int32)}
        bboxes, semantic_mask, instance_mask = self.dataset.read_label(scene)
        return {
            "point": pc,
            "feat": feat,
            "calib": None,
            "bounding_boxes": bboxes,
            "label": semantic_mask.astype(np.int32),
            "instance": instance_mask.astype(np.int32),
        }

    def get_attr(self, idx):
        pc_path = self.path_list[idx]
        name = Path(pc_path).name.split(".")[0]
        return {"name": name, "path": str(pc_path), "split": self.split}
