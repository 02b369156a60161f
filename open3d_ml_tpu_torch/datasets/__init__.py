"""Datasets, dataset splits, samplers, augmentations and data utilities."""

from . import augment, samplers, utils
from .base_dataset import BaseDataset, BaseDatasetSplit
from .customdataset import Custom3D
from .inference_dummy import InferenceDummySplit
from .kitti import KITTI
from .synthetic import (SyntheticBoxes, SyntheticShapes, make_objdet_scene,
                        make_semseg_scene)

__all__ = ["augment", "samplers", "utils", "BaseDataset", "BaseDatasetSplit",
           "Custom3D", "InferenceDummySplit", "KITTI", "SyntheticBoxes",
           "SyntheticShapes", "make_objdet_scene", "make_semseg_scene"]
