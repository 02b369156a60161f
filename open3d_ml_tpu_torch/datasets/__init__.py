"""Datasets, dataset splits, samplers, augmentations and data utilities."""

from . import augment, samplers, utils
from .base_dataset import BaseDataset, BaseDatasetSplit
from .customdataset import Custom3D
from .inference_dummy import InferenceDummySplit
from .kitti import KITTI
from .parislille3d import ParisLille3D
from .s3dis import S3DIS
from .scannet import Scannet
from .semantic3d import Semantic3D
from .semantickitti import SemanticKITTI
from .synthetic import (SyntheticBoxes, SyntheticShapes, make_objdet_scene,
                        make_semseg_scene)
from .toronto3d import Toronto3D

__all__ = ["augment", "samplers", "utils", "BaseDataset", "BaseDatasetSplit",
           "Custom3D", "InferenceDummySplit", "KITTI", "ParisLille3D",
           "S3DIS", "Scannet", "Semantic3D", "SemanticKITTI",
           "SyntheticBoxes", "SyntheticShapes", "Toronto3D",
           "make_objdet_scene", "make_semseg_scene"]
