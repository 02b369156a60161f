"""Datasets, dataset splits, samplers, augmentations and data utilities."""

from . import augment, samplers, utils
from .argoverse import Argoverse
from .base_dataset import BaseDataset, BaseDatasetSplit
from .customdataset import Custom3D
from .inference_dummy import InferenceDummySplit
from .kitti import KITTI
from .lyft import Lyft
from .nuscenes import NuScenes
from .parislille3d import ParisLille3D
from .s3dis import S3DIS
from .scannet import Scannet
from .semantic3d import Semantic3D
from .semantickitti import SemanticKITTI
from .synthetic import (SyntheticBoxes, SyntheticShapes, make_objdet_scene,
                        make_semseg_scene)
from .toronto3d import Toronto3D
from .waymo import Waymo

__all__ = ["augment", "samplers", "utils", "Argoverse", "BaseDataset",
           "BaseDatasetSplit", "Custom3D", "InferenceDummySplit", "KITTI",
           "Lyft", "NuScenes", "ParisLille3D", "S3DIS", "Scannet",
           "Semantic3D", "SemanticKITTI", "SyntheticBoxes",
           "SyntheticShapes", "Toronto3D", "Waymo", "make_objdet_scene",
           "make_semseg_scene"]
