"""Datasets, dataset splits, samplers, augmentations and data utilities."""

from . import augment, samplers, utils
from .base_dataset import BaseDataset, BaseDatasetSplit
from .inference_dummy import InferenceDummySplit
from .synthetic import SyntheticShapes, make_semseg_scene

__all__ = ["augment", "samplers", "utils", "BaseDataset", "BaseDatasetSplit",
           "InferenceDummySplit", "SyntheticShapes", "make_semseg_scene"]
