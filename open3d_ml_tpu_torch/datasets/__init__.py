"""Dataset splits, samplers, augmentations and data utilities."""

from . import augment, samplers, utils
from .base_dataset import BaseDatasetSplit
from .inference_dummy import InferenceDummySplit

__all__ = ["augment", "samplers", "utils", "BaseDatasetSplit",
           "InferenceDummySplit"]
