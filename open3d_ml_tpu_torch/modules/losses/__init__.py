"""Losses."""

from .cross_entropy import CrossEntropyLoss
from .focal_loss import FocalLoss
from .semseg_loss import SemSegLoss, filter_valid_label
from .smooth_l1 import SmoothL1Loss

__all__ = ["CrossEntropyLoss", "FocalLoss", "SemSegLoss", "SmoothL1Loss",
           "filter_valid_label"]
