"""Losses."""

from .semseg_loss import SemSegLoss, filter_valid_label

__all__ = ["SemSegLoss", "filter_valid_label"]
