"""Metrics."""

from .semseg_metric import SemSegMetric, confusion_matrix_device

__all__ = ["SemSegMetric", "confusion_matrix_device"]
