"""Pipelines of the port."""

from .object_detection import ObjectDetection
from .semantic_segmentation import SemanticSegmentation

__all__ = ["ObjectDetection", "SemanticSegmentation"]
