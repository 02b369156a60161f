"""Box types shared by the detection models, datasets and metrics."""

from .boundingbox import BoundingBox3D

__all__ = ["BoundingBox3D"]
