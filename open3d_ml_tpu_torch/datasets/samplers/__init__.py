"""Patch samplers."""

from .semseg_random import SemSegRandomSampler
from .semseg_spatially_regular import SemSegSpatiallyRegularSampler

__all__ = ["SemSegRandomSampler", "SemSegSpatiallyRegularSampler"]
