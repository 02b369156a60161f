"""Patch samplers."""

from .semseg_spatially_regular import SemSegSpatiallyRegularSampler

__all__ = ["SemSegSpatiallyRegularSampler"]
