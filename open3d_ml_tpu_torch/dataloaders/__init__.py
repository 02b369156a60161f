"""Dataloaders and batchers."""

from .batcher import DefaultBatcher
from .dataloader import PointCloudDataloader

__all__ = ["DefaultBatcher", "PointCloudDataloader"]
