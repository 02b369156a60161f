"""Dataloaders, the prefetching batch loader and batchers."""

from .batch_loader import BatchLoader
from .batcher import DefaultBatcher
from .dataloader import PointCloudDataloader

__all__ = ["BatchLoader", "DefaultBatcher", "PointCloudDataloader"]
