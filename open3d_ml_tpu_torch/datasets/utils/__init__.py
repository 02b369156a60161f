"""Host-side data utilities."""

from .dataprocessing import DataProcessing

__all__ = ["DataProcessing"]
