"""Host-side data utilities and the detection box."""

from .bev_box import BEVBox3D
from .dataprocessing import DataProcessing

__all__ = ["BEVBox3D", "DataProcessing"]
