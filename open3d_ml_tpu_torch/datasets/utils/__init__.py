"""Host-side data utilities, the PLY reader and writer, and the detection
box."""

from .bev_box import BEVBox3D
from .dataprocessing import DataProcessing
from .ply import read_ply, write_ply

__all__ = ["BEVBox3D", "DataProcessing", "read_ply", "write_ply"]
