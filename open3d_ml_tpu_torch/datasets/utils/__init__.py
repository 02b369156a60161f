"""Host-side data utilities, the PLY and PCD readers, the transform
helpers and the detection box."""

from . import transforms
from .bev_box import BEVBox3D
from .dataprocessing import DataProcessing
from .pcd import read_pcd
from .ply import read_ply, write_ply
from .transforms import trans_augment, trans_crop_pc, trans_normalize

__all__ = ["BEVBox3D", "DataProcessing", "read_pcd", "read_ply",
           "trans_augment", "trans_crop_pc", "trans_normalize",
           "transforms", "write_ply"]
