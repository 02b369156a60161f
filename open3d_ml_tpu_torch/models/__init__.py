"""Models of the port."""

from .point_pillars import PointPillars
from .point_transformer import PointTransformer
from .randlanet import RandLANet
from .sparseconvunet import SparseConvUnet

__all__ = ["PointPillars", "PointTransformer", "RandLANet",
           "SparseConvUnet"]
