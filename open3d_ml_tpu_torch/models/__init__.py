"""Models of the port."""

from .point_pillars import PointPillars
from .randlanet import RandLANet
from .sparseconvunet import SparseConvUnet

__all__ = ["PointPillars", "RandLANet", "SparseConvUnet"]
