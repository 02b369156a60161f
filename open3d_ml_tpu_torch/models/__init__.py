"""Models of the port."""

from .kpconv import KPFCNN
from .point_pillars import PointPillars
from .point_transformer import PointTransformer
from .randlanet import RandLANet
from .sparseconvunet import SparseConvUnet

__all__ = ["KPFCNN", "PointPillars", "PointTransformer", "RandLANet",
           "SparseConvUnet"]
