"""Models of the port."""

from .kpconv import KPFCNN
from .point_pillars import PointPillars
from .point_rcnn import PointRCNN
from .point_transformer import PointTransformer
from .pointnet2 import Pointnet2MSG
from .pvcnn import PVCNN
from .randlanet import RandLANet
from .sparseconvunet import SparseConvUnet

__all__ = ["KPFCNN", "PVCNN", "PointPillars", "PointRCNN",
           "PointTransformer", "Pointnet2MSG", "RandLANet", "SparseConvUnet"]
