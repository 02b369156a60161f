"""Models of the port."""

from .randlanet import RandLANet
from .sparseconvunet import SparseConvUnet

__all__ = ["RandLANet", "SparseConvUnet"]
