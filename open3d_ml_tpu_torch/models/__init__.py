"""Models of the port."""

from .randlanet import RandLANet

__all__ = ["RandLANet"]
