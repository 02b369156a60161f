"""Box types shared by the detection models, datasets and metrics, and the
colours of labels and scalars for the summaries."""

from .boundingbox import BoundingBox3D
from .colormap import Colormap
from .labellut import LabelLUT

__all__ = ["BoundingBox3D", "Colormap", "LabelLUT"]
