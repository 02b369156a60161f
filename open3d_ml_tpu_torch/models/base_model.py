"""Base model contract of the port.

Counterpart of ``open3d_ml_tpu/models/base_model.py`` ``BaseModel``, as far
as inference needs it: a model holds its configuration (``cfg``) and builds
its network (``get_net``), a ``torch.nn.Module``.
"""

from abc import ABC, abstractmethod

from ..utils.config import Config


class BaseModel(ABC):
    """Base for semantic segmentation models."""

    def __init__(self, **kwargs):
        self.cfg = Config(kwargs)
        self.name = self.cfg.name

    @abstractmethod
    def get_net(self):
        """Return the ``torch.nn.Module`` implementing the network."""
