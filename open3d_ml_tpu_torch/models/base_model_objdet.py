"""Base contract of the 3D object detection models.

Counterpart of ``open3d_ml_tpu/models/base_model_objdet.py``: the host
side (``preprocess``, ``transform``) emits fixed-shape padded arrays, the
networks are ``torch.nn.Module``s, and ``inference_end`` turns a batch of
network outputs into boxes.
"""

from abc import abstractmethod

from .base_model import BaseModel


class ObjdetBaseModel(BaseModel):

    @abstractmethod
    def get_loss(self, results, inputs):
        """The loss dict of network outputs and a padded batch."""

    @abstractmethod
    def inference_end(self, results, inputs):
        """Network outputs -> one list of ``BEVBox3D`` per sample."""
