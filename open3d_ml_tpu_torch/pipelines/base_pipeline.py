"""Base pipeline: configuration, host random generator, device.

Counterpart of ``open3d_ml_tpu/pipelines/base_pipeline.py``. The port runs
on one explicit torch device; log directories, the mesh and the TensorBoard
writer come with the training slice.
"""

from abc import ABC, abstractmethod

import numpy as np
import torch

from ..utils.config import Config


class BasePipeline(ABC):
    """Base for the port's pipelines."""

    def __init__(self, model, dataset=None, device="cuda", **kwargs):
        if kwargs.get("name") is None:
            raise KeyError("Provide pipeline name to initialize it")
        self.cfg = Config(kwargs)
        self.name = self.cfg.name
        self.model = model
        self.dataset = dataset
        self.rng = np.random.default_rng(kwargs.get("seed", None))
        self.device = torch.device(device)

    @abstractmethod
    def run_inference(self, data):
        """Run inference on one datum."""
