"""Base pipeline: configuration, host random generator, device, log
directory.

Counterpart of ``open3d_ml_tpu/pipelines/base_pipeline.py``. The port runs
on one explicit torch device; its logs and checkpoints go under
``<main_log_dir>/<model>_<dataset>_torch`` (``cfg.logs_dir``), made when
something is written there.
"""

from abc import ABC, abstractmethod
from os.path import join

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
        dataset_name = dataset.name if dataset is not None else ""
        self.cfg["logs_dir"] = join(
            self.cfg.get("main_log_dir", "./logs/"),
            f"{type(model).__name__}_{dataset_name}_torch")

    @abstractmethod
    def run_inference(self, data):
        """Run inference on one datum."""

    @abstractmethod
    def run_test(self):
        """Run testing on the test split."""

    @abstractmethod
    def run_train(self):
        """Run training on the train split."""
