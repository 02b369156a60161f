"""Base pipeline: configuration, host random generator, device, log
directory and the TensorBoard writer of training.

Counterpart of ``open3d_ml_tpu/pipelines/base_pipeline.py``. The port runs
on one explicit torch device; its logs and checkpoints go under
``<main_log_dir>/<model>_<dataset>_torch`` (``cfg.logs_dir``), made when
something is written there; a training run's TensorBoard summaries under
``<train_sum_dir>/<run id>_<model>_<dataset>_torch`` (``train_sum_dir``
"train_log" by default, as in the JAX package; the run ids as there).
"""

import logging
import sys
from abc import ABC, abstractmethod
from os.path import join

import numpy as np
import torch

from ..utils.config import Config, ModuleConfig
from ..utils.log import code2md, get_runid

log = logging.getLogger(__name__)


class BasePipeline(ABC):
    """Base for the port's pipelines."""

    def __init__(self, model, dataset=None, device="cuda", **kwargs):
        if kwargs.get("name") is None:
            raise KeyError("Provide pipeline name to initialize it")
        self.cfg = ModuleConfig(dict({"train_sum_dir": "train_log"},
                                     **kwargs))
        self.name = self.cfg.name
        self.model = model
        self.dataset = dataset
        self.rng = np.random.default_rng(kwargs.get("seed", None))
        self.device = torch.device(device)
        dataset_name = dataset.name if dataset is not None else ""
        self.run_name = f"{type(model).__name__}_{dataset_name}_torch"
        self.cfg["logs_dir"] = join(self.cfg.get("main_log_dir", "./logs/"),
                                    self.run_name)

    def _make_writer(self):
        """A TensorBoard writer in ``<train_sum_dir>/<run id>_<model>_
        <dataset>_torch``, the run id one more than the largest of that
        name's earlier runs, with the command line and the configuration
        written as text."""
        from torch.utils.tensorboard import SummaryWriter
        path = join(self.cfg.train_sum_dir, self.run_name)
        self.tensorboard_dir = join(self.cfg.train_sum_dir,
                                    f"{get_runid(path)}_{self.run_name}")
        writer = SummaryWriter(self.tensorboard_dir)
        writer.add_text("Description/Command line", " ".join(sys.argv), 0)
        writer.add_text("Configuration", code2md(
            Config(dict(self.cfg)).dump(), language="yaml"), 0)
        log.info(f"Writing summary in {self.tensorboard_dir}.")
        return writer

    @abstractmethod
    def run_inference(self, data):
        """Run inference on one datum."""

    @abstractmethod
    def run_test(self):
        """Run testing on the test split."""

    @abstractmethod
    def run_train(self):
        """Run training on the train split."""
