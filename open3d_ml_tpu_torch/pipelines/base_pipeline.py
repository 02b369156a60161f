"""Base pipeline: configuration, host random generator, device, log
directory and the TensorBoard writer of training.

Counterpart of ``open3d_ml_tpu/pipelines/base_pipeline.py``. The port runs
on one explicit torch device; its logs and checkpoints go under
``<main_log_dir>/<model>_<dataset>_torch`` (``cfg.logs_dir``), made when
something is written there; a training run's TensorBoard summaries under
``<train_sum_dir>/<run id>_<model>_<dataset>_torch`` (``train_sum_dir``
"train_log" by default, as in the JAX package; the run ids as there).

Data parallelism (``parallel.mesh``): in a process group of more than one
rank each rank runs its share of every global batch (``_on_rows``); a
rank's device is ``cuda:<LOCAL_RANK>`` when the caller says only
``cuda``; rank 0 alone writes the log file, the summaries and the
checkpoints, the other ranks waiting at a barrier where a rank reads what
it wrote; the model and the dataset must be seeded, so that every rank
draws the same global batches; and only models whose training step holds
to the global batch (``data_parallel``: RandLA-Net, PointPillars) may run
there.
"""

import contextlib
import logging
import sys
from abc import ABC, abstractmethod
from datetime import datetime
from os.path import join

import numpy as np
import torch

from ..parallel.mesh import (barrier, data_parallel_jit, local_rank,
                             make_mesh)
from ..utils import make_dir
from ..utils.config import Config, ModuleConfig
from ..utils.log import code2md, get_runid

log = logging.getLogger(__name__)


class _NoWriter:
    """The summary writer of a rank that writes none: every call does
    nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


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
        self.mesh = make_mesh(
            model_parallel=int(self.cfg.get("model_parallel", 1)))
        if self.mesh.size > 1 and not model.data_parallel:
            raise NotImplementedError(
                f"{type(model).__name__} on {self.mesh.size} ranks: its data "
                "parallelism is not ported (ROADMAP queue 1 item 7); "
                "RandLANet and PointPillars train over --distributed")
        unseeded = [type(m).__name__ for m in (model, dataset)
                    if m is not None and m.cfg.get("seed") is None]
        if self.mesh.size > 1 and unseeded:
            raise ValueError(
                f"{' and '.join(unseeded)} with no seed on {self.mesh.size} "
                "ranks: each rank draws the global batch from the same "
                "seeded generators and keeps its rows; give them a seed")
        if self.mesh.size > 1 and str(device) == "cuda":
            device = f"cuda:{local_rank()}"
        self.device = torch.device(device)
        dataset_name = dataset.name if dataset is not None else ""
        self.run_name = f"{type(model).__name__}_{dataset_name}_torch"
        self.cfg["logs_dir"] = join(self.cfg.get("main_log_dir", "./logs/"),
                                    self.run_name)

    @property
    def writes(self):
        """Whether this rank writes logs, summaries and checkpoints."""
        return self.mesh.rank == 0

    def _on_rows(self, step, batch, *args):
        """``step(inputs, *args)`` on this rank's rows of the collated host
        ``batch`` (all of them where it is not split), moved to the
        device, as this rank's share of the global batch."""
        return data_parallel_jit(
            lambda data: step(self._device_batch({"data": data}), *args),
            self.mesh)(batch["data"])

    def _on_rank0(self, fn, *args):
        """``fn(*args)`` on rank 0 alone, the other ranks waiting for it
        and returning None."""
        try:
            return fn(*args) if self.writes else None
        finally:
            barrier(self.mesh)

    @contextlib.contextmanager
    def _log_file(self, logger, kind):
        """While the block runs, ``logger``'s records also go to
        ``<logs_dir>/log_<kind>_<time>.txt``, on the rank that writes."""
        if not self.writes:
            yield
            return
        make_dir(self.cfg.logs_dir)
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        handler = logging.FileHandler(join(self.cfg.logs_dir,
                                           f"log_{kind}_{stamp}.txt"))
        logger.addHandler(handler)
        try:
            yield
        finally:
            logger.removeHandler(handler)
            handler.close()

    def _make_writer(self):
        """A TensorBoard writer in ``<train_sum_dir>/<run id>_<model>_
        <dataset>_torch``, the run id one more than the largest of that
        name's earlier runs, with the command line and the configuration
        written as text; on a rank that does not write, one that does
        nothing."""
        if not self.writes:
            return _NoWriter()
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
