"""Base model contract of the port.

Counterpart of ``open3d_ml_tpu/models/base_model.py`` ``BaseModel``, as far
as inference needs it: a model holds its configuration (``cfg``), a host
random generator (``rng``, seeded by ``cfg.seed``), the point sampler its
``transform`` draws patches with (``trans_point_sampler``, set by the
pipeline), and builds its networks (``get_net``, ``get_eval_net``), each a
``torch.nn.Module``; ``regularizer_loss`` is what a training step adds to
the loss.
"""

from abc import ABC, abstractmethod

import numpy as np

from ..utils.config import ModuleConfig


class BaseModel(ABC):
    """Base for semantic segmentation models."""

    # whether ``transform`` draws its patches with ``trans_point_sampler``,
    # which advances the possibility map that the pipeline's test and
    # inference loop runs until every point is covered
    draws_patches = True
    # where ``draws_patches`` is False: the ROADMAP item that queues the
    # test and inference loop, which the pipeline names when it refuses
    patch_loop_queue = None
    # whether a training step may run split over ranks
    # (``parallel.mesh``): every BatchNorm, dropout and loss divisor of the
    # model's nets takes the global batch's
    data_parallel = False

    def __init__(self, **kwargs):
        self.cfg = ModuleConfig(kwargs)
        self.name = self.cfg.name
        self.rng = np.random.default_rng(self.cfg.get("seed", None))
        # set by the pipeline: callable giving (pc, idxs, center) patches
        self.trans_point_sampler = None

    @abstractmethod
    def get_net(self):
        """Return the ``torch.nn.Module`` implementing the network."""

    def regularizer_loss(self, net):
        """A term the training step adds to the loss, read from ``net``
        after its train-mode forward (KPConv's deformable convolutions').
        Default: 0."""
        return 0.0

    def get_eval_net(self):
        """Network that ``run_inference`` runs. Models whose training net
        takes approximate shortcuts override this with an exact-path net of
        the same ``state_dict``. Default: the training net."""
        return self.get_net()
