"""Smooth-L1 (Huber) loss.

Counterpart of ``open3d_ml_tpu/modules/losses/smooth_l1.py``.
"""

import torch

from .focal_loss import normalised


class SmoothL1Loss:

    def __init__(self, beta=1.0, loss_weight=1.0):
        self.beta = beta
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        """0.5 d^2 / beta where d = |pred - target| < beta, else d - 0.5
        beta; weighted by ``weight`` ([N] or like ``pred``), summed and
        divided by max(``avg_factor``, 1) (default N)."""
        diff = torch.abs(pred.float() - target.float())
        loss = torch.where(diff < self.beta,
                           0.5 * diff * diff / self.beta,
                           diff - 0.5 * self.beta)
        if weight is not None:
            if weight.dim() < loss.dim():
                weight = weight[..., None]
            loss = loss * weight
        return normalised(self.loss_weight, loss.sum(), avg_factor,
                          pred.shape[0])
