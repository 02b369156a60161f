"""Cross-entropy loss, optionally weighted.

Counterpart of ``open3d_ml_tpu/modules/losses/cross_entropy.py``.
"""

import torch

from .focal_loss import normalised


class CrossEntropyLoss:

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label, weight=None, avg_factor=None):
        """``cls_score`` [N, C] logits, ``label`` [N] int; the negative
        log-likelihoods weighted by ``weight`` [N], summed and divided by
        max(``avg_factor``, 1) (default N)."""
        logp = torch.log_softmax(cls_score.float(), dim=-1)
        nll = -torch.take_along_dim(logp, label[:, None].long(), dim=-1)[:, 0]
        if weight is not None:
            nll = nll * weight
        return normalised(self.loss_weight, nll.sum(), avg_factor,
                          cls_score.shape[0])
