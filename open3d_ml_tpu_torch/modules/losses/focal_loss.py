"""Sigmoid focal loss of dense detection heads.

Counterpart of ``open3d_ml_tpu/modules/losses/focal_loss.py``:
FL(p_t) = -alpha_t (1 - p_t)^gamma log(p_t), summed and divided by an
external normaliser, with weights in place of index compaction.
"""

import torch
import torch.nn.functional as F


def normalised(loss_weight, total, avg_factor, rows):
    """``loss_weight * total / max(avg_factor, 1)``; ``avg_factor`` a
    number or a tensor, ``rows`` (the loss's first dimension) when None."""
    if avg_factor is None:
        avg_factor = rows
    if isinstance(avg_factor, torch.Tensor):
        return loss_weight * total / avg_factor.clamp(min=1.0)
    return loss_weight * total / max(avg_factor, 1.0)


class FocalLoss:

    def __init__(self, gamma=2.0, alpha=0.25, loss_weight=1.0):
        self.gamma = gamma
        self.alpha = alpha
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        """Args:
            pred: [N, C] logits.
            target: [N, C] one-hot targets, or [N] int class ids where id
                == C is the background (an all-zero one-hot row).
            weight: None, or [N] or [N, C] weights.
            avg_factor: the normaliser (default N).
        """
        pred = pred.float()
        if target.dim() == pred.dim() - 1:
            c = pred.shape[-1]
            target = target[..., None] == torch.arange(c,
                                                       device=pred.device)
        target = target.float()
        p = torch.sigmoid(pred)
        ce = -(target * F.logsigmoid(pred) +
               (1 - target) * F.logsigmoid(-pred))
        p_t = p * target + (1 - p) * (1 - target)
        alpha_t = self.alpha * target + (1 - self.alpha) * (1 - target)
        loss = alpha_t * ((1 - p_t) ** self.gamma) * ce
        if weight is not None:
            if weight.dim() < loss.dim():
                weight = weight[..., None]
            loss = loss * weight
        return normalised(self.loss_weight, loss.sum(), avg_factor,
                          pred.shape[0])
