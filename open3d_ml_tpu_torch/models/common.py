"""Building blocks shared by the port's voxel networks."""

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded [..., V, C] tensor.

    Counterpart of ``open3d_ml_tpu/models/common.py`` ``MaskedBatchNorm``
    in eval mode: (x - running_mean) * rsqrt(running_var + eps) * weight +
    bias, with padded rows written as 0. Parameter and buffer names are
    ``nn.BatchNorm1d``'s; ``momentum`` is torch's (flax's 0.99 is torch's
    0.01). Train mode, with masked batch statistics, belongs to the
    training slice and raises.
    """

    def __init__(self, dim, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x, mask):
        """x [..., V, C] float32, mask [..., V] bool -> float32."""
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm in train mode (masked batch statistics) is "
                "not ported; it comes with SparseConvUnet training")
        y = ((x - self.running_mean) *
             torch.rsqrt(self.running_var + self.eps) * self.weight +
             self.bias)
        return torch.where(mask[..., None], y, 0.0)
