"""Building blocks shared by the port's voxel networks."""

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of a padded [..., V, C] tensor.

    Counterpart of ``open3d_ml_tpu/models/common.py`` ``MaskedBatchNorm``
    with ``axis_name=None``: (x - mean) * rsqrt(var + eps) * weight + bias,
    with padded rows written as 0. In train mode mean and var are the
    batch statistics of the valid rows over every axis but the last (the
    count, sum and sum of squares taken together, var = max(s2 / n -
    mean^2, 0), biased, as flax takes them), and the running statistics
    move towards them as flax moves them, running = (1 - momentum) *
    running + momentum * batch; in eval mode they are the running ones.
    Parameter and buffer names are ``nn.BatchNorm1d``'s; ``momentum`` is
    torch's (flax's 0.99 is torch's 0.01).
    """

    def __init__(self, dim, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def reset_parameters(self):
        """The identity: weight 1, bias 0, running mean 0 and variance 1."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, mask):
        """x [..., V, C] float32, mask [..., V] bool -> float32."""
        if self.training:
            m = mask[..., None].to(x.dtype)
            axes = tuple(range(x.dim() - 1))
            count = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(axes) / count
            var = torch.clamp((x * x * m).sum(axes) / count - mean * mean,
                              min=0.0)
            with torch.no_grad():
                keep = 1.0 - self.momentum  # flax's momentum
                self.running_mean.copy_(keep * self.running_mean +
                                        (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var +
                                       (1.0 - keep) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0)
