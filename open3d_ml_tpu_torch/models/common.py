"""Building blocks shared by the port's networks."""

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm with flax's training semantics (``flax.linen.BatchNorm``,
    ``use_fast_variance``), in float32, over every axis but the channel
    axis ``axis`` (-1: channels last, [..., C]; 1: NCHW).

    In train mode it normalises with the batch mean and the biased batch
    variance E[x^2] - E[x]^2 (clamped at 0), as (x - mean) *
    (rsqrt(var + eps) * weight) + bias, and moves the running statistics
    towards the same biased variance by torch's ``momentum`` (flax's
    0.99 is torch's 0.01); ``nn.BatchNorm1d`` would move them towards the
    unbiased one. In eval mode it is ``F.batch_norm`` on the running
    statistics. A bf16 input is read in float32, as flax promotes it; the
    output is float32 (float64 for a float64 input, on float64 weights).
    The parameter and buffer names are torch's.
    """

    def __init__(self, dim, eps=1e-5, momentum=0.01, axis=-1):
        super().__init__(dim, eps=eps, momentum=momentum)
        if axis not in (-1, 1):
            raise ValueError(f"channel axis {axis}: -1 or 1")
        self.axis = axis

    def forward(self, x):
        if x.dtype != torch.float64:
            x = x.float()
        rows = x.reshape(-1, x.shape[-1]) if self.axis == -1 else x
        if not self.training:
            out = F.batch_norm(rows, self.running_mean, self.running_var,
                               self.weight, self.bias, False, 0.0, self.eps)
            return out.reshape(x.shape)
        dims = 0 if self.axis == -1 else (0, 2, 3)
        mean = rows.mean(dims)
        var = torch.clamp((rows * rows).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        if self.axis == 1:
            mean, mul = mean[:, None, None], mul[:, None, None]
            return (rows - mean) * mul + self.bias[:, None, None]
        return ((rows - mean) * mul + self.bias).reshape(x.shape)


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


class Dropout(nn.Module):
    """Dropout whose keep mask comes from a generator of its own, seeded by
    ``manual_seed`` and made on the input's device at first use (never
    torch's global generator): an element is kept with probability 1 - p
    and scaled by 1 / (1 - p), as ``flax.linen.Dropout`` does. The
    identity in eval mode."""

    def __init__(self, p, seed=0):
        super().__init__()
        self.p = p
        self.manual_seed(seed)

    def manual_seed(self, seed):
        self.seed = int(seed)
        self.generator = None

    def forward(self, x):
        if not self.training:
            return x
        if self.generator is None or self.generator.device != x.device:
            self.generator = torch.Generator(device=x.device).manual_seed(
                self.seed)
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))
