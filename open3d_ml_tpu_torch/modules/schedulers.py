"""Learning-rate schedules, each a ``LambdaLR`` stepped once after every
optimizer step, so that update t (counted from 0) runs at the base rate
times its factor at t; and the BatchNorm momentum schedule.

Counterparts of ``open3d_ml_tpu/modules/schedulers``: ``exponential_lr``
(lr * gamma^(t // steps_per_epoch)), ``cosine_warmup_lr``,
``one_cycle_lr`` (optax's ``linear_onecycle_schedule``, as the JAX
function builds it) and ``bn_momentum_schedule``. The base rate is the
optimizer's, where the JAX functions take it as an argument.
``piecewise_lr`` is optax's ``piecewise_constant_schedule``, which
PointTransformer's optimizer runs under. The factors are computed in
float64; the JAX schedules in float32, whose rounding of a value near the
base rate shows where a factor is small (1 + cos near the end of the
cosine, the interpolation near the end of the cycle).
"""

import math

from torch.optim.lr_scheduler import LambdaLR


def exponential_lr(optimizer, gamma, steps_per_epoch=1):
    """``LambdaLR`` scaling the optimizer's learning rate by
    gamma^(step // steps_per_epoch)."""
    steps = max(int(steps_per_epoch), 1)
    return LambdaLR(optimizer, lambda step: gamma ** (step // steps))


def piecewise_lr(optimizer, boundaries):
    """``LambdaLR`` of optax's ``piecewise_constant_schedule``: update t
    runs at the base rate times the product of the scales of every
    boundary <= t (``boundaries``: {update: scale})."""
    items = sorted(boundaries.items())

    def scale(step):
        out = 1.0
        for boundary, factor in items:
            if step >= boundary:
                out *= factor
        return out

    return LambdaLR(optimizer, scale)


def cosine_warmup_lr(optimizer, total_steps, warmup_steps=0,
                     min_factor=1e-5):
    """``LambdaLR`` of a linear warm-up over ``warmup_steps`` updates
    (factor t / warmup_steps), then a cosine from 1 down to
    ``min_factor`` at ``total_steps``, never below it."""

    def factor(step):
        if step < warmup_steps:
            return step / max(warmup_steps, 1)
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        cos = 0.5 * (1 + math.cos(math.pi * min(max(t, 0.0), 1.0)))
        return max(cos, min_factor)

    return LambdaLR(optimizer, factor)


def one_cycle_lr(optimizer, total_steps, div_factor=10.0, pct_start=0.4):
    """``LambdaLR`` of optax's ``linear_onecycle_schedule`` with the
    optimizer's rate as its peak, ``pct_final`` 1 and ``final_div_factor``
    div_factor * 1e3, as the JAX package calls it: the factor goes from
    1 / div_factor up to 1 at int(pct_start * total_steps), then down to
    1 / (div_factor * 1e3) at total_steps, linearly, and stays there."""
    # optax's boundaries {int(pct_start * T): div, int(1.0 * T): 1 / div,
    # T: 1 / final_div}: the last key overwrites the second
    bounds = (0, int(pct_start * total_steps), total_steps)
    values = (1.0 / div_factor, 1.0, 1.0 / (div_factor * 1e3))

    def factor(step):
        for b0, b1, v0, v1 in zip(bounds[:-1], bounds[1:], values[:-1],
                                  values[1:]):
            if b0 <= step < b1:
                return (v1 - v0) * ((step - b0) / (b1 - b0)) + v0
        return values[-1] if step >= bounds[-1] else 0.0

    return LambdaLR(optimizer, factor)


def bn_momentum_schedule(bn_momentum=0.5, bn_decay=0.5, decay_step=10):
    """BatchNorm momentum by epoch, in torch's convention (the weight of
    the new batch): bn_momentum * bn_decay^(epoch // decay_step), never
    below 0.01."""

    def schedule(epoch):
        return max(bn_momentum * (bn_decay**(epoch // decay_step)), 0.01)

    return schedule


__all__ = ["bn_momentum_schedule", "cosine_warmup_lr", "exponential_lr",
           "one_cycle_lr", "piecewise_lr"]
