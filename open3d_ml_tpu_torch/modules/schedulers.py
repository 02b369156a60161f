"""Learning-rate schedules, each a ``LambdaLR`` stepped once after every
optimizer step, so that update t (counted from 0) runs at the base rate
times its factor at t.

``exponential_lr`` is the counterpart of ``open3d_ml_tpu/modules/schedulers``
``exponential_lr``: lr * gamma^(t // steps_per_epoch). ``piecewise_lr`` is
optax's ``piecewise_constant_schedule``, which PointTransformer's optimizer
runs under.
"""

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
