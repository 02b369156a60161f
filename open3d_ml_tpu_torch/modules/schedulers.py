"""Learning-rate schedules.

Counterpart of ``open3d_ml_tpu/modules/schedulers`` ``exponential_lr``: the
learning rate of update t (counted from 0) is lr * gamma^(t //
steps_per_epoch), as a ``LambdaLR`` stepped once after every optimizer step.
"""

from torch.optim.lr_scheduler import LambdaLR


def exponential_lr(optimizer, gamma, steps_per_epoch=1):
    """``LambdaLR`` scaling the optimizer's learning rate by
    gamma^(step // steps_per_epoch)."""
    steps = max(int(steps_per_epoch), 1)
    return LambdaLR(optimizer, lambda step: gamma ** (step // steps))
