"""Losses, metrics, optimizers and learning-rate schedules of the port."""

from . import losses, metrics, optimizers, schedulers

__all__ = ["losses", "metrics", "optimizers", "schedulers"]
