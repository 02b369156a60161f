"""Losses, metrics and learning-rate schedules of the port."""

from . import losses, metrics, schedulers

__all__ = ["losses", "metrics", "schedulers"]
