"""Profiling hooks: ``torch.profiler`` traces and per-step wall timing.

Counterpart of ``open3d_ml_tpu/utils/profiling.py``. ``trace(logdir)``
records the code it wraps with ``torch.profiler``, CPU activity and, where
a card is present, CUDA activity, and writes a TensorBoard trace
(``tensorboard_trace_handler``) into ``logdir`` when it ends;
``annotate(name)`` marks a span of it (``record_function``). ``StepTimer``
keeps host-side step statistics; CUDA work is asynchronous, so the caller
synchronises inside each step it times (``torch.cuda.synchronize()``),
as a JAX caller blocks on its result.
"""

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir, enabled=True):
    """Record a ``torch.profiler`` trace of the block into ``logdir``
    (TensorBoard's format); nothing when not ``enabled`` or no
    ``logdir``."""
    if not enabled or logdir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


@contextlib.contextmanager
def annotate(name):
    """A named span in the profiler's timeline."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Host-side step timing with summary statistics.

    Use as ``with timer.step(): ...`` around each step; ``summary()``
    gives the mean, median and p90 without the ``warmup`` first steps.
    """

    def __init__(self, warmup=2):
        self.times = []
        self.warmup = warmup

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def summary(self):
        steady = self.times[self.warmup:] or self.times
        if not steady:
            return {}
        arr = np.asarray(steady)
        return {
            "steps": len(self.times),
            "mean_s": float(arr.mean()),
            "median_s": float(np.median(arr)),
            "p90_s": float(np.percentile(arr, 90)),
            "steps_per_sec": float(1.0 / max(arr.mean(), 1e-9)),
        }

    def log(self, logger, prefix=""):
        s = self.summary()
        if s:
            logger.info(
                f"{prefix}steps/s {s['steps_per_sec']:.2f} "
                f"(median {s['median_s']*1e3:.1f} ms, "
                f"p90 {s['p90_s']*1e3:.1f} ms over {s['steps']} steps)")
