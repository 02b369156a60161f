"""Argument checks and launch plumbing shared by the kernel wrappers."""

import torch


def check(t, name, dtype, ndim, device):
    """Raise unless ``t`` is a contiguous ``ndim``-d ``dtype`` tensor on
    ``device``."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def route(t, family):
    """'plain' for a CPU tensor, 'kernel' for a CUDA one; any other device
    is refused, naming the ``family`` of kernels asked for."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no {family} kernel for device {t.device}")


def raise_on(err, name):
    """Raise if a C entry point returned a cudaError other than 0."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def stream():
    """The current CUDA stream, as the C entry points take it."""
    return torch.cuda.current_stream().cuda_stream
