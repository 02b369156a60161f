"""Argument checks and launch plumbing shared by the kernel wrappers."""

import functools

import torch

SMEM_LIMIT = 232_448  # bytes of shared memory one block may opt in to


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


def fits(name, shared):
    """``shared`` bytes of a kernel's block, raising unless they are in
    (0, ``SMEM_LIMIT``]."""
    if not 0 < shared <= SMEM_LIMIT:
        raise ValueError(f"{name} kernel: {shared} bytes of shared memory, "
                         f"not in (0, {SMEM_LIMIT}], what a block can have")
    return shared


@functools.cache
def sm_count(index):
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device, stream) -> the int32 tickets the split KNN kernels count
# their blocks in; every launch leaves them 0
_TICKETS = {}


def partials(groups, shape, tickets, device):
    """Scratch of a KNN kernel whose plan splits each query's candidates
    over ``groups`` blocks: the blocks' lists, int32 and float32
    [groups, *shape], and at least ``tickets`` zeros, one for each query
    group, that the kernel counts its blocks in and leaves 0 (kept per
    device and stream, so calls on one stream share them and calls on two
    never do); (None, None, None) for one group."""
    if groups == 1:
        return None, None, None
    full = (groups, *shape)
    key = (device, stream() if device.type == "cuda" else None)
    count = _TICKETS.get(key)
    if count is None or count.numel() < tickets:
        count = _TICKETS[key] = torch.zeros(tickets, dtype=torch.int32,
                                            device=device)
    return (torch.empty(full, dtype=torch.int32, device=device),
            torch.empty(full, dtype=torch.float32, device=device), count)


def ptr(t):
    """A tensor's data pointer for a C entry point, None for None."""
    return None if t is None else t.data_ptr()
