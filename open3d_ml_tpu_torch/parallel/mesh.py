"""Data parallelism over ``torch.distributed``: the process group, this
rank's rows of a global batch, and the collectives a data-parallel step
needs.

Counterpart of ``open3d_ml_tpu/parallel/mesh.py``. The JAX package runs
one program over the global batch: a mesh lays the batch over every
device and XLA adds the collectives. The port runs one process a rank
(``torchrun``), each on its share of the same global batch, and keeps
the JAX package's semantics by hand:

* every rank builds the whole global batch from the same seeded
  generators and keeps its own rows (``shard_batch``);
* while a split batch runs (``split``), BatchNorm reduces its row count,
  sums and sums of squares over the group (``all_reduce_sum``, whose
  backward all-reduces the cotangent), the losses' normalisers are summed
  over the group (``global_sum``), and the dropout draws the global
  batch's mask and keeps its rows; each rank's loss is then its share of
  the global loss;
* after the backward one all-reduce of a flat buffer sums the gradients
  (``reduce_gradients``), so every rank takes the same optimizer step.
  One collective a step, not ``DistributedDataParallel``: the step stays
  the one-process step's code (a model's forward is not wrapped), the
  sum needs no comm hook to undo DDP's mean, and the clip by value comes
  after the whole sum, as in the JAX step.

A global batch whose rows do not divide by the ranks is not split: every
rank runs all of it with no reduction, as the JAX package replicates it.

Under ``gloo`` the port's collectives on CUDA tensors (``all_reduce``,
``broadcast``) are gloo's own CUDA paths, which stage the tensors through
host memory; ``process_allgather`` pickles its objects into CPU tensors.
No collective here needs staging of its own.
"""

import contextlib
import contextvars
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

# the environment that torchrun gives each rank
RANK_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh(NamedTuple):
    """The data axis: ``size`` ranks, this process being ``rank``."""
    size: int
    rank: int


class Split(NamedTuple):
    """This rank's rows [start, stop) of a global batch of ``total``."""
    start: int
    stop: int
    total: int
    rank: int


# the split batch that the current step runs, set by ``split``
_SPLIT = contextvars.ContextVar("open3d_ml_tpu_torch_split", default=None)


def local_rank():
    """This process's rank on its host (torchrun's ``LOCAL_RANK``, 0
    without one)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(backend=None, device=None):
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; and
    ``LOCAL_RANK``) and return the ``Mesh``. ``backend`` defaults to
    ``nccl`` for a CUDA ``device`` (the default device) and ``gloo`` for
    the CPU; a CUDA rank's current device is ``device``'s index, else its
    ``LOCAL_RANK``. In a process already in a group it returns that
    group's mesh."""
    if dist.is_initialized():
        return make_mesh()
    missing = [k for k in RANK_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed: {', '.join(missing)} not set; start one "
            "process a rank with torchrun --nproc-per-node <ranks> -m "
            "open3d_ml_tpu_torch.run_pipeline ... --distributed")
    device = torch.device(device or "cuda")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else local_rank())
    env = os.environ
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
        f"{env['MASTER_PORT']}", rank=int(env["RANK"]),
        world_size=int(env["WORLD_SIZE"]))
    return make_mesh()


def make_mesh(data_parallel=None, model_parallel=1):
    """The data axis of the process group (of one rank outside a group).
    ``data_parallel`` must be None or the world size; a
    ``model_parallel`` above 1 raises: tensor parallelism is not
    ported."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor parallelism is not "
            "ported (ROADMAP queue 1 item 7)")
    on = dist.is_initialized()
    mesh = Mesh(dist.get_world_size() if on else 1,
                dist.get_rank() if on else 0)
    if data_parallel not in (None, mesh.size):
        raise ValueError(f"data_parallel={data_parallel} on {mesh.size} "
                         "ranks: the data axis spans every rank")
    return mesh


def batch_rows(n, mesh):
    """(start, stop) of this rank's rows of a global batch of ``n``, or
    None where the batch is not split: one rank, or ``n`` not a multiple
    of the ranks."""
    if mesh.size == 1 or n % mesh.size:
        return None
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def batch_sharding(mesh):
    """The placement of a batch-sharded value: ``n`` rows -> (start,
    stop) of this rank's, all of them where the batch is not split."""
    return lambda n: batch_rows(n, mesh) or (0, n)


def replicated_sharding(mesh):
    """The placement of a replicated value: every row on every rank."""
    return lambda n: (0, n)


def _is_array(v):
    return isinstance(v, (np.ndarray, torch.Tensor))


def _levels(v):
    """Whether ``v`` is a list of arrays, one a pyramid level, each with
    the batch as its first axis."""
    return isinstance(v, list) and bool(v) and _is_array(v[0])


def num_rows(data):
    """The rows of a collated batch: the first axis of its first array."""
    for v in data.values():
        if _is_array(v):
            return v.shape[0]
        if _levels(v):
            return v[0].shape[0]
    raise ValueError("a batch with no array")


def shard_batch(data, mesh):
    """This rank's rows of a collated batch ``data``: arrays and each
    level of a list of arrays sliced on their first axis, any other list
    (one entry a sample) sliced; ``data`` itself where the batch is not
    split."""
    n = num_rows(data)
    if batch_rows(n, mesh) is None:
        return data
    cut = slice(*batch_sharding(mesh)(n))
    return {k: [x[cut] for x in v] if _levels(v) else
            v[cut] if _is_array(v) or isinstance(v, list) else v
            for k, v in data.items()}


@contextlib.contextmanager
def split(mesh, n):
    """Run the block as this rank's share of a global batch of ``n``
    rows; yields whether the batch is split."""
    rows = batch_rows(n, mesh)
    token = _SPLIT.set(None if rows is None else
                       Split(*rows, n, mesh.rank))
    try:
        yield rows is not None
    finally:
        _SPLIT.reset(token)


def data_parallel_jit(fn, mesh, *, batch_argnums=(0,)):
    """``fn`` as this rank's share of a data-parallel step: the arguments
    at ``batch_argnums`` (collated host batches of the same rows) cut to
    this rank's rows (``shard_batch``), the others as given, and ``fn``
    run under ``split`` of the global rows. The name is the JAX
    package's; nothing is compiled."""
    def run(*args):
        args = list(args)
        n = num_rows(args[batch_argnums[0]])
        for i in batch_argnums:
            args[i] = shard_batch(args[i], mesh)
        with split(mesh, n):
            return fn(*args)

    return run


def current_split():
    """The ``Split`` of the batch that runs now, or None."""
    return _SPLIT.get()


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group; its backward is the sum of the cotangents
    over the group, the adjoint of every rank reading the same sum."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x):
    """``x`` summed over the group, differentiably."""
    return _AllReduceSum.apply(x)


def global_sum(x):
    """``x`` summed over the group while a split batch runs, with no
    gradient; ``x`` itself otherwise."""
    if current_split() is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def _flat_groups(tensors):
    """The tensors grouped by dtype and device, in order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def _flat_collective(tensors, collective):
    """Run ``collective`` on one flat buffer a dtype and device, then copy
    the result back into ``tensors``."""
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def reduce_gradients(parameters):
    """Sum the parameters' gradients over the group: one all-reduce of a
    flat buffer a dtype and device, after the backward. A sum, not a
    mean: each rank's loss is its share of the global loss."""
    grads = [p.grad for p in parameters if p.grad is not None]
    with torch.no_grad():
        _flat_collective(grads, dist.all_reduce)


def replicate(state_dict, mesh):
    """Broadcast ``state_dict``'s tensors from rank 0, in place; returns
    it."""
    if mesh.size > 1:
        with torch.no_grad():
            _flat_collective(list(state_dict.values()),
                             lambda flat: dist.broadcast(flat, src=0))
    return state_dict


def process_allgather(obj):
    """Each rank's ``obj``, in rank order (``all_gather_object``); ``obj``
    itself at world size 1."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh):
    """Wait for every rank (nothing at world size 1)."""
    if mesh.size > 1:
        dist.barrier()
