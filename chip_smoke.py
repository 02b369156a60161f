"""Drive the PyTorch port's paths once on one CUDA card and check them.

Four paths of RandLA-Net at the shipped SemanticKITTI config and one of
SparseConvUnet at the shipped ScanNet config, with random weights drawn
from a seeded generator:

* the fused path: a batch of 4 patches of 45,056 points through the fused
  bucket pyramid and the network (``get_net``);
* training: ``SemanticSegmentation.run_train`` on synthetic lidar-like
  scenes, batches of 4 x 45,056 points through the fused path at the
  training table budget, forward and backward, with validation,
  checkpoints and a resume;
* the eval slice: one patch of 45,056 points through the exact k-NN
  pyramid and the network in float32 (``get_eval_net``);
* ``SemanticSegmentation.run_inference`` on a synthetic lidar scan of
  120,000 points, patch by patch through the eval net until every point
  is labelled;
* SparseConvUnet serving: two requests of 65,536 points (a synthetic room
  of 6 m, and the same scene at the bench's 20 m) through ``preprocess``
  -> ``transform`` -> ``DefaultBatcher`` -> the stencil forward
  (``get_net``, bf16, 39 ``stencil_conv`` launches) -> ``update_probs``;
* SparseConvUnet training: ``SemanticSegmentation.run_train`` on
  ``Custom3D`` rooms, batches of 8 x 65,536 points through the stencil
  net with the ScanNet augmentations, forward and backward (each
  convolution's backward launches ``stencil_match``, ``bucket_gather`` and,
  but for the input convolution, ``bucket_gather_bwd``), with validation,
  checkpoints and a resume.

The models are the port's ``RandLANet()`` and ``SparseConvUnet()`` at their
defaults, which equal the model sections of
``open3d_ml_tpu/configs/randlanet_semantickitti.yml`` and
``sparseconvunet_scannet.yml`` (CPU tests pin that); nothing of the JAX
package is imported.

Run from the root of the repository, with one card:

    python3 chip_smoke.py

``python3 chip_smoke.py --step-branches`` runs only that float32 training
step against the CPU, on the patches of model seeds 0-3, with the CPU on
its own branches and on the card's. ``python3 chip_smoke.py
--stencil-calls`` times only the room request's 39 stencil convolutions,
alone and inside a forward; ``python3 chip_smoke.py --knn-calls`` only
the KNN kernels' launches: the 4 ``knn_exact`` calls of an eval pyramid
and the 5 ``bucket_knn`` calls of a fused pyramid at the inference and at
the training budget. Copied into a checkout of another version of the
port, either times that version the same way.

Phases, one line each (or more), in this order:

1. device: the card's name and power limit; TF32 off for matmuls and
   convolutions.
2. build: compile the CUDA kernels from ``open3d_ml_tpu_torch/csrc``; the
   KNN kernels' registers and spill bytes, as ptxas reported them (a
   spill fails the run).
3. kernels: each kernel against its plain PyTorch version on the card, at
   its path's shapes, and both times: device time per call (CUDA events
   around back-to-back calls queued ahead of the card), and beside it the
   host-inclusive span of one call (median of CUDA-event timings).
   ``bucket_knn`` at every search of the fused pyramid (each level's
   neighbour search and level 3's pool search) at S32 and S48 and
   ``knn_exact`` at the eval pyramid's four levels, d2 bit-equal: indices
   equal off d2 ties on uniform points and row for row on lattice points
   (where the plan splits a query block's table over blocks, whose last
   to finish merges their lists, the search unsplit is checked and timed
   beside it);
   ``knn_exact`` also with a mask that leaves a sample five valid points,
   and beside it the issue floor of its float instructions and the time
   of ``torch.topk`` over ``torch.cdist`` (a yardstick, not the same
   function).
4. slice: the fused forward; the launch counts of one forward; sample 0
   against the same model on the CPU (float32: relative L2 <= 1e-4); the
   median forward time and points/s.
5. train: ``run_train`` for one epoch of 6 steps of 4 x 45,056 points and
   2 validation steps of 2 patches, on 8 + 2 synthetic scenes of 120,000
   points with the shipped class weights; the launch counts of every step;
   finite losses; a checkpoint, and a second ``run_train`` in a fresh
   pipeline that resumes from it with equal weights and Adam state; 10
   steps on one batch, whose loss must fall; one float32 step of 1 x
   11,264 points on a seeded patch against the same step on the CPU, the
   CPU taking the card's max-pool and LeakyReLU branches (relative L2
   <= 1e-4 for the gradient); the median step time, points trained per
   second, the host's share and the peak memory.
6. eval: the same as slice for the eval net at B = 1, and one forward's
   time on the card's stream split into the 4 ``knn_exact`` launches, the
   4 k = 1 searches (plain torch) and everything else.
7. inference: ``run_inference`` on the scan; its launch counts, patches,
   wall time and where it went, and points labelled per second.
8. kernels (stencil_conv): the stencil kernel against its plain version at
   five convolutions of the room request's forward (its keys and tables,
   new values and weights), after a check of the kernels' precondition
   (the keys of each batch row ascend): bit-equal on dyadic inputs at
   float32 and bf16, within the float32 summation bound of a float64
   reference on normal ones; its time, the plain version's and its bound.
   Then each of the forward's 39 convolutions timed alone, by level,
   form, K, Cin -> Cout and Q; the two heaviest, the input convolution
   (Cin 3) and the level-0 block with tables of S = 32 and 48 (2,048 and
   3,072 rows) checked as the five are; both stencil kernels bit-equal on
   synthetic rulebooks the request does not make (repeated table ids,
   all-pad segments, pad-key taps, seg 16, S 3-40, odd widths).
9. scu: the two requests served, with 39 ``stencil_conv`` launches each
   and no other kernel; their overflow counters; finite logits and
   probabilities; the card against the CPU (float32: relative L2 <= 1e-4;
   bf16 reported); on the room request the stencil path against the hash
   path on the card (gated at 1e-4 only when every counter is 0); the
   median forward, points/s, peak memory and the stencil calls' device
   time in one forward. Beside the stencil kernel, at the same shapes:
   ``stencil_match`` against its plain version (rel and found bit-equal,
   misses included; its time, the plain version's, one batched
   ``torch.searchsorted`` as the library call, and its bound; a line
   names any shape where it is slower than the library call), and the
   convolution's backward on the kernels against the same backward on the
   plain versions (dvalues and dw bit-equal on dyadic inputs at float32
   and bf16; dw within the float32 summation bound of a float64
   reference); and ``bucket_gather`` and ``bucket_gather_bwd`` as that
   backward calls them (misses reading table position 0, their
   cotangents 0) at the level-0 post conv1, the deepest block and the
   level-0 block of both requests as a batch of 2, with their
   ``torch.gather`` and ``scatter_add_`` times.
10. scu_train: ``run_train`` for one epoch of 6 steps of 8 x 65,536
   points and 2 validation steps, on 8 + 2 synthetic rooms of 6 m with
   RGB, written as ``Custom3D`` files; the launch counts of every step;
   finite losses; a checkpoint and a resumed ``run_train`` in a fresh
   pipeline with equal weights, BN statistics and Adam state; 10 steps on
   one batch, whose loss must fall; one float32 step at B = 1 on the room
   request against the CPU on the card's ReLU branches (loss within 1e-5,
   gradient and running statistics within 1e-4 relative L2); the median
   step time, points trained per second, the host's share, the peak memory
   and the device time of the backward's rulebook, gather and scatter
   calls in one step.

Every path runs with the launch counts set to 0 just before it and read
just after. Any failed check raises, so the exit code is not 0. The
second-last line is a JSON record of the kernels (each with its bound: the
larger of its bytes over 3.35 TB/s and its operations over the peak for
their type, and the time of one PyTorch call that computes the same
function where there is one; the gather's and its backward's times sum
every shape they were checked at, RandLA's and SparseConvUnet's, and a
line before names the shapes where either is slower than its library
call), the last one ``{"ok": true, "device": ...}``. There is no CPU
fallback: without CUDA the script fails first.
"""

import collections
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from open3d_ml_tpu_torch import DATASET, MODEL
from open3d_ml_tpu_torch.dataloaders import (BatchLoader, DefaultBatcher,
                                             PointCloudDataloader)
from open3d_ml_tpu_torch.datasets import SyntheticShapes
from open3d_ml_tpu_torch.datasets.synthetic import make_semseg_scene
from open3d_ml_tpu_torch.models import randlanet as trl
from open3d_ml_tpu_torch.models import sparseconvunet as tscu
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.ops import bucket as tb
from open3d_ml_tpu_torch.ops import neighbors as tn
from open3d_ml_tpu_torch.ops import sparse as tsp
from open3d_ml_tpu_torch.ops import sparse_bucket as tsb
from open3d_ml_tpu_torch.ops.cuda import _build
from open3d_ml_tpu_torch.ops.cuda import bucket as cb
from open3d_ml_tpu_torch.ops.cuda import knn as ck
from open3d_ml_tpu_torch.ops.cuda import stencil as cs
from open3d_ml_tpu_torch.ops.morton import hilbert_sort
from open3d_ml_tpu_torch.ops.voxelize import voxelize
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation

REPO = Path(__file__).resolve().parent
TPU_KERNELS = "open3d_ml_tpu/ops/pallas/bucket.py"
SEED = 0
DEVICE = "cuda"
EXPECTED_LAUNCHES = {"bucket_knn": 5, "bucket_gather": 16,
                     "bucket_gather_bwd": 0, "knn_exact": 0}
# per training step: the forward's launches, and one backward per gather
TRAIN_STEP_LAUNCHES = dict(EXPECTED_LAUNCHES, bucket_gather_bwd=16)
SCAN_POINTS = 120_000  # about one SemanticKITTI scan
# dataset and pipeline sections of
# open3d_ml_tpu/configs/randlanet_semantickitti.yml (a CPU test pins them)
SEMANTICKITTI_CLASS_WEIGHTS = [
    55437630, 320797, 541736, 2578735, 3274484, 552662, 184064, 78858,
    240942562, 17294618, 170599734, 6369672, 230413074, 101130274, 476491114,
    9833174, 129609852, 4506626, 1168181]
TRAIN_PIPELINE = {"batch_size": 4, "val_batch_size": 2,
                  "optimizer": {"lr": 0.001}, "scheduler_gamma": 0.9886,
                  "save_ckpt_freq": 5, "num_workers": 2}
COUNTERS = (cb.LAUNCHES, ck.LAUNCHES, cs.LAUNCHES)
# the H100 SXM's device memory rate and its dense peaks (NVIDIA's
# datasheet): a kernel's bound is the larger of its bytes over the rate
# and its operations over the peak for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# the H100's float32 pipes: 128 lanes an SM per clock, 132 SMs; the KNN
# kernels' issue floor is their FP32-pipe instructions per candidate
# distance over that rate at the card's top SM clock
FP32_LANES = 128 * 132
KNN_EXACT_PIPE_OPS = 8  # 3 FMUL, 3 FADD, 1 FFMA, the compare
BUCKET_KNN_PIPE_OPS = 9  # 3 FSUB, 3 FMUL, 2 FADD, the compare
# knn_exact's yardstick: torch.topk over torch.cdist, this many queries a
# call
CDIST_CHUNK = 4096
# SparseConvUnet: the room scene's extent, and the bench's scene (1,000
# voxels of 0.02 m, as bench.py sizes child_sparseconvunet's scene)
SCU_ROOM_EXTENT_M = 6.0
SCU_BENCH_EXTENT_M = 1000 * 0.02
SCU_FORWARD_LAUNCHES = 39  # stencil convolutions per 7-level forward
# per SparseConvUnet training step at 7 levels: the forward's stencil
# convolutions, and in the backward one rulebook and one gather per
# convolution and one scatter per convolution but the input one (whose
# values, voxel averages of the inputs, need no gradient)
SCU_TRAIN_STEP_LAUNCHES = {"stencil_conv": SCU_FORWARD_LAUNCHES,
                           "stencil_match": SCU_FORWARD_LAUNCHES,
                           "bucket_gather": SCU_FORWARD_LAUNCHES,
                           "bucket_gather_bwd": SCU_FORWARD_LAUNCHES - 1}
# pipeline section of open3d_ml_tpu/configs/sparseconvunet_scannet.yml (a
# CPU test pins it)
SCU_TRAIN_PIPELINE = {"batch_size": 8, "val_batch_size": 8,
                      "optimizer": {"lr": 0.001, "betas": [0.9, 0.999]},
                      "save_ckpt_freq": 5, "num_workers": 2}
SCU_TRAIN_ROOMS = {"train": 8, "val": 2}
# the stencil kernel's checks: (label, K, Cin, Cout, qblock) of five
# convolutions of the room scene's forward
STENCIL_SHAPES = (("level-0 block", 27, 32, 32, 32),
                  ("level-0 post conv1", 27, 64, 32, 32),
                  ("level-0 down", 8, 32, 64, 32),
                  ("level-0 up", 8, 64, 32, 128),
                  ("deepest block", 27, 224, 224, 32))
# the bucket gather and its backward are also checked where the stencil
# backward calls them at these two, and at the level-0 block of both
# requests as a batch of 2
SCU_BUCKET_SHAPES = ("level-0 post conv1", "deepest block")
# the level-0 block is also checked with wider tables than the config's
# S = 16: how many more taps they find, and the kernels past 32 slots
SCU_WIDE_SEGS = (32, 48)
# both stencil kernels on synthetic rulebooks that reach cases the room
# request does not: (form, seg, qblock, S), seg 16 taking the kernels'
# run-time seg and 64 the compiled one, S past 32 ordering a table in
# shared memory; every other rulebook repeats ids inside its tables
STENCIL_EDGE_CASES = (("sub", 64, 32, 16), ("sub", 64, 32, 32),
                      ("sub", 16, 32, 8), ("down", 64, 32, 16),
                      ("up", 64, 128, 16), ("up", 16, 128, 4),
                      ("sub", 64, 64, 3), ("sub", 16, 32, 40))
# their convolutions' Cin -> Cout; 3 -> 32 and 35 -> 37 take the bf16
# kernel's 4-byte copies
STENCIL_EDGE_WIDTHS = ((3, 32), (32, 32), (64, 96), (224, 224), (35, 37))


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def reset_counts():
    for counts in COUNTERS:
        for key in counts:
            counts[key] = 0


def read_counts():
    return {key: n for counts in COUNTERS for key, n in counts.items()}


def every_count(expected):
    """``expected`` with 0 for every counted kernel it does not name."""
    return dict(dict.fromkeys(read_counts(), 0), **expected)


def check_counts(phase, launches, expected):
    expected = every_count(expected)
    say(phase, f"launched {launches}; expected {expected}")
    if launches != expected:
        raise AssertionError(f"{phase}: launch counts {launches}, expected "
                             f"{expected}")


def span_ms(fn, iters=10, warmup=2):
    """Median of ``iters`` CUDA-event timings of one ``fn()``, in ms. The
    span holds the host's work in the call too (argument checks, ctypes,
    allocation), so it is not a kernel's device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters=20, warmup=2):
    """Device time of one ``fn()``, in ms: CUDA events around ``iters``
    back-to-back calls that the host queues while the card sleeps, so the
    card runs them without waiting on the host's work per call. Raises if
    the card woke before the last call was queued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 10**7  # about 5 ms at the H100's clock
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError("the host could not queue the calls ahead of the "
                         "card")


def timings(fn, plain):
    """(kernel ms, plain ms, kernel span ms, plain span ms) of two calls."""
    return device_ms(fn), device_ms(plain), span_ms(fn), span_ms(plain)


def bound(size, ops, dtype="float32"):
    """(ms of ``size`` bytes at the memory rate, ms of ``ops`` at the peak
    for ``dtype``): the least time the card could take is the larger."""
    return (size / HBM_BYTES_PER_S * 1e3,
            ops / PEAK_OPS_PER_S[dtype] * 1e3)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_record(err, ms, plain_ms, bounds, library_ms=None):
    """A kernel's entry of the closing JSON line at one shape, but for its
    name and launches; ``bounds`` as ``bound`` gives them."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bounds": bounds, "bound_ms": max(bounds),
            "library_ms": library_ms}


def combine(records):
    """Several shapes of one kernel as one entry: the largest error, the
    sums of the times and of the shapes' bounds, bound by whichever of
    bytes and operations takes the larger share of it (the library time
    only where every shape has one)."""
    lib = [r["library_ms"] for r in records]
    by_bytes = sum(r["bounds"][0] for r in records)
    by_ops = sum(r["bounds"][1] for r in records)
    return {"max_abs_err": max(r["max_abs_err"] for r in records),
            "ms": sum(r["ms"] for r in records),
            "plain_ms": sum(r["plain_ms"] for r in records),
            "bounds": (by_bytes, by_ops),
            "bound_ms": sum(r["bound_ms"] for r in records),
            "library_ms": None if None in lib else sum(lib)}


def json_entry(name, source, replaces, launches, rec):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": ("bytes" if rec["bounds"][0] >= rec["bounds"][1]
                         else "operations"),
            "library_ms": rec["library_ms"]}


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this check runs only on a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def _kernel_name(mangled):
    """knn_exact_kernel<2> for the mangled name of a kernel template."""
    m = re.search(r"([A-Za-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = [v if kind == "i" else ("false", "true")[int(v)]
            for kind, v in re.findall(r"L([ib])(\d+)E", m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_kernels(text, sources):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    kernel that ptxas reported on in ``sources``, from a build's log."""
    out, source, name, spill = [], None, None, (0, 0)
    for line in text.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif source in sources:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = _kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.append((name, int(m.group(1)), *spill))
                name = None
    return out


def phase_build():
    path, seconds = _build.build()
    _build.library()
    say("build", f"{path.relative_to(REPO)} built in {seconds:.2f} s "
        "(0 = already built)")
    log = path.with_suffix(".ptxas.txt")
    if log.exists():  # an older checkout's build keeps no report
        kernels = ptxas_kernels(log.read_text(),
                                ("knn_exact.cu", "bucket_knn.cu"))
        say("build", "KNN kernels, registers and spill store/load bytes: " +
            ", ".join(f"{name} {regs} regs {st}/{ld} B"
                      for name, regs, st, ld in kernels))
        if any(st or ld for _, _, st, ld in kernels):
            raise AssertionError("a KNN kernel spills registers")


def _sm_clock_hz():
    """The card's top SM clock, as nvidia-smi reads it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], check=True, capture_output=True, text=True,
        timeout=60).stdout.split()[0]
    return float(mhz) * 1e6


def issue_floor_ms(pairs, ops):
    """The least time ``pairs`` candidate distances of ``ops`` FP32-pipe
    instructions each take at the card's top clock."""
    return pairs * ops / (FP32_LANES * _sm_clock_hz()) * 1e3


def _captured(module, name, fn):
    """The (args, kwargs) of each call that ``fn()`` makes to
    ``module.name``; the calls still run."""
    calls = []
    real = getattr(module, name)

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, record)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return calls


def lattice_points(b, n, seed):
    """[b, n, 3] distinct points of the 1/32 grid in [-4, 4)^3 on the card:
    every d2 is exact in float32 and repeats many times, so the kernels'
    tie order shows."""
    rng = np.random.default_rng(seed)
    v = np.stack([rng.choice(256 ** 3, n, replace=False) for _ in range(b)])
    grid = np.stack([v % 256, (v // 256) % 256, v // 65536], -1)
    return torch.from_numpy((grid / 32.0 - 4.0).astype(np.float32)).to(DEVICE)


def fused_searches(points, model_cfg, num_segs, gather_segs):
    """The bucket_knn calls of one fused pyramid on ``points`` [B, N, 3]
    (``build_bucket_pyramid`` as the net builds it), each as (label, args,
    kwargs): every level's neighbour search and, where a level's points
    are no whole number of query blocks, its pool search, which reuses the
    neighbour search's table."""
    calls = _captured(tb, "knn_bucket", lambda: tb.build_bucket_pyramid(
        points, model_cfg.num_neighbors, model_cfg.sub_sampling_ratio,
        seg=model_cfg.seg, qblock=model_cfg.block, num_segs=num_segs,
        gather_segs=gather_segs))
    out, level = [], -1
    for i, (args, kwargs) in enumerate(calls):
        pool = i > 0 and args[0] is calls[i - 1][0][0]
        level += not pool
        out.append((f"level-{level} {'pool' if pool else 'neighbour'}", args,
                    kwargs))
    return out


def _differ_only_at_ties(name, got, want, d2):
    """Raise unless the index rows ``got`` and ``want`` differ only at
    entries whose d2 ties with a neighbour in the row; returns the mask of
    rows that differ."""
    rows = (got != want).any(-1)
    if rows.any():
        pair = d2[..., 1:] == d2[..., :-1]
        edge = torch.zeros_like(pair[..., :1])
        tied = torch.cat([edge, pair], -1) | torch.cat([pair, edge], -1)
        if ((got != want) & ~tied).any():
            raise AssertionError(f"{name}: indices differ off a d2 tie")
    return rows


def _unsplit(fn):
    """``fn()`` with every bucket_knn call planned for a card of one SM,
    which splits no query block's table over blocks."""
    real = cb.knn_bucket_plan
    cb.knn_bucket_plan = lambda *args, sms: real(*args, sms=1)
    try:
        return fn()
    finally:
        cb.knn_bucket_plan = real


def _knn_check(label, pcp, queries, sids, k, *, seg, qblock, lattice=False):
    """bucket_knn against its plain version on one search: d2 bit-equal;
    rel equal row for row on lattice points, else off d2 ties only. On
    lattice points only checks; else returns its record (error: max |d2
    difference|). Bound: the points, queries and tables read and the
    [B, Q, k] outputs written; 8 float32 operations for each candidate
    distance. Where the plan splits a query block's table over blocks,
    the same search unsplit is checked and timed beside it."""
    rel_k, d2_k = cb.knn_bucket(pcp, queries, sids, k, seg=seg, qblock=qblock)
    rel_p, d2_p = cb.knn_bucket_plain(pcp, queries, sids, k, seg=seg,
                                      qblock=qblock)
    torch.cuda.synchronize()
    b, q, _ = queries.shape
    name = (f"bucket_knn {label} B={b} Q={q} S={sids.shape[-1]} seg={seg} "
            f"qblock={qblock} k={k}")
    if not torch.equal(d2_k.view(torch.int32), d2_p.view(torch.int32)):
        raise AssertionError(f"{name}: d2 differs from the plain version")
    if lattice:
        if not torch.equal(rel_k, rel_p):
            raise AssertionError(f"{name}, lattice: rel differs from the "
                                 "plain version")
        return None
    rows = _differ_only_at_ties(name, rel_k, rel_p, d2_p)
    err = (d2_k - d2_p).abs().max().item()
    ms, plain_ms, span, plain_span = timings(
        lambda: cb.knn_bucket(pcp, queries, sids, k, seg=seg, qblock=qblock),
        lambda: cb.knn_bucket_plain(pcp, queries, sids, k, seg=seg,
                                    qblock=qblock))
    pairs = b * q * sids.shape[-1] * seg
    bounds = bound(nbytes(pcp, queries, sids) + b * q * k * 8, pairs * 8)
    floor = issue_floor_ms(pairs, BUCKET_KNN_PIPE_OPS)
    groups = cb.knn_bucket_plan(b, q, sids.shape[-1], seg, qblock,
                                sms=cb.sm_count(pcp.device.index))["groups"]
    split = ""
    if groups > 1:
        one = _unsplit(lambda: cb.knn_bucket(pcp, queries, sids, k, seg=seg,
                                             qblock=qblock))
        if not torch.equal(one[1].view(torch.int32), d2_k.view(torch.int32)):
            raise AssertionError(f"{name}: the unsplit search's d2 differs")
        one_ms = _unsplit(lambda: device_ms(lambda: cb.knn_bucket(
            pcp, queries, sids, k, seg=seg, qblock=qblock)))
        split = (f"; each query block's table split over {groups} blocks, "
                 f"unsplit {one_ms:.4f} (d2 bit-equal)")
    say("kernels", f"{name}: rel equal on {int((~rows).sum())}/{rows.numel()}"
        f" rows ({int(rows.sum())} differ at d2 ties), d2 bit-equal; device "
        f"ms: kernel {ms:.4f}, plain {plain_ms:.4f}, bound {max(bounds):.4f},"
        f" issue floor {floor:.4f}{split}; call span ms: kernel {span:.4f}, "
        f"plain {plain_span:.4f}")
    return kernel_record(err, ms, plain_ms, bounds)


def _knn_levels(model_cfg, pts, lattice):
    """bucket_knn at every search of the fused pyramid, at the inference
    and the training budget, on ``pts`` and (checks only) on ``lattice``;
    returns the records of the level-0 search at the inference budget and
    of each budget's searches in all."""
    seg, qblock = model_cfg.seg, model_cfg.block
    out = {}
    for num_segs, gather_segs in (
            (model_cfg.infer_num_segs, model_cfg.infer_gather_segs),
            (model_cfg.num_segs, model_cfg.gather_segs)):
        for label, args, kwargs in fused_searches(lattice, model_cfg,
                                                  num_segs, gather_segs):
            _knn_check(label, *args, **kwargs, lattice=True)
        say("kernels", f"bucket_knn S{num_segs}, lattice points: every search"
            " of the fused pyramid bit-equal, rel row for row")
        recs = [_knn_check(label, *args, **kwargs) for label, args, kwargs in
                fused_searches(pts, model_cfg, num_segs, gather_segs)]
        out[num_segs] = recs
        total = combine(recs)
        say("kernels", f"bucket_knn S{num_segs}, the fused pyramid's "
            f"{len(recs)} searches: device ms kernel {total['ms']:.4f}, plain "
            f"{total['plain_ms']:.4f}, bound {total['bound_ms']:.4f} in all "
            f"(level 0: kernel {recs[0]['ms']:.4f}, bound "
            f"{recs[0]['bound_ms']:.4f})")
    return out[model_cfg.infer_num_segs][0]


def _gather_check(label, values, seg_ids, rel, seg, qblock):
    """bucket_gather against its plain version, rounding off and on;
    returns its record with rounding on. Bound: the values and tables
    read once, the [B, Q, K, C] output written. Library call:
    ``torch.gather`` of the same rows, their indices computed ahead."""
    b, q, k = rel.shape
    c = values.shape[2]
    rows = cb._bucket_rows(seg_ids, rel, seg=seg, qblock=qblock)
    idx = rows.reshape(b, -1, 1).expand(-1, -1, c)
    library_ms = device_ms(lambda: torch.gather(values, 1, idx))
    bounds = bound(nbytes(values, seg_ids, rel) + b * q * k * c * 4, 0)
    out = {}
    for round_bf16 in (False, True):
        kw = dict(seg=seg, qblock=qblock, round_bf16=round_bf16)
        got = cb.gather_bucket(values, seg_ids, rel, **kw)
        ref = cb.gather_bucket_plain(values, seg_ids, rel, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"bucket_gather {label} round_bf16="
                                 f"{round_bf16}: differs from the plain "
                                 "version")
        ms, plain_ms, span, plain_span = timings(
            lambda: cb.gather_bucket(values, seg_ids, rel, **kw),
            lambda: cb.gather_bucket_plain(values, seg_ids, rel, **kw))
        say("kernels", f"bucket_gather {label} B={rel.shape[0]} "
            f"Q={rel.shape[1]} K={rel.shape[2]} C={values.shape[2]} "
            f"S={seg_ids.shape[-1]} qblock={qblock} round_bf16={round_bf16}:"
            f" equal; device ms: kernel {ms:.4f}, plain {plain_ms:.4f}; call "
            f"span ms: kernel {span:.4f}, plain {plain_span:.4f}; "
            f"torch.gather {library_ms:.4f}; bound {bounds[0]:.4f} (bytes)")
        out[round_bf16] = kernel_record(
            (got - ref).abs().max().item(), ms, plain_ms, bounds, library_ms)
    return out[True]


def _gather_bwd_check(label, seg_ids, rel, npad, c, seg, qblock, gen,
                      mask=None):
    """bucket_gather_bwd against its plain version at one shape, rounding
    off and on: bit-equal on dyadic cotangents (integers in [-4096, 4096]
    over 64, whose sums are exact in float32 in any order), and on random
    normal ones within the bound of float32 summation in any order,
    |err| <= n * 2^-24 * sum |g| over a row's n readers, of a float64
    reference. Cotangent rows where the [B, Q, K] ``mask`` is False are 0,
    as ``stencil_conv_bwd`` masks its misses. Returns its record with
    rounding on (error on normal cotangents). Bound: the cotangents and
    tables read, the [B, npad, C] gradient written, one float32 add per
    cotangent value. Library call: ``scatter_add_`` of the same rows, their
    indices computed ahead."""
    dev = rel.device
    shape = (*rel.shape, c)
    rows = cb._bucket_rows(seg_ids, rel, seg=seg, qblock=qblock)
    idx = rows.reshape(rel.shape[0], -1, 1).expand(-1, -1, c)
    dyadic = torch.randint(-4096, 4097, shape, generator=gen,
                           device=dev).float() / 64
    normal = torch.randn(shape, generator=gen, device=dev)
    if mask is not None:
        dyadic = dyadic * mask[..., None]
        normal = normal * mask[..., None]
    readers = cb.gather_bucket_bwd_plain(
        torch.ones(shape, dtype=torch.float64, device=dev), seg_ids, rel,
        npad, seg=seg, qblock=qblock, round_bf16=False)
    bounds = bound(nbytes(normal, seg_ids, rel) + rel.shape[0] * npad * c * 4,
                   normal.numel())
    out = {}
    for round_bf16 in (False, True):
        kw = dict(seg=seg, qblock=qblock, round_bf16=round_bf16)
        got = cb.gather_bucket_bwd(dyadic, seg_ids, rel, npad, **kw)
        ref = cb.gather_bucket_bwd_plain(dyadic, seg_ids, rel, npad, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"bucket_gather_bwd {label} round_bf16="
                                 f"{round_bf16}: differs from the plain "
                                 "version on dyadic cotangents")
        g = normal.bfloat16().float() if round_bf16 else normal
        got = cb.gather_bucket_bwd(normal, seg_ids, rel, npad, **kw)
        ref64 = cb.gather_bucket_bwd_plain(g.double(), seg_ids, rel, npad,
                                           seg=seg, qblock=qblock,
                                           round_bf16=False)
        abs_sum = cb.gather_bucket_bwd_plain(g.double().abs(), seg_ids, rel,
                                             npad, seg=seg, qblock=qblock,
                                             round_bf16=False)
        err = (got.double() - ref64).abs()
        limit = readers * 2.0 ** -24 * abs_sum
        if (err > limit).any():
            raise AssertionError(f"bucket_gather_bwd {label} round_bf16="
                                 f"{round_bf16}: error past the float32 "
                                 "summation bound on normal cotangents")
        ms, plain_ms, span, plain_span = timings(
            lambda: cb.gather_bucket_bwd(normal, seg_ids, rel, npad, **kw),
            lambda: cb.gather_bucket_bwd_plain(normal, seg_ids, rel, npad,
                                               **kw))
        say("kernels", f"bucket_gather_bwd {label} B={rel.shape[0]} "
            f"Q={rel.shape[1]} K={rel.shape[2]} C={c} npad={npad} "
            f"S={seg_ids.shape[-1]} qblock={qblock} round_bf16={round_bf16}:"
            f" equal on dyadic cotangents; normal: max |err| "
            f"{err.max().item():.3e} vs float64, within n * 2^-24 * sum|g| "
            f"(max readers per row {int(readers.max().item())}); device ms: "
            f"kernel {ms:.4f}, plain {plain_ms:.4f}; call span ms: kernel "
            f"{span:.4f}, plain {plain_span:.4f}; bound {max(bounds):.4f} "
            "(bytes)")
        out[round_bf16] = kernel_record(err.max().item(), ms, plain_ms,
                                        bounds)
    dv = torch.zeros((rel.shape[0], npad, c), device=dev)
    rows_g = normal.reshape(rel.shape[0], -1, c)
    out[True]["library_ms"] = device_ms(lambda: dv.scatter_add_(1, idx,
                                                                rows_g))
    say("kernels", f"bucket_gather_bwd {label}: scatter_add_ device ms "
        f"{out[True]['library_ms']:.4f}")
    return out[True]


def phase_kernels(model_cfg):
    """The kernels against their plain versions at the main paths' shapes:
    every search of the fused pyramid at the inference and the training
    budget, on uniform and on lattice points; one
    neighbour, pool and upsample gather from the inference pyramid of the
    same batch and the level-0 neighbour gather from its training pyramid;
    the gather backward at four shapes of the training step. Returns the
    search's record and the (label, record) pairs of the gather and of its
    backward."""
    dev = torch.device(DEVICE)
    b, n = 4, model_cfg.num_points
    seg, qblock = model_cfg.seg, model_cfg.block
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((b, n, 3), generator=gen, device=dev) * 50 - 25
    knn = _knn_levels(model_cfg, pts, lattice_points(b, n, SEED))

    pyr = tb.build_bucket_pyramid(
        pts, model_cfg.num_neighbors, model_cfg.sub_sampling_ratio, seg=seg,
        qblock=qblock, num_segs=model_cfg.infer_num_segs,
        gather_segs=model_cfg.infer_gather_segs)
    train_pyr = tb.build_bucket_pyramid(
        pts, model_cfg.num_neighbors, model_cfg.sub_sampling_ratio, seg=seg,
        qblock=qblock, num_segs=model_cfg.num_segs,
        gather_segs=model_cfg.gather_segs)

    def values(rows, c):
        return tb.pad_seg(torch.randn((b, rows, c), generator=gen,
                                      device=dev), seg)

    def tables(p, name, level):
        return (p[f"{name}_seg_ids"][level], p[f"{name}_rel"][level], seg,
                p[f"{name}_qblock"][level])

    n1, n3 = (pyr["coords"][i].shape[1] for i in (1, 3))
    # level 1's first neighbour gather (3 coords + 32 features), its pool
    # gather (2 * 64 channels) and the decoder's first upsample (level 4's
    # 2 * 256 channels onto level 3)
    gathers = [
        (f"RandLA level-{level} {label}",
         _gather_check(label, values(rows, c), *tables(pyr, name, level)))
        for label, level, name, rows, c in (
            ("neighbour", 1, "nbr", n1, 35), ("pool", 1, "pool", n1, 128),
            ("upsample", 3, "up", n3 // 4, 512))]
    # the sum over these three shapes, printed on its own for comparison
    gather = combine([rec for _, rec in gathers])
    say("kernels", f"bucket_gather, three shapes at round_bf16=True: device "
        f"ms: kernel {gather['ms']:.4f}, plain {gather['plain_ms']:.4f}, "
        f"torch.gather {gather['library_ms']:.4f}, bound "
        f"{gather['bound_ms']:.4f} in all")
    gathers.append(("RandLA training level-0 neighbour", _gather_check(
        "training level-0 neighbour", values(n, 11),
        *tables(train_pyr, "nbr", 0))))

    # the largest gather of a training step (3 coords + 8 features at level
    # 0) and the three shapes above, at the training budget
    bwds = []
    for label, name, level, rows, c in (
            ("level-0 neighbour", "nbr", 0, n, 11),
            ("level-1 neighbour", "nbr", 1, n1, 35),
            ("level-1 pool", "pool", 1, n1, 128),
            ("level-3 upsample", "up", 3, n3 // 4, 512)):
        sids, rel, _, qb = tables(train_pyr, name, level)
        bwds.append((f"RandLA training {label}", _gather_bwd_check(
            label, sids, rel, -(-rows // seg) * seg, c, seg, qb, gen)))
    # the sum over these four shapes, printed on its own for comparison
    bwd = combine([rec for _, rec in bwds])
    say("kernels", f"bucket_gather_bwd, four shapes at round_bf16=True: "
        f"device ms: kernel {bwd['ms']:.4f}, plain {bwd['plain_ms']:.4f}, "
        f"scatter_add_ {bwd['library_ms']:.4f}, bound "
        f"{bwd['bound_ms']:.4f} in all")
    return knn, gathers, bwds


def bucket_summary(name, records, library):
    """One kernel's (label, record) pairs at every checked shape as one
    entry of the closing JSON line, and a line that names the shapes where
    the kernel is slower than its library call."""
    rec = combine([r for _, r in records])
    slower = [f"{label} ({r['ms']:.4f} vs {r['library_ms']:.4f})"
              for label, r in records if r["ms"] > r["library_ms"]]
    say("kernels", f"{name}, {len(records)} shapes at round_bf16=True: "
        f"device ms: kernel {rec['ms']:.4f}, plain {rec['plain_ms']:.4f}, "
        f"{library} {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} in "
        f"all; kernel / {library} by shape: " +
        ", ".join(f"{label} {r['ms'] / r['library_ms']:.3f}"
                  for label, r in records) +
        f"; share of bound: {rec['bound_ms'] / rec['ms']:.1%} in all; "
        f"slower than {library} at: {'; '.join(slower) or 'no shape'}")
    return rec


def _cdist_topk(points, queries, k):
    """knn_exact's yardstick, not the same function (its distances are
    square roots of another formula, so its rounding and ties differ):
    ``torch.topk(torch.cdist(q, p), k, largest=False)`` over chunks of
    ``CDIST_CHUNK`` queries."""
    return [torch.topk(torch.cdist(queries[:, s:s + CDIST_CHUNK], points), k,
                       largest=False)
            for s in range(0, queries.shape[1], CDIST_CHUNK)]


def _exact_equal(name, got, want, rows_equal):
    """Raise unless knn_exact's (idx, d2) has the plain version's d2 bit for
    bit and its indices row for row (``rows_equal``) or off d2 ties;
    returns the mask of rows that differ."""
    torch.cuda.synchronize()
    if not torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)):
        raise AssertionError(f"{name}: d2 differs from the plain version")
    if rows_equal and not torch.equal(got[0], want[0]):
        raise AssertionError(f"{name}: indices differ from the plain "
                             "version")
    return _differ_only_at_ties(name, got[0], want[0], want[1])


def phase_knn_exact(model_cfg):
    """knn_exact against its plain version at every level of the eval
    pyramid (one sample, queries = points, 45,056 / 11,264 / 2,816 / 704):
    on seeded uniform points d2 bit-equal and indices equal off d2 ties,
    on lattice points indices row for row; at level 2 with a mask that
    leaves one sample of a batch of 2 five valid points (the masked ones
    follow them in index order). Returns its record at level 0 (error: max
    |d2 difference| over the levels). The plain version's time is its call
    span: it launches about 18 kernels per block of queries, more than the
    host can queue ahead while the card sleeps. Bound: points and queries
    read, [1, N, k] outputs written, 8 float32 operations per candidate
    distance; beside it the issue floor of the kernel's 8 FP32-pipe
    instructions a distance, and the call span of the chunked
    ``torch.cdist`` + ``topk`` yardstick (its kernels cannot all be queued
    ahead of the card)."""
    dev = torch.device(DEVICE)
    k = model_cfg.num_neighbors
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((1, model_cfg.num_points, 3), generator=gen,
                     device=dev) * 50 - 25
    out = []
    for level in range(model_cfg.num_layers):
        n = pts.shape[1] // 4 ** level
        sub = pts[:, :n].contiguous()
        got = ck.knn_exact(sub, sub, k)
        want = ck.knn_exact_plain(sub, sub, k)
        rows = _exact_equal(f"knn_exact level {level}", got, want, False)
        lat = lattice_points(1, n, SEED + level)
        _exact_equal(f"knn_exact level {level} lattice", ck.knn_exact(
            lat, lat, k), ck.knn_exact_plain(lat, lat, k), True)
        note = ""
        if level == 1:
            # the plain version on the CPU gives the same bits
            idx_c, d2_c = ck.knn_exact_plain(sub.cpu(), sub.cpu(), k)
            if not torch.equal(d2_c.view(torch.int32),
                               got[1].cpu().view(torch.int32)):
                raise AssertionError("knn_exact: card d2 differs from the "
                                     "CPU's")
            crows = _differ_only_at_ties("knn_exact CPU", got[0].cpu(), idx_c,
                                         d2_c)
            note = (f"; against the CPU's plain version: d2 bit-equal, "
                    f"indices differ on {int(crows.sum())} rows at d2 ties")
        if level == 2:
            both = lattice_points(2, n, SEED)
            mask = torch.rand((2, n), generator=gen, device=dev) < 0.6
            mask[1] = False
            mask[1, torch.randperm(n, generator=gen, device=dev)[:5]] = True
            want_m = ck.knn_exact_plain(both, both, k, points_mask=mask)
            _exact_equal("knn_exact masked", ck.knn_exact(
                both, both, k, points_mask=mask), want_m, True)
            if not (mask[1][want_m[0][1].long()].sum(-1) == 5).all():
                raise AssertionError("knn_exact masked: not 5 valid first")
            note += ("; B=2 with 5 valid points in sample 1: equal row for "
                     "row, the masked points after the valid ones")
        ms = device_ms(lambda: ck.knn_exact(sub, sub, k))
        span = span_ms(lambda: ck.knn_exact(sub, sub, k))
        plain_span = span_ms(lambda: ck.knn_exact_plain(sub, sub, k),
                             iters=5, warmup=1)
        cdist_ms = span_ms(lambda: _cdist_topk(sub, sub, k), iters=3,
                           warmup=1)
        bounds = bound(2 * nbytes(sub) + n * k * 8, n * n * 8)
        floor = issue_floor_ms(n * n, KNN_EXACT_PIPE_OPS)
        plan = ck.exact_plan(1, n, n, sms=ck.sm_count(dev.index))
        say("kernels", f"knn_exact level {level} B=1 N=Q={n} k={k} (plan "
            f"{plan}): d2 bit-equal, indices equal on {int((~rows).sum())}/"
            f"{rows.numel()} rows ({int(rows.sum())} differ at d2 ties), "
            f"lattice row for row{note}; device ms: kernel {ms:.4f}, bound "
            f"{max(bounds):.4f}, issue floor {floor:.4f}; call span ms: "
            f"kernel {span:.4f}, plain {plain_span:.4f}, torch.cdist + topk "
            f"{cdist_ms:.4f} (not the same function)")
        out.append(dict(kernel_record(
            (got[1] - want[1]).abs().max().item(), ms, plain_span, bounds),
            floor=floor, cdist_ms=cdist_ms))
    say("kernels", "knn_exact, the eval pyramid's four levels: device ms "
        f"kernel {sum(r['ms'] for r in out):.4f}, bound "
        f"{sum(r['bound_ms'] for r in out):.4f}, issue floor "
        f"{sum(r['floor'] for r in out):.4f}; call span ms: plain "
        f"{sum(r['plain_ms'] for r in out):.4f}, torch.cdist + topk "
        f"{sum(r['cdist_ms'] for r in out):.4f}")
    return dict(out[0], max_abs_err=max(r["max_abs_err"] for r in out))


def random_weights(net, seed):
    """Seeded random weights, with BN statistics that are not the
    identity: a Linear weight [out, in] scaled by 1 / sqrt(in), a stencil
    weight [K, Cin, Cout] by 1 / sqrt(K * Cin)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** .5)
            elif p.dim() == 3:
                p.copy_(torch.randn(p.shape, generator=gen) /
                        (p.shape[0] * p.shape[1]) ** .5)
            elif name.endswith("weight"):  # BatchNorm scales
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.2)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return net


def _compare(gpu, cpu):
    gpu = gpu.double().cpu()
    cpu = cpu.double()
    rel_l2 = ((gpu - cpu).norm() / cpu.norm()).item()
    agree = (gpu.argmax(-1) == cpu.argmax(-1)).double().mean().item()
    return rel_l2, agree


def median_forward_s(net, batch, runs=10, warmup=3):
    """Median synchronised forward time, in seconds, and all the times."""
    times = []
    with torch.no_grad():
        for i in range(warmup + runs):
            t0 = time.perf_counter()
            net(batch)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def phase_slice(model, card):
    dev = torch.device(DEVICE)
    model_cfg = model.cfg
    net = model.get_net()
    state = random_weights(net, SEED).state_dict()
    net = net.eval().to(dev)
    rng = np.random.default_rng(0)
    b, n = 4, model_cfg.num_points
    coords = rng.uniform(-25, 25, (b, n, 3)).astype(np.float32)
    feats = rng.uniform(-25, 25, (b, n, 3)).astype(np.float32)
    batch_cpu = {"coords": torch.from_numpy(coords),
                 "features": torch.from_numpy(feats)}
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}

    with torch.no_grad():
        net(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logits = net(batch)
        torch.cuda.synchronize()
        launches = read_counts()
    check_counts("slice", launches, EXPECTED_LAUNCHES)
    if tuple(logits.shape) != (b, n, model_cfg.num_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    say("slice", f"logits {tuple(logits.shape)} finite; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # sample 0 against the same model on the CPU (plain versions; eval BN
    # does not depend on the batch)
    sample0 = {k: v[:1] for k, v in batch_cpu.items()}
    for dtype in ("float32", model_cfg.compute_dtype):
        variant = type(model)(**dict(model_cfg.to_dict(),
                                     compute_dtype=dtype))
        cpu_net = variant.get_net()
        cpu_net.load_state_dict(state)
        cpu_net.eval()
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = cpu_net(sample0)[0]
            cpu_s = time.perf_counter() - t0
            if dtype == model_cfg.compute_dtype:
                gpu = logits[0]
            else:
                gpu_net = variant.get_net()
                gpu_net.load_state_dict(state)
                gpu = gpu_net.eval().to(dev)(batch)[0]
        rel_l2, agree = _compare(gpu, ref)
        say("slice", f"sample 0, compute_dtype={dtype}: card vs CPU relative "
            f"L2 {rel_l2:.3e}, argmax agreement {agree:.6f} (CPU forward "
            f"{cpu_s:.1f} s)")
        if dtype == "float32" and not rel_l2 <= 1e-4:
            raise AssertionError(f"float32 relative L2 {rel_l2} > 1e-4")

    fwd, times = median_forward_s(net, batch)
    say("slice", f"forward B={b} N={n} compute_dtype="
        f"{model_cfg.compute_dtype}: median {fwd * 1e3:.2f} ms over "
        f"{len(times)} runs (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}), {b * n / fwd:.0f} points/s on {card}")
    return launches


class _FixedDropout(torch.nn.Module):
    """Dropout with a given keep mask, so that two nets drop the same
    elements."""

    def __init__(self, keep):
        super().__init__()
        self.keep = keep

    def forward(self, x):
        if not self.training:
            return x
        return torch.where(self.keep.to(x.device), x * 2.0,
                           torch.zeros_like(x))


def _instrument(pipeline, record):
    """Wrap the pipeline's train and eval steps: each call appends (kind,
    start, end, launch counts, loss) to ``record``, its end taken after a
    synchronise."""
    for kind, name in (("train", "_train_step"), ("eval", "_eval_step")):
        fn = getattr(pipeline, name)

        def wrapper(inputs, loss_fn, fn=fn, kind=kind):
            before = read_counts()
            t0 = time.perf_counter()
            loss, cm = fn(inputs, loss_fn)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after = read_counts()
            record.append((kind, t0, t1,
                           {k: after[k] - before[k] for k in after},
                           float(loss)))
            return loss, cm

        setattr(pipeline, name, wrapper)


def _train_dataset(root):
    """8 training and 2 validation scenes of 120,000 points, 24 and 4
    patches an epoch (6 and 2 steps), the preprocess cached under
    ``root``."""
    return SyntheticShapes(
        num_points_per_cloud=SCAN_POINTS,
        num_clouds={"training": 8, "validation": 2, "test": 1},
        use_cache=True, cache_dir=str(root / "cache"),
        test_result_folder=str(root / "test"), seed=SEED,
        steps_per_epoch_train=24, steps_per_epoch_valid=4,
        class_weights=SEMANTICKITTI_CLASS_WEIGHTS)


def _check_steps(record, first, last, train=TRAIN_STEP_LAUNCHES,
                 valid=EXPECTED_LAUNCHES):
    """Launch counts (``train`` per train step, ``valid`` per validation
    step) and finite losses of every step in record[first:last]; returns
    the train steps' times (s)."""
    train_s = []
    for kind, t0, t1, launches, loss in record[first:last]:
        expected = every_count(train if kind == "train" else valid)
        if launches != expected:
            raise AssertionError(f"train: a {kind} step launched {launches}, "
                                 f"expected {expected}")
        if not np.isfinite(loss):
            raise AssertionError(f"train: a {kind} step's loss is {loss}")
        if kind == "train":
            train_s.append(t1 - t0)
    return train_s


def _resume_check(pipeline, saved):
    """Make ``pipeline.load_ckpt`` check, right after loading, that the net
    and the Adam state equal ``saved`` (the first run's at its end); the
    epoch it returns goes into ``saved["first_epoch"]``."""
    load = pipeline.load_ckpt

    def checked(*args, **kwargs):
        epoch = load(*args, **kwargs)
        for key, value in pipeline.net.state_dict().items():
            if not torch.equal(value, saved["model"][key]):
                raise AssertionError(f"resume: {key} differs from the saved "
                                     "weights")
        state = pipeline.optimizer.state_dict()["state"]
        if set(state) != set(saved["adam"]):
            raise AssertionError("resume: Adam state for other parameters")
        for idx, moments in saved["adam"].items():
            for name in ("step", "exp_avg", "exp_avg_sq"):
                # the step count lives on the CPU, the moments on the card
                if not torch.equal(state[idx][name].cpu(),
                                   moments[name].cpu()):
                    raise AssertionError(f"resume: Adam {name} of parameter "
                                         f"{idx} differs")
        saved["first_epoch"] = epoch
        return epoch

    pipeline.load_ckpt = checked


def _overfit(pipeline, dataset, batch_size=4):
    """10 training steps on one fixed batch of the train split; returns the
    losses."""
    model = pipeline.model
    split = dataset.get_split("train")
    loader = PointCloudDataloader(split, preprocess=model.preprocess,
                                  transform=model.transform,
                                  sampler=split.sampler, use_cache=True)
    model.trans_point_sampler = split.sampler.get_point_sampler()
    batch = next(iter(BatchLoader(loader, batch_size, DefaultBatcher(),
                                  num_workers=0, sampler=split.sampler)))
    inputs = pipeline._device_batch(batch)
    loss_fn = SemSegLoss(pipeline, model, dataset)
    return [float(pipeline._train_step(inputs, loss_fn)[0])
            for _ in range(10)]


def _rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


class _SameBranches:
    """Make two runs of the fused net take the same branches.

    The training step's gradient is not continuous in its inputs: each max
    pool hands its gradient to its largest neighbour, and each LeakyReLU
    passes it whole or times its slope. Where two neighbours nearly tie,
    or a LeakyReLU's input is nearly 0, float32 rounding alone picks the
    branch, and a branch taken otherwise moves the gradient of every layer
    before it: on some patches far more than the card's and the CPU's
    float32 sums differ (``--step-branches`` measures it).

    While it is entered, the fused net's pools gather the neighbour that
    ``argmax`` picks and its LeakyReLUs apply a sign mask (with ``net``
    "scu": SparseConvUnet's ReLUs, whose inputs near 0 after BatchNorm
    route the gradient the same way): the first run records its choices,
    the run after ``replay()`` takes them and counts in ``differ`` the
    choices its own values would have made otherwise. Like the fixed
    dropout mask, this gives both runs one function. With ``active`` false
    it changes nothing."""

    def __init__(self, active=True, net="randla"):
        self.active = active
        self.module = trl if net == "randla" else tscu
        self.recorded, self.replaying, self.differ = [], False, 0
        self.total = 0  # choices recorded

    def replay(self):
        self.total = sum(c.numel() for c in self.recorded)
        if self.active and not self.total:
            raise AssertionError("train: the step took no branch through "
                                 "_SameBranches")
        self.replaying = True

    def _choose(self, own):
        if not self.replaying:
            self.recorded.append(own)
            return own
        want = self.recorded.pop(0).to(own.device)
        self.differ += int((want != own).sum())
        return want

    def __enter__(self):
        if not self.active:
            return self
        choose = self._choose

        def pool_max(level, v):
            rows = level._gather(v, "pool")
            pick = choose(rows.argmax(dim=-2, keepdim=True))
            return torch.gather(rows, -2, pick).squeeze(-2)

        class Functional:
            """``torch.nn.functional`` with a LeakyReLU and a ReLU of
            chosen signs."""

            def __getattr__(self, name):
                return getattr(torch.nn.functional, name)

            @staticmethod
            def leaky_relu(x, slope=0.01):
                return torch.where(choose(x > 0), x, x * slope)

            @staticmethod
            def relu(x):
                return torch.where(choose(x > 0), x, 0.0)

        self._saved = trl._BucketLevel.pool_max, self.module.F
        self.module.F = Functional()
        if self.module is trl:
            trl._BucketLevel.pool_max = pool_max
        return self

    def __exit__(self, *exc):
        if self.active:
            trl._BucketLevel.pool_max, self.module.F = self._saved


def _step_model_and_batch(dataset, n=11_264, seed=SEED):
    """The float32 model of the card-vs-CPU step and its one patch of ``n``
    points from the first training cloud. The model is seeded, so the
    patch (its crop and augmentation) is the same in every run."""
    model = MODEL.get("RandLANet")(compute_dtype="float32", num_points=n,
                                   seed=seed)
    split = dataset.get_split("train")
    loader = PointCloudDataloader(split, preprocess=model.preprocess,
                                  transform=model.transform,
                                  sampler=split.sampler, use_cache=True)
    model.trans_point_sampler = split.sampler.get_point_sampler()
    return model, DefaultBatcher().collate_fn([loader[0]])


def _step_vs_cpu(dataset, root, seed=SEED, same_branches=True):
    """One float32 training step, 1 x 11,264 points, full widths, the
    training budget, on the card and on the CPU from the same weights,
    batch (that of model seed ``seed``), dropout mask and, with
    ``same_branches``, branches (``_SameBranches``: the CPU takes the
    card's). Returns (loss relative difference, gradient relative L2,
    running statistics relative L2, parameter relative L2 after the Adam
    step, CPU step seconds, the ``_SameBranches`` used)."""
    n = 11_264
    out = {}
    model, batch = _step_model_and_batch(dataset, n, seed)
    keep = torch.rand((1, n, 32),
                      generator=torch.Generator().manual_seed(SEED)) >= 0.5
    state = None
    with _SameBranches(same_branches) as branches:
        for device in (DEVICE, "cpu"):
            pipeline = SemanticSegmentation(model, dataset=dataset,
                                            device=device, seed=SEED,
                                            main_log_dir=str(root),
                                            **TRAIN_PIPELINE)
            if state is None:
                state = {k: v.cpu().clone()
                         for k, v in pipeline.net.state_dict().items()}
            pipeline.net.load_state_dict(state)
            pipeline.net.dropout = _FixedDropout(keep)
            pipeline.optimizer, pipeline.scheduler = model.get_optimizer(
                pipeline.cfg, pipeline.net)
            t0 = time.perf_counter()
            loss, _ = pipeline._train_step(
                pipeline._device_batch(batch),
                SemSegLoss(pipeline, model, dataset))
            seconds = time.perf_counter() - t0
            net = pipeline.net
            out[device] = {
                "loss": loss.double().cpu(),
                "grad": torch.cat([p.grad.reshape(-1).cpu()
                                   for p in net.parameters()]),
                "stats": torch.cat([b.reshape(-1).cpu()
                                    for k, b in net.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))]),
                "params": torch.cat([p.detach().reshape(-1).cpu()
                                     for p in net.parameters()]),
                "seconds": seconds}
            if device == DEVICE:
                branches.replay()
        if branches.recorded:
            raise AssertionError("train: the CPU step took fewer branches "
                                 "than the card's")
    gpu, cpu = out[DEVICE], out["cpu"]
    return ((abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])).item(),
            _rel_l2(gpu["grad"], cpu["grad"]),
            _rel_l2(gpu["stats"], cpu["stats"]),
            _rel_l2(gpu["params"], cpu["params"]), cpu["seconds"], branches)


def phase_train(card):
    """run_train at the shipped config on synthetic scenes, a resume from
    its checkpoint, an overfit batch and one step against the CPU; returns
    the first run's launch counts."""
    model = MODEL.get("RandLANet")(seed=SEED)
    b, n = TRAIN_PIPELINE["batch_size"], model.cfg.num_points
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dataset = _train_dataset(root)
        pipeline = SemanticSegmentation(model, dataset=dataset, device=DEVICE,
                                        seed=SEED, max_epoch=0,
                                        main_log_dir=str(root / "logs"),
                                        **TRAIN_PIPELINE)
        record = []
        _instrument(pipeline, record)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        pipeline.run_train()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = _check_steps(record, 0, len(record))
        kinds = [r[0] for r in record]
        if kinds != ["train"] * 6 + ["eval"] * 2:
            raise AssertionError(f"train: ran steps {kinds}, expected 6 "
                                 "train and 2 eval")
        step = statistics.median(steps[1:])
        loop = record[-1][2] - record[0][1]
        busy = sum(t1 - t0 for _, t0, t1, _, _ in record)
        say("train", f"run_train max_epoch=0: 6 train steps of {b} x {n} "
            f"points and 2 validation steps of 2, each with the expected "
            f"launches ({TRAIN_STEP_LAUNCHES} per train step, "
            f"{EXPECTED_LAUNCHES} per validation step); losses "
            f"{[round(r[4], 4) for r in record]}, finite")
        say("train", f"step B={b} N={n} bf16, S{model.cfg.num_segs}/"
            f"G{model.cfg.gather_segs}: median {step * 1e3:.2f} ms over steps "
            f"2..6 (min {min(steps[1:]) * 1e3:.2f}, max "
            f"{max(steps[1:]) * 1e3:.2f}, first {steps[0] * 1e3:.2f}), "
            f"{b * n / step:.0f} points trained/s on {card}")
        say("train", f"wall {wall:.3f} s, of it set-up (scenes, preprocess "
            f"cache, optimizer) {record[0][1] - t0:.3f} s and the step loop "
            f"{loop:.3f} s: steps (synchronised) {busy / loop:.1%}, host "
            f"between steps (loader wait, copies, metrics) "
            f"{1 - busy / loop:.1%}; peak device memory "
            f"{peak / 2**30:.2f} GiB on {card}")
        ckpt = Path(pipeline.cfg.logs_dir) / "checkpoint" / "ckpt_00000.pth"
        if not ckpt.exists():
            raise AssertionError(f"train: no checkpoint at {ckpt}")

        saved = {"model": {k: v.clone()
                           for k, v in pipeline.net.state_dict().items()},
                 "adam": {idx: {k: v.clone() for k, v in moments.items()}
                          for idx, moments in
                          pipeline.optimizer.state_dict()["state"].items()}}
        resumed = SemanticSegmentation(model, dataset=dataset, device=DEVICE,
                                       seed=SEED + 1, max_epoch=1,
                                       main_log_dir=str(root / "logs"),
                                       **TRAIN_PIPELINE)
        _resume_check(resumed, saved)
        record2 = []
        _instrument(resumed, record2)
        resumed.run_train()
        _check_steps(record2, 0, len(record2))
        if saved.get("first_epoch") != 1 or len(record2) != 8:
            raise AssertionError(f"resume: started at epoch "
                                 f"{saved.get('first_epoch')} with "
                                 f"{len(record2)} steps")
        say("train", f"{ckpt.name} written; a fresh pipeline resumed from it "
            "at epoch 1 with equal weights, BN statistics and Adam state "
            f"(step, moments), and ran 6 + 2 steps with finite losses "
            f"{[round(r[4], 4) for r in record2]}")

        losses = _overfit(resumed, dataset)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"overfit: loss did not fall: {losses}")
        say("train", f"10 steps on one batch: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} ({[round(x, 4) for x in losses]})")

        (loss_rel, grad_rel, stats_rel, param_rel, cpu_s,
         branches) = _step_vs_cpu(dataset, root / "cpu")
        say("train", f"one float32 step B=1 N=11264, card vs CPU on the "
            f"card's branches ({branches.differ} of {branches.total} "
            f"max-pool and LeakyReLU choices the CPU would have made "
            f"otherwise): loss "
            f"relative difference {loss_rel:.3e} (bound 1e-5), gradient "
            f"relative L2 {grad_rel:.3e} (bound 1e-4), running statistics "
            f"relative L2 {stats_rel:.3e} (bound 1e-4); parameters after "
            f"Adam relative L2 {param_rel:.3e} (no bound: Adam's first "
            f"step moves each weight by about lr times the sign of its "
            f"gradient); CPU step {cpu_s:.1f} s")
        if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and stats_rel <= 1e-4):
            raise AssertionError("train: card and CPU steps disagree")
    return launches


def phase_eval(model, card):
    """The eval net at the shipped config, one patch, float32; returns its
    state_dict (the seeded random weights)."""
    dev = torch.device(DEVICE)
    model_cfg = model.cfg
    net = model.get_eval_net()
    state = random_weights(net, SEED).state_dict()
    net = net.eval().to(dev)
    rng = np.random.default_rng(0)
    n = model_cfg.num_points
    batch_cpu = {key: torch.from_numpy(
        rng.uniform(-25, 25, (1, n, 3)).astype(np.float32))
        for key in ("coords", "features")}
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}
    with torch.no_grad():
        net(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logits = net(batch)
        torch.cuda.synchronize()
        launches = read_counts()
    check_counts("eval", launches, dict(
        EXPECTED_LAUNCHES, bucket_knn=0, bucket_gather=0,
        knn_exact=model_cfg.num_layers))
    if tuple(logits.shape) != (1, n, model_cfg.num_classes):
        raise AssertionError(f"eval logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite eval logits")
    say("eval", f"knn_method={net.knn_method}, compute_dtype "
        f"{model_cfg.compute_dtype} in the config, MLPs float32; logits "
        f"{tuple(logits.shape)} finite; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    cpu_net = model.get_eval_net()
    cpu_net.load_state_dict(state)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cpu_net.eval()(batch_cpu)[0]
        cpu_s = time.perf_counter() - t0
    rel_l2, agree = _compare(logits[0], ref)
    say("eval", f"sample 0: card vs CPU relative L2 {rel_l2:.3e}, argmax "
        f"agreement {agree:.6f} (CPU forward {cpu_s:.1f} s)")
    if not rel_l2 <= 1e-4:
        raise AssertionError(f"eval relative L2 {rel_l2} > 1e-4")

    fwd, times = median_forward_s(net, batch)
    say("eval", f"forward B=1 N={n} float32: median {fwd * 1e3:.2f} ms over "
        f"{len(times)} runs (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}), {n / fwd:.0f} points/s on {card}")
    split = _eval_split(net, batch, model_cfg.num_layers)
    say("eval", "one forward on the card's stream, median of 5, ms: "
        f"{split['forward']:.4f} in all; the {model_cfg.num_layers} knn_exact "
        f"launches {split['knn_exact']:.4f} "
        f"({split['knn_exact'] / split['forward']:.1%}), the "
        f"{model_cfg.num_layers} k = 1 _nearest searches "
        f"{split['nearest']:.4f} ({split['nearest'] / split['forward']:.1%}),"
        f" everything else {split['other']:.4f} "
        f"({split['other'] / split['forward']:.1%})")
    return state


def _eval_split(net, batch, layers, runs=5):
    """One eval forward's time on the card's stream, split three ways: the
    ``knn_exact`` launches, the k = 1 ``_nearest`` searches (plain torch
    over [B, chunk, N] distance blocks) and everything else; CUDA events
    around each call and around the forward (an idle gap of the stream
    between them counts where it falls). Median of ``runs`` forwards."""
    spans = {"knn_exact": [], "nearest": []}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[key].append((start, end))
            return out
        return wrapper

    real = {"knn_exact": tn.knn_exact, "_nearest": tn._nearest}
    tn.knn_exact = timed("knn_exact", real["knn_exact"])
    tn._nearest = timed("nearest", real["_nearest"])
    parts = collections.defaultdict(list)
    try:
        with torch.no_grad():
            for _ in range(runs):
                for key in spans:
                    spans[key].clear()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                net(batch)
                end.record()
                end.synchronize()
                if any(len(v) != layers for v in spans.values()):
                    raise AssertionError(f"eval split: calls {spans}")
                parts["forward"].append(start.elapsed_time(end))
                for key, pairs in spans.items():
                    parts[key].append(sum(a.elapsed_time(b)
                                          for a, b in pairs))
                parts["other"].append(parts["forward"][-1] -
                                      parts["knn_exact"][-1] -
                                      parts["nearest"][-1])
    finally:
        tn.knn_exact, tn._nearest = real["knn_exact"], real["_nearest"]
    return {key: statistics.median(v) for key, v in parts.items()}


def lidar_scan(n, seed):
    """[n, 3] points of a synthetic lidar sweep: radius uniform in 2-50 m,
    so the density falls as 1/r, and height in -2-1 m."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(2, 50, n)
    th = rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(th), r * np.sin(th),
                     rng.uniform(-2, 1, n)], 1).astype(np.float32)


def _timed(fn, spent, key, sync=False):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        spent[key] += time.perf_counter() - t0
        spent[key + " calls"] += 1
        return out
    return wrapper


def phase_inference(model, state, card):
    """run_inference on one synthetic scan with the eval slice's weights;
    returns the launch counts of the run."""
    model_cfg = model.cfg
    points = lidar_scan(SCAN_POINTS, SEED)
    pipeline = SemanticSegmentation(model, device=DEVICE, seed=SEED)
    # run_inference copies the training net's weights into the eval net
    pipeline.net.load_state_dict(state)
    spent = collections.Counter()
    for name in ("preprocess", "transform", "update_probs"):
        setattr(model, name, _timed(getattr(model, name), spent, name))
    pipeline.eval_net.forward = _timed(pipeline.eval_net.forward, spent,
                                       "forward", sync=True)
    try:
        reset_counts()
        t0 = time.perf_counter()
        result = pipeline.run_inference(
            {"point": points, "feat": None, "label": None})
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        for name in ("preprocess", "transform", "update_probs"):
            delattr(model, name)
    patches = spent["transform calls"]
    forwards = spent["forward calls"]
    check_counts("inference", launches, dict(
        EXPECTED_LAUNCHES, bucket_knn=0, bucket_gather=0,
        knn_exact=model_cfg.num_layers * forwards))
    labels, scores = result["predict_labels"], result["predict_scores"]
    if labels.shape != (SCAN_POINTS,) or scores.shape != (
            SCAN_POINTS, model_cfg.num_classes):
        raise AssertionError(f"predict_labels {labels.shape}, predict_scores "
                             f"{scores.shape}")
    if not np.isfinite(scores).all():
        raise AssertionError("non-finite predict_scores")
    host = {name: spent[name] for name in
            ("preprocess", "transform", "update_probs")}
    other = wall - spent["forward"] - sum(host.values())
    parts = ", ".join(f"{name} {t:.3f} s ({t / wall:.1%}, "
                      f"{spent[name + ' calls']} calls)"
                      for name, t in host.items())
    say("inference", f"run_inference on a {SCAN_POINTS}-point scan: "
        f"{len(np.unique(labels))} classes over {labels.shape[0]} labels, "
        f"scores finite; {patches} patches in {forwards} forwards "
        f"(test_batch_size {pipeline.cfg.test_batch_size})")
    say("inference", f"wall {wall:.3f} s: forward {spent['forward']:.3f} s "
        f"({spent['forward'] / wall:.1%}, synchronised); host: {parts}; "
        f"other {other:.3f} s ({other / wall:.1%}); "
        f"{SCAN_POINTS / wall:.0f} points labelled/s on {card}")
    return launches


def scu_scene(extent_m, n, seed=SEED):
    """A room for SparseConvUnet: ``make_semseg_scene(n, seed)`` (points and
    labels) rebased to 0 and scaled to ``extent_m`` metres along its
    longest axis, RGB uniform in 0-255."""
    pts, labels = make_semseg_scene(n, seed=seed)
    pts = pts.astype(np.float64)
    pts -= pts.min(0)
    pts *= extent_m / pts.max()
    rgb = np.random.default_rng(seed).uniform(0, 255, (n, 3))
    return {"point": pts.astype(np.float32), "feat": rgb.astype(np.float32),
            "label": labels}


def _scu_inputs(model, data):
    """preprocess (test split) -> transform -> DefaultBatcher: (the numpy
    batch, its network inputs on the card)."""
    attr = {"split": "test"}
    sample = model.transform(model.preprocess(data, attr), attr)
    batch = DefaultBatcher().collate_fn([sample])
    return batch, {key: torch.from_numpy(batch[key]).to(DEVICE)
                   for key in ("point", "feat", "point_mask")}


def _capture_stencil_calls(net, inputs):
    """The arguments of every stencil_conv call of one forward."""
    calls = []
    real = tscu.stencil_conv

    def capture(values, keys, qkeys, seg_ids, w, **kw):
        calls.append({"values": values, "keys": keys, "qkeys": qkeys,
                      "seg_ids": seg_ids, "w": w, **kw})
        return real(values, keys, qkeys, seg_ids, w, **kw)

    tscu.stencil_conv = capture
    with torch.no_grad():
        net(inputs)
    tscu.stencil_conv = real
    return calls


def _keys_ascend(label, keys, seg):
    """The stencil kernels' precondition on one shape of the path: the keys
    of each batch row ascend, pad keys INT32_MAX at the end."""
    padded = cs._pad_keys(keys, seg)
    if not bool((padded[:, 1:] >= padded[:, :-1]).all()):
        raise AssertionError(f"stencil {label}: the keys of a batch row do "
                             "not ascend, the kernels' precondition")


def _stencil_check(label, call, gen):
    """stencil_conv against its plain version on one convolution of the
    path: the path's keys, tap keys and tables, new values and weights;
    beside it, how many of the taps whose site exists the tables find.
    Dyadic ones (values k/8 in [-4, 4], weights k/16 in [-2, 2]: every
    product and partial sum is a multiple of 1/128 below 2^17, exact in
    float32 and unchanged by bfloat16 rounding) must give the same bits
    at float32 and bfloat16. On normal ones each output must lie within
    n * 2^-24 * sum |x w| (n = K * Cin terms) of a float64 reference of the
    same (rounded) inputs: float32 summation in any order. Returns its
    record at bfloat16 (error: max |kernel - plain| on normal inputs).
    Bound: values, keys, tap keys, tables and weights read, the output
    written; 2 * Cin * Cout bf16 operations per tap that finds a row."""
    values, w = call["values"], call["w"]
    keys, qkeys, seg_ids = call["keys"], call["qkeys"], call["seg_ids"]
    k, cin, cout = w.shape
    tabs = dict(seg=call["seg"], qblock=call["qblock"])
    dev = values.device
    _keys_ascend(label, keys, tabs["seg"])

    def both(v, ww, dtype):
        return (cs.stencil_conv(v, keys, qkeys, seg_ids, ww, **tabs,
                                compute_dtype=dtype),
                cs.stencil_conv_plain(v, keys, qkeys, seg_ids, ww, **tabs,
                                      compute_dtype=dtype))

    dy_v = torch.randint(-32, 33, values.shape, generator=gen,
                         device=dev).float() / 8
    dy_w = torch.randint(-32, 33, w.shape, generator=gen,
                         device=dev).float() / 16
    nv = torch.randn(values.shape, generator=gen, device=dev)
    nw = torch.randn(w.shape, generator=gen, device=dev) / (k * cin) ** .5
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        got, ref = both(dy_v, dy_w, dtype)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"stencil_conv {label} {dtype}: differs "
                                 "from the plain version on dyadic inputs")
        got, ref = both(nv, nw, dtype)
        ref64 = cs.stencil_conv_plain(nv.double(), keys, qkeys, seg_ids,
                                      nw.double(), **tabs,
                                      compute_dtype=dtype)
        abs64 = cs.stencil_conv_plain(nv.double().abs(), keys, qkeys,
                                      seg_ids, nw.double().abs(), **tabs,
                                      compute_dtype=dtype)
        limit = k * cin * 2.0 ** -24 * abs64
        for name, out in (("kernel", got), ("plain", ref)):
            if ((out.double() - ref64).abs() > limit).any():
                raise AssertionError(f"stencil_conv {label} {dtype}: {name} "
                                     "past the float32 summation bound")
        errs[dtype] = ((got - ref).abs().max().item(),
                       (got.double() - ref64).abs().max().item())
    kw = dict(tabs, compute_dtype=torch.bfloat16)
    ms, plain_ms, span, plain_span = timings(
        lambda: cs.stencil_conv(nv, keys, qkeys, seg_ids, nw, **kw),
        lambda: cs.stencil_conv_plain(nv, keys, qkeys, seg_ids, nw, **kw))
    _, found = cs.stencil_rows(cs._pad_keys(keys, tabs["seg"]), qkeys,
                               seg_ids, **tabs)
    hits = int(found.sum())
    # taps whose site exists anywhere: what exact tables would find
    exist = sum(int(torch.isin(q, kb).sum()) for q, kb in zip(qkeys, keys))
    out_bytes = qkeys.shape[0] * qkeys.shape[1] * cout * 4
    bounds = bound(nbytes(values, keys, qkeys, seg_ids, w) + out_bytes,
                   2 * hits * cin * cout, "bfloat16")
    say("kernels", f"stencil_conv {label} B={values.shape[0]} "
        f"V={values.shape[1]} Q={qkeys.shape[1]} K={k} {cin}->{cout} "
        f"S={seg_ids.shape[-1]} seg={tabs['seg']} qblock={tabs['qblock']}, "
        f"{hits} of the {exist} taps whose site exists found in the block "
        f"tables: equal on dyadic inputs at float32 and bfloat16; "
        f"normal inputs within n * 2^-24 * sum|xw| of float64 (max |kernel - "
        f"float64| {errs[torch.float32][1]:.3e} float32, "
        f"{errs[torch.bfloat16][1]:.3e} bfloat16; max |kernel - plain| "
        f"{errs[torch.float32][0]:.3e}, {errs[torch.bfloat16][0]:.3e}); "
        f"bfloat16 device ms: kernel {ms:.4f}, plain {plain_ms:.4f}; call "
        f"span ms: kernel {span:.4f}, plain {plain_span:.4f}; bound "
        f"{max(bounds):.4f} ({bounds[0]:.4f} bytes, {bounds[1]:.4f} ops)")
    return kernel_record(errs[torch.bfloat16][0], ms, plain_ms, bounds)


def _match_check(label, call):
    """stencil_match against its plain version on one convolution's
    rulebook (the path's keys, tap keys and tables): rel and found equal
    bit for bit, misses' 0x7F000000 included. Returns its record (error 0
    when equal). Bound: the keys, tap keys and tables read, rel (int32)
    and found (one byte) written; no arithmetic to speak of. Library call:
    one batched ``torch.searchsorted`` of each block's tap keys into its
    table's keys, sorted ahead."""
    seg, qblock = call["seg"], call["qblock"]
    keys = cs._pad_keys(call["keys"], seg)
    qkeys, seg_ids = call["qkeys"], call["seg_ids"]
    tabs = dict(seg=seg, qblock=qblock)
    rel, found = cs.stencil_match(keys, qkeys, seg_ids, **tabs)
    rel_p, found_p = cs.stencil_match_plain(keys, qkeys, seg_ids, **tabs)
    torch.cuda.synchronize()
    if not (torch.equal(rel, rel_p) and torch.equal(found, found_p)):
        raise AssertionError(f"stencil_match {label}: differs from the plain "
                             "version")
    b, q, k = qkeys.shape
    nqb, s = seg_ids.shape[1:]
    cand = (seg_ids.long()[..., None] * seg +
            torch.arange(seg, device=keys.device)).reshape(b, -1)
    tabk = torch.gather(keys, 1, cand).reshape(b, nqb, s * seg).sort(-1)[0]
    qk = torch.nn.functional.pad(qkeys, (0, 0, 0, nqb * qblock - q),
                                 value=-1).reshape(b, nqb, qblock * k)
    library_ms = device_ms(lambda: torch.searchsorted(tabk, qk))
    ms, plain_ms, span, plain_span = timings(
        lambda: cs.stencil_match(keys, qkeys, seg_ids, **tabs),
        lambda: cs.stencil_match_plain(keys, qkeys, seg_ids, **tabs))
    bounds = bound(nbytes(keys, qkeys, seg_ids, rel, found), 0)
    say("kernels", f"stencil_match {label} B={b} Vp={keys.shape[1]} Q={q} "
        f"K={k} S={s} seg={seg} qblock={qblock}: rel and found equal "
        f"({int(found.sum())} found, {int((~found).sum())} misses); device "
        f"ms: kernel {ms:.4f}, plain {plain_ms:.4f}, torch.searchsorted "
        f"{library_ms:.4f}; call span ms: kernel {span:.4f}, plain "
        f"{plain_span:.4f}; bound {max(bounds):.4f} (bytes)")
    return kernel_record(0.0, ms, plain_ms, bounds, library_ms)


class _PlainStencilBackward:
    """While entered, ``stencil_conv_bwd`` runs on the plain versions of
    the rulebook, the gather and the scatter instead of their kernels."""

    names = ("stencil_match", "gather_bucket", "gather_bucket_bwd")

    def __enter__(self):
        self._saved = [getattr(cs, name) for name in self.names]
        for name, plain in zip(self.names, (cs.stencil_match_plain,
                                            cb.gather_bucket_plain,
                                            cb.gather_bucket_bwd_plain)):
            setattr(cs, name, plain)

    def __exit__(self, *exc):
        for name, fn in zip(self.names, self._saved):
            setattr(cs, name, fn)


def _stencil_bwd_check(label, call, gen):
    """The stencil convolution's backward (``stencil_conv_bwd``) on the
    kernels against the same backward on the plain versions, at one
    convolution of the path. On dyadic inputs (values k/8 in [-4, 4],
    weights k/16 in [-1, 1], cotangents k/64 in [-1, 1]) every dG entry and
    every value row's sum of them is exact in float32 in any order, so
    dvalues must be bit-equal, at float32 and bf16 (where dG is rounded
    once, the same on both sides). dw is the same product of G rows that
    must be bit-equal, so it must be bit-equal too; and, a sum over B * Q
    rows, it must lie within n * 2^-24 * sum |G g| (n = B * Q) of a float64
    reference, and at bf16 within that plus its one rounding (2^-8 of it).
    Returns the device ms of the kernels' and the plain versions' backward
    at bf16."""
    values, w = call["values"], call["w"]
    keys, qkeys, seg_ids = call["keys"], call["qkeys"], call["seg_ids"]
    tabs = dict(seg=call["seg"], qblock=call["qblock"])
    dev = values.device
    b, q = qkeys.shape[:2]
    dy_v = torch.randint(-32, 33, values.shape, generator=gen,
                         device=dev).float() / 8
    dy_w = torch.randint(-16, 17, w.shape, generator=gen,
                         device=dev).float() / 16
    dy_g = torch.randint(-64, 65, (b, q, w.shape[2]), generator=gen,
                         device=dev).float() / 64

    def bwd(g, v, ww, dtype):
        return cs.stencil_conv_bwd(g, v, keys, qkeys, seg_ids, ww, **tabs,
                                   compute_dtype=dtype)

    with _PlainStencilBackward():
        ref64 = bwd(dy_g.double(), dy_v.double(), dy_w.double(),
                    torch.float32)[1]
        abs64 = bwd(dy_g.double().abs(), dy_v.double().abs(),
                    dy_w.double().abs(), torch.float32)[1]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        got = bwd(dy_g, dy_v, dy_w, dtype)
        with _PlainStencilBackward():
            ref = bwd(dy_g, dy_v, dy_w, dtype)
        torch.cuda.synchronize()
        for i, name in enumerate(("dvalues", "dw")):
            if not torch.equal(got[i], ref[i]):
                raise AssertionError(f"stencil_conv backward {label} {dtype}:"
                                     f" {name} differ from the plain "
                                     "backward's on dyadic inputs")
        limit = b * q * 2.0 ** -24 * abs64
        if dtype == torch.bfloat16:
            limit = limit + 2.0 ** -8 * ref64.abs()
        for name, dw in (("kernels", got[1]), ("plain", ref[1])):
            err = (dw.double() - ref64).abs()
            if (err > limit).any():
                raise AssertionError(f"stencil_conv backward {label} {dtype}:"
                                     f" dw of the {name} past its bound")
        errs[dtype] = (got[1].double() - ref64).abs().max().item()
    ms = device_ms(lambda: bwd(dy_g, dy_v, dy_w, torch.bfloat16), iters=5)
    with _PlainStencilBackward():
        plain_ms = device_ms(lambda: bwd(dy_g, dy_v, dy_w, torch.bfloat16),
                             iters=5)
    say("kernels", f"stencil_conv backward {label} B={b} Q={q}: dvalues "
        f"and dw equal to the plain backward's on dyadic inputs at float32 "
        f"and bfloat16; dw within its bound of float64 (max |err| "
        f"{errs[torch.float32]:.3e} "
        f"float32, {errs[torch.bfloat16]:.3e} bfloat16); bfloat16 device "
        f"ms: kernels {ms:.4f}, plain versions {plain_ms:.4f} (both with "
        f"the two products)")
    return ms, plain_ms


def _scu_bucket_checks(label, call, gen):
    """bucket_gather and bucket_gather_bwd at one convolution, as its
    backward (``stencil_conv_bwd``) calls them: the path's tables, the
    rulebook from ``stencil_match`` with misses reading position 0, the
    values padded to a multiple of seg, the cotangents of misses 0.
    Returns their (label, record) pairs."""
    seg, qblock = call["seg"], call["qblock"]
    tabs = dict(seg=seg, qblock=qblock)
    rel, found = cs.stencil_match(cs._pad_keys(call["keys"], seg),
                                  call["qkeys"], call["seg_ids"], **tabs)
    rel = torch.where(found, rel, 0)
    values = call["values"]
    vals = torch.nn.functional.pad(values, (0, 0, 0, (-values.shape[1]) % seg))
    label = f"SCU {label}"
    return ((label, _gather_check(label, vals, call["seg_ids"], rel, seg,
                                  qblock)),
            (label, _gather_bwd_check(label, call["seg_ids"], rel,
                                      vals.shape[1], values.shape[2], seg,
                                      qblock, gen, mask=found)))


def _edge_sites(b, cap, box, seed):
    """[b, cap] distinct random sites in a box, uneven valid counts,
    Morton-sorted by ``sort_sites``: (coords, mask, key, inv_perm)."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((b, cap, 3), np.int32)
    mask = np.zeros((b, cap), bool)
    for i in range(b):
        c = np.unique(rng.integers(0, box, (cap * 2, 3)), axis=0)
        rng.shuffle(c)
        n = min(len(c), cap - 7 + i)
        coords[i, :n] = c[:n]
        mask[i, :n] = True
    return tsb.sort_sites(torch.from_numpy(coords), torch.from_numpy(mask))


def _edge_rulebook(form, seg, qblock, s, b=2, cap=3000, box=24):
    """(keys, tap keys, tables) of one synthetic convolution of the given
    form, the tables ranked by ``rank_site_segments`` as the net ranks
    them."""
    coords, mask, mkey, _ = _edge_sites(b, cap, box, SEED)
    nv = mask.sum(1).to(torch.int32)
    sup = tsb.support_points(coords, mask, seg)
    child = torch.arange(8, dtype=torch.int32)
    pc, pm, pk, off, _ = tsb.bucket_downsample(coords, mask, mkey, cap // 2)
    npar = pm.sum(1).to(torch.int32)
    rank = dict(seg=seg, qblock=qblock, num_segs=s)
    if form == "sub":
        qkeys = tsb.stencil_query_keys(coords, mask,
                                       tsp.kernel_offsets(3, centered=True))
        sids, _ = tsb.rank_site_segments(sup, nv, coords.float(), nv,
                                         reach=1.74, **rank)
        return mkey, qkeys, sids
    if form == "down":
        qkeys = torch.where(pm[..., None], (pk[..., None] << 3) | child, -1)
        pq = torch.where(pm[..., None], (pc * 2).float(), 2e9)
        sids, _ = tsb.rank_site_segments(sup, nv, pq, npar, reach=1.74,
                                         **rank)
        return mkey, qkeys, sids
    qkeys = torch.where(mask[..., None] & (off[..., None] == child),
                        (mkey >> 3)[..., None], -1)
    fq = torch.where(mask[..., None], (coords >> 1).float(), 2e9)
    sids, _ = tsb.rank_site_segments(tsb.support_points(pc, pm, seg), npar,
                                     fq, nv, reach=0.1, **rank)
    return pk, qkeys, sids


def _stencil_edges(gen):
    """Both stencil kernels against their plain versions on the synthetic
    rulebooks of ``STENCIL_EDGE_CASES`` at B = 2: ``stencil_match`` with an
    all-pad segment in some tables and pad-key taps (INT32_MAX: the least
    position among the pads of several segments), ``stencil_conv`` at each
    of ``STENCIL_EDGE_WIDTHS``, float32 and bf16, on dyadic inputs (any
    summation order gives the same bits). Each must be bit-equal."""
    convs = 0
    for n, (form, seg, qblock, s) in enumerate(STENCIL_EDGE_CASES):
        keys, qkeys, sids = (t.to(DEVICE)
                             for t in _edge_rulebook(form, seg, qblock, s))
        if n % 2:  # repeated ids
            sids = sids.clone()
            sids[..., -1] = sids[..., 0]
            sids[..., 1] = sids[..., 0]
        label = f"{form} seg {seg} qblock {qblock} S {sids.shape[-1]}"
        tabs = dict(seg=seg, qblock=qblock)
        padded = torch.nn.functional.pad(cs._pad_keys(keys, seg), (0, seg),
                                         value=cs._I32MAX)
        mq = qkeys.clone()
        mq[:, ::5, 0] = cs._I32MAX
        ms = sids.clone()
        ms[:, 1::3, 0] = padded.shape[1] // seg - 1  # an all-pad segment
        got = cs.stencil_match(padded, mq, ms, **tabs)
        ref = cs.stencil_match_plain(padded, mq, ms, **tabs)
        torch.cuda.synchronize()
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"stencil_match {label}: differs from the "
                                 "plain version")
        k = qkeys.shape[-1]
        for cin, cout in STENCIL_EDGE_WIDTHS:
            v = torch.randint(-32, 33, (*keys.shape, cin), generator=gen,
                              device=DEVICE).float() / 8
            w = torch.randint(-32, 33, (k, cin, cout), generator=gen,
                              device=DEVICE).float() / 16
            for dtype in (torch.float32, torch.bfloat16):
                got = cs.stencil_conv(v, keys, qkeys, sids, w, **tabs,
                                      compute_dtype=dtype)
                ref = cs.stencil_conv_plain(v, keys, qkeys, sids, w, **tabs,
                                            compute_dtype=dtype)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"stencil_conv {label} {cin}->"
                                         f"{cout} {dtype}: differs from the "
                                         "plain version on dyadic inputs")
                convs += 1
    say("kernels", f"stencil kernels on {len(STENCIL_EDGE_CASES)} synthetic "
        f"rulebooks (seg 16 and 64, qblock 32-128, S 3-40, repeated ids, "
        f"all-pad segments, pad-key taps): stencil_match and {convs} "
        f"convolutions ({', '.join(f'{i}->{o}' for i, o in STENCIL_EDGE_WIDTHS)}"
        f"; float32 and bfloat16) equal to their plain versions")


def _conv_table(net, calls):
    """Device ms of each stencil_conv call of one forward, run again on its
    captured arguments, by level, form (sub: 27 taps; down; up), K, Cin ->
    Cout and Q. Returns [(label, call, ms)] in call order."""
    rows = []
    for call in calls:
        k, cin, cout = call["w"].shape
        q = call["qkeys"].shape[1]
        form = ("sub" if k == 27 else
                "down" if call["qblock"] == net.qblock else "up")
        level = net.caps.index(q) - (form == "down")
        args = [call[key] for key in ("values", "keys", "qkeys", "seg_ids",
                                      "w")]
        kw = {key: call[key] for key in ("seg", "qblock", "compute_dtype")}
        ms = device_ms(lambda: cs.stencil_conv(*args, **kw))
        rows.append((f"level-{level} {form} K={k} {cin}->{cout} Q={q}", call,
                     ms))
    return rows


def _say_conv_table(table):
    for i, (label, _, ms) in enumerate(table):
        say("scu", f"stencil_conv {i:2d} {label}: {ms:.4f} device ms")
    say("scu", f"stencil_conv, the {len(table)} calls of one room forward "
        f"run one by one: {sum(ms for *_, ms in table):.4f} device ms")


def _slower_line(name, records, library):
    """One line naming the shapes where ``name`` is slower than its library
    call, or saying it is slower at none; records are (label, record)."""
    slow = [f"{label} ({r['ms']:.4f} vs {r['library_ms']:.4f})"
            for label, r in records if r["ms"] > r["library_ms"]]
    say("kernels", f"{name} slower than {library} at: {'; '.join(slow)}"
        if slow else f"{name} no slower than {library} at any of the "
        f"{len(records)} shapes")


def phase_stencil(net, inputs, other, wides):
    """The stencil kernel, the rulebook kernel and the convolution's
    backward at five convolutions of the room request's forward
    (``STENCIL_SHAPES``), and at its level-0 block with the ``other``
    request's beside it as a batch of 2 (the second row's offsets into
    keys, tables and values); the bucket gather and its backward as that
    backward calls them at the batch of 2, the level-0 post conv1 and the
    deepest block (``SCU_BUCKET_SHAPES``). Then every convolution of the
    forward timed by level and form; the kernel and the rulebook at the
    two heaviest and at those whose Cin or Cout is not a multiple of 4
    (the input convolution), where they are not among the five, and at
    the level-0 block with the tables of each of ``wides`` (the same net
    at num_segs 32 and 48, tables of 2,048 and 3,072 rows; past 32 slots
    the kernels order a table in shared memory, not in one warp), whose
    found taps stand beside S = 16's; then both kernels on synthetic
    rulebooks (``_stencil_edges``). Returns the records
    of ``stencil_conv`` and ``stencil_match`` over the five, and the
    (label, record) pairs of the gather and of its backward."""
    calls = _capture_stencil_calls(net, inputs)
    if len(calls) != SCU_FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} stencil_conv calls per forward")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    pair = [_capture_stencil_calls(net, x)[1] for x in (inputs, other)]
    both = {key: (torch.cat([c[key] for c in pair]) if key in
                  ("values", "keys", "qkeys", "seg_ids") else pair[0][key])
            for key in pair[0]}
    label = "level-0 block, both requests"
    _stencil_check(label, both, gen)
    searched = [(label, _match_check(label, both))]
    _stencil_bwd_check(label, both, gen)
    buckets = [_scu_bucket_checks(label, both, gen)]
    records, matches, bwds = [], [], []
    five = []
    for label, k, cin, cout, qblock in STENCIL_SHAPES:
        call = next(c for c in calls
                    if tuple(c["w"].shape) == (k, cin, cout) and
                    c["qblock"] == qblock)
        five.append(call)
        records.append(_stencil_check(label, call, gen))
        matches.append(_match_check(label, call))
        searched.append((label, matches[-1]))
        bwds.append(_stencil_bwd_check(label, call, gen))
        if label in SCU_BUCKET_SHAPES:
            buckets.append(_scu_bucket_checks(label, call, gen))
    rec, match = combine(records), combine(matches)
    say("kernels", f"stencil_conv, five shapes at bfloat16: device ms: "
        f"kernel {rec['ms']:.4f}, plain {rec['plain_ms']:.4f}, bound "
        f"{rec['bound_ms']:.4f} in all")
    say("kernels", f"stencil_match, five shapes: device ms: kernel "
        f"{match['ms']:.4f}, plain {match['plain_ms']:.4f}, "
        f"torch.searchsorted {match['library_ms']:.4f}, bound "
        f"{match['bound_ms']:.4f} in all")
    say("kernels", f"stencil_conv backward, five shapes at bfloat16: device "
        f"ms: kernels {sum(m for m, _ in bwds):.4f}, plain versions "
        f"{sum(p for _, p in bwds):.4f} in all")

    table = _conv_table(net, calls)
    _say_conv_table(table)
    heavy = sorted(table, key=lambda row: -row[2])[:2]
    # widths not a multiple of 4 (the input convolution's Cin 3): the bf16
    # kernel's 4-byte copies
    narrow = [row for row in table
              if any(n % 4 for n in row[1]["w"].shape[1:])]
    checked = list(five)
    for tag, rows in (("heaviest", heavy), ("4-byte copies", narrow)):
        for label, call, _ in rows:
            if any(call is c for c in checked):
                continue
            checked.append(call)
            label = f"{tag} {label}"
            _stencil_check(label, call, gen)
            searched.append((label, _match_check(label, call)))
    for wide in wides:
        level0 = next(c for c in _capture_stencil_calls(wide, inputs)
                      if tuple(c["w"].shape) == tuple(five[0]["w"].shape))
        label = f"level-0 block, S={level0['seg_ids'].shape[-1]}"
        _stencil_check(label, level0, gen)
        searched.append((label, _match_check(label, level0)))
    _slower_line("stencil_match", searched, "torch.searchsorted")
    _stencil_edges(gen)
    return rec, match, [g for g, _ in buckets], [b for _, b in buckets]


def _stencil_share(net, inputs):
    """Device ms of the stencil_conv calls of one forward, and the wall ms
    of another, synchronised forward. Each call is timed by CUDA events
    with the card held asleep while the host queues it, so that the events
    hold the kernel and not the host's work before its launch (the forward
    is host-bound: without the sleep the card waits inside the span)."""
    real = tscu.stencil_conv
    cycles = 10**6  # about 0.5 ms, longer than the host's work per call
    for _ in range(4):
        events = []

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            out = real(*args, **kw)
            end.record()
            events.append((start, end, not start.query()))
            return out

        tscu.stencil_conv = timed
        try:
            with torch.no_grad():
                net(inputs)
        finally:
            tscu.stencil_conv = real
        torch.cuda.synchronize()
        if all(ahead for *_, ahead in events):
            break
        cycles *= 4
    else:
        raise AssertionError("the host could not queue the stencil calls "
                             "ahead of the card")
    device = sum(start.elapsed_time(end) for start, end, _ in events)
    t0 = time.perf_counter()
    with torch.no_grad():
        net(inputs)
    torch.cuda.synchronize()
    return device, (time.perf_counter() - t0) * 1e3


def _profile_forward(net, inputs, top=8):
    """One forward under ``torch.profiler``: the kernels' device time
    (kernel rows only), their launches, the profiled wall time, and the
    ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net(inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    rows.sort(key=lambda e: -e.self_device_time_total)
    head = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                     f" ({e.count})" for e in rows[:top])
    return device_ms, sum(e.count for e in rows), wall_ms, head


def _counts_line(counts):
    return (f"voxel_overflow_points {counts['voxel_overflow_points']}, "
            f"down_overflow_children "
            f"{[counts[f'l{i}_down_overflow_children'] for i in range(6)]}, "
            f"table_overflow_blocks {counts['table_overflow_blocks']}")


def phase_scu(card):
    """SparseConvUnet at the ScanNet config: two requests served through
    preprocess -> transform -> batch -> the stencil forward ->
    update_probs, the stencil kernel checks, the card against the CPU and
    the hash path, and the forward's time. Returns (launch counts of the
    two served forwards, the records of the stencil and rulebook kernels,
    the (label, record) pairs of the bucket gather and of its backward at
    SparseConvUnet's shapes)."""
    model = MODEL.get("SparseConvUnet")(seed=SEED)
    cfg = model.cfg
    n, classes = cfg.num_points, cfg.num_classes
    net = model.get_net()
    state = random_weights(net, SEED).state_dict()
    net = net.eval().to(DEVICE)
    scenes = {"room": scu_scene(SCU_ROOM_EXTENT_M, n),
              "bench": scu_scene(SCU_BENCH_EXTENT_M, n)}
    inputs = {}
    for name, data in scenes.items():
        inputs[name] = _scu_inputs(model, data)
        with torch.no_grad():
            net(inputs[name][1])  # warm-up
    wides = []
    for segs in SCU_WIDE_SEGS:
        wide = MODEL.get("SparseConvUnet")(seed=SEED,
                                           bucket_segs=segs).get_net()
        wide.load_state_dict(net.state_dict())
        wides.append(wide.eval().to(DEVICE))
    stencil, match, gathers, bwds = phase_stencil(
        net, inputs["room"][1], inputs["bench"][1], wides)

    torch.cuda.synchronize()
    reset_counts()
    served = {}
    for name, data in scenes.items():
        batch, x = _scu_inputs(model, data)
        with torch.no_grad():
            logits = net(x)
        counts = net.overflow_counts()
        probs = model.update_probs(batch, logits.cpu().numpy(),
                                   np.zeros((n, classes), np.float32))
        served[name] = (batch, x, logits, counts, probs)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("scu", launches, dict(
        EXPECTED_LAUNCHES, bucket_knn=0, bucket_gather=0,
        stencil_conv=SCU_FORWARD_LAUNCHES * len(scenes)))

    for name, (batch, x, logits, counts, probs) in served.items():
        if tuple(logits.shape) != (1, n, classes):
            raise AssertionError(f"scu {name}: logits {tuple(logits.shape)}")
        if not (torch.isfinite(logits).all() and np.isfinite(probs).all()):
            raise AssertionError(f"scu {name}: non-finite output")
        rows = probs.sum(1)
        if not np.allclose(rows[batch["point_inds"][0]], 1.0, atol=1e-5):
            raise AssertionError(f"scu {name}: probabilities do not sum to 1")
        # occupied voxels before the cap
        voxels = int(voxelize(x["point"][0], (1.0,) * 3, (0.0,) * 3,
                              (1024.0,) * 3, n, 1).num_voxels)
        say("scu", f"{name} request ({int(batch['point_mask'].sum())} points,"
            f" {voxels} voxels, cap {cfg.max_voxels}): logits "
            f"{tuple(logits.shape)} finite, update_probs rows sum to 1; "
            f"counters: {_counts_line(counts)}")

        # the card against the CPU, float32 (gated) and the config's bf16
        for dtype in ("float32", cfg.compute_dtype):
            gpu = logits[0]
            if dtype == "float32":
                net32 = model.get_net(compute_dtype="float32")
                net32.load_state_dict(state)
                with torch.no_grad():
                    gpu = net32.eval().to(DEVICE)(x)[0]
                served[name] = served[name] + (gpu,)
            cpu_net = model.get_net(compute_dtype=dtype)
            cpu_net.load_state_dict(state)
            with torch.no_grad():
                t0 = time.perf_counter()
                ref = cpu_net.eval()({k: v.cpu() for k, v in x.items()})[0]
                cpu_s = time.perf_counter() - t0
            rel_l2, agree = _compare(gpu, ref)
            say("scu", f"{name}, compute_dtype={dtype}: card vs CPU relative "
                f"L2 {rel_l2:.3e}, argmax agreement {agree:.6f} (CPU forward "
                f"{cpu_s:.1f} s)")
            if dtype == "float32" and not rel_l2 <= 1e-4:
                raise AssertionError(f"scu {name}: float32 relative L2 "
                                     f"{rel_l2} > 1e-4")

    # bucket against the exact hash path on the card, float32, room scene
    batch, x, _, counts, _, gpu32 = served["room"]
    hash_net = model.get_eval_net()
    hash_net.load_state_dict(state)
    with torch.no_grad():
        hashed = hash_net.eval().to(DEVICE)(x)[0]
    rel_l2, agree = _compare(gpu32, hashed.cpu())
    exact = not (counts["voxel_overflow_points"] or
                 counts["table_overflow_blocks"] or
                 any(counts[f"l{i}_down_overflow_children"]
                     for i in range(6)))
    say("scu", f"room, float32 on the card: bucket vs hash relative L2 "
        f"{rel_l2:.3e}, argmax disagreement {1 - agree:.6f}; counters "
        f"{'all 0: gated at 1e-4' if exact else 'not all 0: not gated'} "
        f"({_counts_line(counts)})")
    if exact and not rel_l2 <= 1e-4:
        raise AssertionError(f"scu: bucket vs hash relative L2 {rel_l2}")

    for name in scenes:
        x = served[name][1]
        torch.cuda.reset_peak_memory_stats()
        fwd, times = median_forward_s(net, x)
        peak = torch.cuda.max_memory_allocated()
        st_ms, wall_ms = _stencil_share(net, x)
        say("scu", f"{name} forward B=1 N={n} {cfg.compute_dtype}: median "
            f"{fwd * 1e3:.2f} ms over {len(times)} runs (min "
            f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
            f"{n / fwd:.0f} points/s, peak device memory "
            f"{peak / 2**30:.2f} GiB; the {SCU_FORWARD_LAUNCHES} "
            f"stencil_conv calls of one forward {st_ms:.2f} ms device time, "
            f"{st_ms / wall_ms:.1%} of a {wall_ms:.2f} ms forward on {card}")
    device_ms, kernels, wall_ms, head = _profile_forward(net,
                                                         served["room"][1])
    say("scu", f"room forward under torch.profiler: {kernels} kernels, "
        f"{device_ms:.2f} ms device time in a {wall_ms:.2f} ms forward "
        f"(busy {device_ms / wall_ms:.1%}); by device time: {head}")
    return launches, stencil, match, gathers, bwds


def _scu_rooms(root, n):
    """``SCU_TRAIN_ROOMS`` synthetic rooms of ``n`` points, 6 m, RGB 0-255
    and ``make_semseg_scene``'s labels, as ``Custom3D`` files under
    ``root``: one epoch is 6 training and 2 validation steps of 8."""
    seed = SEED
    for split, count in SCU_TRAIN_ROOMS.items():
        (root / "rooms" / split).mkdir(parents=True)
        for i in range(count):
            seed += 1
            np.save(root / "rooms" / split / f"room_{i}.npy",
                    scu_scene(SCU_ROOM_EXTENT_M, n, seed))
    batch = SCU_TRAIN_PIPELINE["batch_size"]
    return DATASET.get("Custom3D")(
        dataset_path=str(root / "rooms"), cache_dir=str(root / "cache"),
        test_result_folder=str(root / "test"), seed=SEED,
        steps_per_epoch_train=6 * batch, steps_per_epoch_valid=2 * batch)


def _step_breakdown(pipeline, dataset):
    """One training step on a batch of the train split, timed on the card
    by CUDA events: its synchronised wall ms, and the device ms of the
    forward, of the backward (from the gradients' reset to the optimizer
    step), of the backward's stencil_match, gather and scatter calls
    (events around each) with their count, and of the Adam step."""
    model = pipeline.model
    split = dataset.get_split("train")
    loader = PointCloudDataloader(split, preprocess=model.preprocess,
                                  transform=model.transform,
                                  sampler=split.sampler)
    batch = next(iter(BatchLoader(loader, SCU_TRAIN_PIPELINE["batch_size"],
                                  DefaultBatcher(), num_workers=0,
                                  sampler=split.sampler)))
    inputs = pipeline._device_batch(batch)
    spans = collections.defaultdict(list)

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[key].append((start, end))
            return out
        return wrapper

    marks = {}

    def mark(fn, name, after):
        def wrapper(*args, **kwargs):
            event = torch.cuda.Event(enable_timing=True)
            if not after:
                event.record()
            out = fn(*args, **kwargs)
            if after:
                event.record()
            marks[name] = event
            return out
        return wrapper

    saved = {name: getattr(cs, name) for name in _PlainStencilBackward.names}
    net, opt = pipeline.net, pipeline.optimizer
    for name, fn in saved.items():
        setattr(cs, name, timed(fn, "bwd kernels"))
    net.forward = timed(net.forward, "forward")
    opt.zero_grad = mark(opt.zero_grad, "backward start", after=True)
    opt.step = timed(mark(opt.step, "backward end", after=False), "adam")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline._train_step(inputs, SemSegLoss(pipeline, model, dataset))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(cs, name, fn)
        for obj, name in ((net, "forward"), (opt, "zero_grad"),
                          (opt, "step")):
            delattr(obj, name)
    ms = {key: sum(s.elapsed_time(e) for s, e in pairs)
          for key, pairs in spans.items()}
    ms["backward"] = marks["backward start"].elapsed_time(
        marks["backward end"])
    return wall * 1e3, ms, len(spans["bwd kernels"])


def _scu_step_vs_cpu(dataset, root):
    """One float32 training step of SparseConvUnet at the shipped widths,
    B = 1 on the room request (the test split's preprocess and transform:
    no augmentation), on the card and on the CPU from the same weights,
    the CPU on the card's ReLU branches (``_SameBranches``). Returns (loss
    relative difference, gradient relative L2, running statistics relative
    L2, CPU step seconds, the ``_SameBranches`` used)."""
    model = MODEL.get("SparseConvUnet")(compute_dtype="float32", seed=SEED)
    batch, _ = _scu_inputs(model, scu_scene(SCU_ROOM_EXTENT_M,
                                            model.cfg.num_points))
    out, state = [], None
    with _SameBranches(net="scu") as branches:
        for device in (DEVICE, "cpu"):  # the card first
            pipeline = SemanticSegmentation(model, dataset=dataset,
                                            device=device, seed=SEED,
                                            main_log_dir=str(root),
                                            **SCU_TRAIN_PIPELINE)
            if state is None:
                state = {k: v.cpu().clone()
                         for k, v in pipeline.net.state_dict().items()}
            pipeline.net.load_state_dict(state)
            pipeline.optimizer, pipeline.scheduler = model.get_optimizer(
                pipeline.cfg, pipeline.net)
            t0 = time.perf_counter()
            loss, _ = pipeline._train_step(
                {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                 if isinstance(v, np.ndarray)},
                SemSegLoss(pipeline, model, dataset))
            seconds = time.perf_counter() - t0
            net = pipeline.net
            out.append({
                "loss": loss.double().cpu(),
                "grad": torch.cat([p.grad.reshape(-1).cpu()
                                   for p in net.parameters()]),
                "stats": torch.cat([b.reshape(-1).cpu()
                                    for k, b in net.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))]),
                "seconds": seconds})
            if len(out) == 1:
                branches.replay()
        if branches.recorded:
            raise AssertionError("scu_train: the CPU step took fewer "
                                 "branches than the card's")
    gpu, cpu = out
    return ((abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])).item(),
            _rel_l2(gpu["grad"], cpu["grad"]),
            _rel_l2(gpu["stats"], cpu["stats"]), cpu["seconds"], branches)


def phase_scu_train(card):
    """run_train of SparseConvUnet at the shipped ScanNet config on
    synthetic rooms, a resume from its checkpoint, an overfit batch, the
    backward kernels' device time in one step and one float32 step against
    the CPU; returns the first run's launch counts."""
    model = MODEL.get("SparseConvUnet")(seed=SEED)
    b, n = SCU_TRAIN_PIPELINE["batch_size"], model.cfg.num_points
    valid = {"stencil_conv": SCU_FORWARD_LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        dataset = _scu_rooms(root, n)
        rooms_s = time.perf_counter() - t0
        pipeline = SemanticSegmentation(model, dataset=dataset, device=DEVICE,
                                        seed=SEED, max_epoch=0,
                                        main_log_dir=str(root / "logs"),
                                        **SCU_TRAIN_PIPELINE)
        record = []
        _instrument(pipeline, record)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        pipeline.run_train()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = _check_steps(record, 0, len(record), SCU_TRAIN_STEP_LAUNCHES,
                             valid)
        kinds = [r[0] for r in record]
        if kinds != ["train"] * 6 + ["eval"] * 2:
            raise AssertionError(f"scu_train: ran steps {kinds}, expected 6 "
                                 "train and 2 eval")
        step = statistics.median(steps[1:])
        loop = record[-1][2] - record[0][1]
        busy = sum(t1 - t0 for _, t0, t1, _, _ in record)
        say("scu_train", f"run_train max_epoch=0 on "
            f"{SCU_TRAIN_ROOMS['train']} + {SCU_TRAIN_ROOMS['val']} "
            f"Custom3D rooms of "
            f"{SCU_ROOM_EXTENT_M:g} m (written in {rooms_s:.2f} s): 6 train "
            f"steps of {b} x {n} points with the ScanNet augmentations and "
            f"2 validation steps, each with the expected launches "
            f"({SCU_TRAIN_STEP_LAUNCHES} per train step, {valid} per "
            f"validation step); losses {[round(r[4], 4) for r in record]}, "
            "finite")
        say("scu_train", f"step B={b} N={n} {model.cfg.compute_dtype}: median "
            f"{step * 1e3:.2f} ms over steps 2..6 (min "
            f"{min(steps[1:]) * 1e3:.2f}, max {max(steps[1:]) * 1e3:.2f}, "
            f"first {steps[0] * 1e3:.2f}), {b * n / step:.0f} points "
            f"trained/s on {card}")
        say("scu_train", f"wall {wall:.3f} s, of it set-up (splits, "
            f"optimizer) {record[0][1] - t0:.3f} s and the step loop "
            f"{loop:.3f} s: steps (synchronised) {busy / loop:.1%}, host "
            f"between steps (loader wait, copies, metrics) "
            f"{1 - busy / loop:.1%}; peak device memory "
            f"{peak / 2**30:.2f} GiB on {card}")
        ckpt = Path(pipeline.cfg.logs_dir) / "checkpoint" / "ckpt_00000.pth"
        if not ckpt.exists():
            raise AssertionError(f"scu_train: no checkpoint at {ckpt}")

        saved = {"model": {k: v.clone()
                           for k, v in pipeline.net.state_dict().items()},
                 "adam": {idx: {k: v.clone() for k, v in moments.items()}
                          for idx, moments in
                          pipeline.optimizer.state_dict()["state"].items()}}
        resumed = SemanticSegmentation(model, dataset=dataset, device=DEVICE,
                                       seed=SEED + 1, max_epoch=1,
                                       main_log_dir=str(root / "logs"),
                                       **SCU_TRAIN_PIPELINE)
        _resume_check(resumed, saved)
        record2 = []
        _instrument(resumed, record2)
        resumed.run_train()
        _check_steps(record2, 0, len(record2), SCU_TRAIN_STEP_LAUNCHES,
                     valid)
        if saved.get("first_epoch") != 1 or len(record2) != 8:
            raise AssertionError(f"scu_train resume: started at epoch "
                                 f"{saved.get('first_epoch')} with "
                                 f"{len(record2)} steps")
        say("scu_train", f"{ckpt.name} written; a fresh pipeline resumed "
            "from it at epoch 1 with equal weights, BN statistics and Adam "
            f"state (step, moments), and ran 6 + 2 steps with finite losses "
            f"{[round(r[4], 4) for r in record2]}")

        losses = _overfit(resumed, dataset, b)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"scu_train overfit: loss did not fall: "
                                 f"{losses}")
        say("scu_train", f"10 steps on one batch: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} ({[round(x, 4) for x in losses]})")

        step_ms, ms, calls = _step_breakdown(resumed, dataset)
        say("scu_train", f"one train step {step_ms:.2f} ms (synchronised), "
            f"by CUDA events: forward {ms['forward']:.2f} ms, backward "
            f"{ms['backward']:.2f} ms, of it its {calls} stencil_match, "
            f"bucket_gather and bucket_gather_bwd calls "
            f"{ms['bwd kernels']:.2f} ms ({ms['bwd kernels'] / step_ms:.1%} "
            f"of the step), Adam {ms['adam']:.2f} ms, the rest (loss, "
            f"confusion matrix, host) "
            f"{step_ms - ms['forward'] - ms['backward'] - ms['adam']:.2f} "
            f"ms on {card}")

        loss_rel, grad_rel, stats_rel, cpu_s, branches = _scu_step_vs_cpu(
            dataset, root / "cpu")
        say("scu_train", f"one float32 step B=1 N={n} on the room request, "
            f"card vs CPU on the card's ReLU branches ({branches.differ} of "
            f"{branches.total} choices the CPU would have made otherwise): "
            f"loss relative difference {loss_rel:.3e} (bound 1e-5), gradient "
            f"relative L2 {grad_rel:.3e} (bound 1e-4), running statistics "
            f"relative L2 {stats_rel:.3e} (bound 1e-4); CPU step "
            f"{cpu_s:.1f} s")
        if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and stats_rel <= 1e-4):
            raise AssertionError("scu_train: card and CPU steps disagree")
    return launches


def step_branches():
    """The float32 card-vs-CPU step on the patches of model seeds 0-3, with
    the CPU on its own branches and then on the card's."""
    card = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dataset = _train_dataset(root)
        for seed in range(4):
            for same in (False, True):
                loss_rel, grad_rel, stats_rel, _, _, branches = _step_vs_cpu(
                    dataset, root / f"cpu{seed}{same:d}", seed, same)
                which = (f"the card's branches ({branches.differ} of "
                         f"{branches.total} choices the CPU would have "
                         "made otherwise)" if same else "its own branches")
                say("step-branches", f"model seed {seed}, the CPU on "
                    f"{which}: gradient relative L2 {grad_rel:.3e}, loss "
                    f"relative difference {loss_rel:.3e}, running "
                    f"statistics relative L2 {stats_rel:.3e} on {card}")


def stencil_calls():
    """The stencil kernel's yardstick across versions of the port: each
    stencil_conv call of the room request's forward timed alone, their
    sum, and their device time inside one forward (``_stencil_share``)."""
    card = phase_device()
    phase_build()
    model = MODEL.get("SparseConvUnet")(seed=SEED)
    net = random_weights(model.get_net(), SEED).eval().to(DEVICE)
    x = _scu_inputs(model, scu_scene(SCU_ROOM_EXTENT_M,
                                     model.cfg.num_points))[1]
    _say_conv_table(_conv_table(net, _capture_stencil_calls(net, x)))
    st_ms, wall_ms = _stencil_share(net, x)
    say("scu", f"the {SCU_FORWARD_LAUNCHES} stencil_conv calls inside one "
        f"room forward: {st_ms:.4f} device ms, in a {wall_ms:.2f} ms "
        f"forward on {card}")


def knn_calls():
    """The KNN kernels' yardstick across versions of the port: each
    knn_exact launch of one eval pyramid (1 x 45,056 uniform points, the
    eval phase's input) and each bucket_knn launch of one fused pyramid (4 x
    45,056, at the inference and the training budget) timed alone as the
    kernels phase times them, and their sums."""
    card = phase_device()
    phase_build()
    cfg = MODEL.get("RandLANet")().cfg
    rng = np.random.default_rng(0)
    eval_pts = torch.from_numpy(rng.uniform(
        -25, 25, (1, cfg.num_points, 3)).astype(np.float32)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    fused_pts = torch.rand((4, cfg.num_points, 3), generator=gen,
                           device=DEVICE) * 50 - 25
    eval_calls = _captured(tn, "knn_exact", lambda: tn.build_knn_pyramid(
        eval_pts, cfg.num_neighbors, cfg.sub_sampling_ratio))
    groups = [("eval", "knn_exact", [
        (f"level-{i}", args, kwargs)
        for i, (args, kwargs) in enumerate(eval_calls)])]
    for num_segs, gather_segs in ((cfg.infer_num_segs, cfg.infer_gather_segs),
                                  (cfg.num_segs, cfg.gather_segs)):
        groups.append((f"fused S{num_segs}", "bucket_knn", fused_searches(
            fused_pts, cfg, num_segs, gather_segs)))
    fns = {"knn_exact": ck.knn_exact, "bucket_knn": cb.knn_bucket}
    for group, kernel, calls in groups:
        times = []
        for label, args, kwargs in calls:
            times.append(device_ms(lambda: fns[kernel](*args, **kwargs)))
            say("knn-calls", f"{group} {kernel} {label} B={args[1].shape[0]} "
                f"Q={args[1].shape[1]}: device ms {times[-1]:.4f}")
        say("knn-calls", f"{group}: the {len(calls)} {kernel} launches, "
            f"device ms {sum(times):.4f} in all on {card}")


def main():
    if sys.argv[1:] == ["--step-branches"]:
        return step_branches()
    if sys.argv[1:] == ["--stencil-calls"]:
        return stencil_calls()
    if sys.argv[1:] == ["--knn-calls"]:
        return knn_calls()
    card = phase_device()
    model = MODEL.get("RandLANet")()
    phase_build()
    knn, gathers, bwds = phase_kernels(model.cfg)
    measured = {"bucket_knn": knn, "knn_exact": phase_knn_exact(model.cfg)}
    launches = phase_slice(model, card)
    # bucket_gather_bwd's launches are the training run's
    launches["bucket_gather_bwd"] = phase_train(card)["bucket_gather_bwd"]
    state = phase_eval(model, card)
    # knn_exact's launches are run_inference's, the main path of its slice
    launches["knn_exact"] = phase_inference(model, state, card)["knn_exact"]
    (scu_launches, measured["stencil_conv"], measured["stencil_match"],
     scu_gathers, scu_bwds) = phase_scu(card)
    measured["bucket_gather"] = bucket_summary(
        "bucket_gather", gathers + scu_gathers, "torch.gather")
    measured["bucket_gather_bwd"] = bucket_summary(
        "bucket_gather_bwd", bwds + scu_bwds, "scatter_add_")
    launches["stencil_conv"] = scu_launches["stencil_conv"]
    # stencil_match's launches are SCU training's, the main path of its
    # slice
    launches["stencil_match"] = phase_scu_train(card)["stencil_match"]
    sources = {"bucket_knn": ("open3d_ml_tpu_torch/csrc/bucket_knn.cu",
                              f"{TPU_KERNELS}:261"),
               "bucket_gather": ("open3d_ml_tpu_torch/csrc/bucket_gather.cu",
                                 f"{TPU_KERNELS}:428, {TPU_KERNELS}:408"),
               "bucket_gather_bwd": (
                   "open3d_ml_tpu_torch/csrc/bucket_gather_bwd.cu",
                   f"{TPU_KERNELS}:563, {TPU_KERNELS}:539"),
               "knn_exact": ("open3d_ml_tpu_torch/csrc/knn_exact.cu",
                             "open3d_ml_tpu/ops/pallas/knn.py:116"),
               "stencil_conv": ("open3d_ml_tpu_torch/csrc/stencil_conv.cu",
                                "open3d_ml_tpu/ops/pallas/stencil.py:264"),
               "stencil_match": ("open3d_ml_tpu_torch/csrc/stencil_match.cu",
                                 "open3d_ml_tpu/ops/pallas/stencil.py:147")}
    kernels = [json_entry(name, *sources[name], launches[name], rec)
               for name, rec in measured.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
