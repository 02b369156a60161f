"""Drive the PyTorch port's paths once on one CUDA card and check them.

Four paths of RandLA-Net at the shipped SemanticKITTI config, with random
weights drawn from a seeded generator:

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
  is labelled.

The model is the port's ``RandLANet()`` at its defaults, which equal the
model section of ``open3d_ml_tpu/configs/randlanet_semantickitti.yml`` (a
CPU test pins that); nothing of the JAX package is imported.

Run from the root of the repository, with one card:

    python3 chip_smoke.py

Phases, one line each (or more), in this order:

1. device: the card's name and power limit; TF32 off for matmuls and
   convolutions.
2. build: compile the CUDA kernels from ``open3d_ml_tpu_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version on the card, at
   its path's shapes, and both times: device time per call (CUDA events
   around back-to-back calls queued ahead of the card), and beside it the
   host-inclusive span of one call (median of CUDA-event timings).
4. slice: the fused forward; the launch counts of one forward; sample 0
   against the same model on the CPU (float32: relative L2 <= 1e-4); the
   median forward time and points/s.
5. train: ``run_train`` for one epoch of 6 steps of 4 x 45,056 points and
   2 validation steps of 2 patches, on 8 + 2 synthetic scenes of 120,000
   points with the shipped class weights; the launch counts of every step;
   finite losses; a checkpoint, and a second ``run_train`` in a fresh
   pipeline that resumes from it with equal weights and Adam state; 10
   steps on one batch, whose loss must fall; one float32 step of 1 x
   11,264 points against the same step on the CPU; the median step time,
   points trained per second, the host's share and the peak memory.
6. eval: the same as slice for the eval net at B = 1.
7. inference: ``run_inference`` on the scan; its launch counts, patches,
   wall time and where it went, and points labelled per second.

Every path runs with the launch counts set to 0 just before it and read
just after. Any failed check raises, so the exit code is not 0. The
second-last line is a JSON record of the kernels, the last one ``{"ok":
true, "device": ...}``. There is no CPU fallback: without CUDA the script
fails first.
"""

import collections
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from open3d_ml_tpu_torch import MODEL
from open3d_ml_tpu_torch.dataloaders import (BatchLoader, DefaultBatcher,
                                             PointCloudDataloader)
from open3d_ml_tpu_torch.datasets import SyntheticShapes
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.ops import bucket as tb
from open3d_ml_tpu_torch.ops.cuda import _build
from open3d_ml_tpu_torch.ops.cuda import bucket as cb
from open3d_ml_tpu_torch.ops.cuda import knn as ck
from open3d_ml_tpu_torch.ops.morton import hilbert_sort
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
COUNTERS = (cb.LAUNCHES, ck.LAUNCHES)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def reset_counts():
    for counts in COUNTERS:
        for key in counts:
            counts[key] = 0


def read_counts():
    return {key: n for counts in COUNTERS for key, n in counts.items()}


def check_counts(phase, launches, expected):
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


def phase_build():
    path, seconds = _build.build()
    _build.library()
    say("build", f"{path.relative_to(REPO)} built in {seconds:.2f} s "
        "(0 = already built)")


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


def _knn_check(sp, sids, seg, qblock):
    """bucket_knn against its plain version on one level; returns
    (max |d2 difference|, kernel ms, plain ms)."""
    pcp = tb.pad_seg(sp, seg, fill=1e9)
    k = 16
    rel_k, d2_k = cb.knn_bucket(pcp, sp, sids, k, seg=seg, qblock=qblock)
    rel_p, d2_p = cb.knn_bucket_plain(pcp, sp, sids, k, seg=seg,
                                      qblock=qblock)
    torch.cuda.synchronize()
    if not torch.equal(d2_k, d2_p):
        raise AssertionError("bucket_knn: d2 differs from the plain version")
    rows = _differ_only_at_ties("bucket_knn", rel_k, rel_p, d2_p)
    err = (d2_k - d2_p).abs().max().item()
    ms, plain_ms, span, plain_span = timings(
        lambda: cb.knn_bucket(pcp, sp, sids, k, seg=seg, qblock=qblock),
        lambda: cb.knn_bucket_plain(pcp, sp, sids, k, seg=seg,
                                    qblock=qblock))
    say("kernels", f"bucket_knn B={sp.shape[0]} N={sp.shape[1]} "
        f"S={sids.shape[-1]} seg={seg} qblock={qblock} k={k}: rel equal on "
        f"{int((~rows).sum())}/{rows.numel()} rows ({int(rows.sum())} "
        f"differ at d2 ties), d2 equal; device ms: kernel {ms:.4f}, plain "
        f"{plain_ms:.4f}; call span ms: kernel {span:.4f}, plain "
        f"{plain_span:.4f}")
    return err, ms, plain_ms


def _gather_check(label, values, seg_ids, rel, seg, qblock):
    """bucket_gather against its plain version, rounding off and on;
    returns (max |difference|, kernel ms, plain ms) with rounding on."""
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
            f"span ms: kernel {span:.4f}, plain {plain_span:.4f}")
        out[round_bf16] = ((got - ref).abs().max().item(), ms, plain_ms)
    return out[True]


def _gather_bwd_check(label, seg_ids, rel, npad, c, seg, qblock, gen):
    """bucket_gather_bwd against its plain version at one shape, rounding
    off and on: bit-equal on dyadic cotangents (integers in [-4096, 4096]
    over 64, whose sums are exact in float32 in any order), and on random
    normal ones within the bound of float32 summation in any order,
    |err| <= n * 2^-24 * sum |g| over a row's n readers, of a float64
    reference. Returns (max |difference| on normal cotangents, kernel ms,
    plain ms) with rounding on."""
    dev = rel.device
    shape = (*rel.shape, c)
    dyadic = torch.randint(-4096, 4097, shape, generator=gen,
                           device=dev).float() / 64
    normal = torch.randn(shape, generator=gen, device=dev)
    readers = cb.gather_bucket_bwd_plain(
        torch.ones(shape, dtype=torch.float64, device=dev), seg_ids, rel,
        npad, seg=seg, qblock=qblock, round_bf16=False)
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
        bound = readers * 2.0 ** -24 * abs_sum
        if (err > bound).any():
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
            f"{span:.4f}, plain {plain_span:.4f}")
        out[round_bf16] = (err.max().item(), ms, plain_ms)
    return out[True]


def phase_kernels(model_cfg):
    """The kernels against their plain versions at the main paths' shapes:
    the level-0 search at the inference and the training budget; one
    neighbour, pool and upsample gather from the inference pyramid of the
    same batch and the level-0 neighbour gather from its training pyramid;
    the gather backward at four shapes of the training step."""
    dev = torch.device(DEVICE)
    b, n = 4, model_cfg.num_points
    seg, qblock = model_cfg.seg, model_cfg.block
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((b, n, 3), generator=gen, device=dev) * 50 - 25
    _, sp = hilbert_sort(pts)
    knns = [_knn_check(sp, tb.select_segments(sp, sp, seg=seg, qblock=qblock,
                                              num_segs=num_segs), seg, qblock)
            for num_segs in (model_cfg.infer_num_segs, model_cfg.num_segs)]
    knn = knns[0]

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
        _gather_check(label, values(rows, c), *tables(pyr, name, level))
        for label, level, name, rows, c in (
            ("neighbour", 1, "nbr", n1, 35), ("pool", 1, "pool", n1, 128),
            ("upsample", 3, "up", n3 // 4, 512))]
    gather = (max(g[0] for g in gathers), sum(g[1] for g in gathers),
              sum(g[2] for g in gathers))
    say("kernels", f"bucket_gather, three shapes at round_bf16=True: device "
        f"ms: kernel {gather[1]:.4f}, plain {gather[2]:.4f} in all")
    _gather_check("training level-0 neighbour", values(n, 11),
                  *tables(train_pyr, "nbr", 0))

    # the largest gather of a training step (3 coords + 8 features at level
    # 0) and the three shapes above, at the training budget
    bwds = []
    for label, name, level, rows, c in (
            ("level-0 neighbour", "nbr", 0, n, 11),
            ("level-1 neighbour", "nbr", 1, n1, 35),
            ("level-1 pool", "pool", 1, n1, 128),
            ("level-3 upsample", "up", 3, n3 // 4, 512)):
        sids, rel, _, qb = tables(train_pyr, name, level)
        bwds.append(_gather_bwd_check(label, sids, rel, -(-rows // seg) * seg,
                                      c, seg, qb, gen))
    bwd = (max(g[0] for g in bwds), sum(g[1] for g in bwds),
           sum(g[2] for g in bwds))
    say("kernels", f"bucket_gather_bwd, four shapes at round_bf16=True: "
        f"device ms: kernel {bwd[1]:.4f}, plain {bwd[2]:.4f} in all")
    return {"bucket_knn": knn, "bucket_gather": gather,
            "bucket_gather_bwd": bwd}


def phase_knn_exact(model_cfg):
    """knn_exact against its plain version at the eval pyramid's two
    largest levels, one sample of seeded uniform points; returns (max |d2
    difference|, kernel ms, plain ms) at level 0. The plain version's time
    is its call span: it launches about 18 kernels per block of queries,
    more than the host can queue ahead while the card sleeps, and each
    block's device work outlasts its launches."""
    dev = torch.device(DEVICE)
    k = model_cfg.num_neighbors
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((1, model_cfg.num_points, 3), generator=gen,
                     device=dev) * 50 - 25
    out = []
    for level in (0, 1):
        n = pts.shape[1] // 4 ** level
        sub = pts[:, :n].contiguous()
        idx_k, d2_k = ck.knn_exact(sub, sub, k)
        idx_p, d2_p = ck.knn_exact_plain(sub, sub, k)
        torch.cuda.synchronize()
        if not torch.equal(d2_k, d2_p):
            raise AssertionError(f"knn_exact level {level}: d2 differs from "
                                 "the plain version")
        rows = _differ_only_at_ties("knn_exact", idx_k, idx_p, d2_p)
        note = ""
        if level == 1:
            # the plain version on the CPU gives the same bits
            idx_c, d2_c = ck.knn_exact_plain(sub.cpu(), sub.cpu(), k)
            if not torch.equal(d2_c, d2_k.cpu()):
                raise AssertionError("knn_exact: card d2 differs from the "
                                     "CPU's")
            crows = _differ_only_at_ties("knn_exact CPU", idx_k.cpu(), idx_c,
                                         d2_c)
            note = (f"; against the CPU's plain version: d2 equal, indices "
                    f"differ on {int(crows.sum())} rows at d2 ties")
        ms = device_ms(lambda: ck.knn_exact(sub, sub, k))
        span = span_ms(lambda: ck.knn_exact(sub, sub, k))
        plain_span = span_ms(lambda: ck.knn_exact_plain(sub, sub, k),
                             iters=5, warmup=1)
        say("kernels", f"knn_exact level {level} B=1 N=Q={n} k={k}: d2 equal, "
            f"indices equal on {int((~rows).sum())}/{rows.numel()} rows "
            f"({int(rows.sum())} differ at d2 ties){note}; kernel device ms "
            f"{ms:.4f}, call span ms: kernel {span:.4f}, plain "
            f"{plain_span:.4f}")
        out.append(((d2_k - d2_p).abs().max().item(), ms, plain_span))
    return max(e for e, _, _ in out), out[0][1], out[0][2]


def random_weights(net, seed):
    """Seeded random weights, with BN statistics that are not the
    identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** .5)
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


def _check_steps(record, first, last):
    """Launch counts and finite losses of every step in record[first:last];
    returns the train steps' times (s)."""
    train_s = []
    for kind, t0, t1, launches, loss in record[first:last]:
        expected = (TRAIN_STEP_LAUNCHES if kind == "train" else
                    EXPECTED_LAUNCHES)
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


def _overfit(pipeline, dataset):
    """10 training steps on one fixed batch of the train split; returns the
    losses."""
    model = pipeline.model
    split = dataset.get_split("train")
    loader = PointCloudDataloader(split, preprocess=model.preprocess,
                                  transform=model.transform,
                                  sampler=split.sampler, use_cache=True)
    model.trans_point_sampler = split.sampler.get_point_sampler()
    batch = next(iter(BatchLoader(loader, 4, DefaultBatcher(), num_workers=0,
                                  sampler=split.sampler)))
    inputs = pipeline._device_batch(batch)
    loss_fn = SemSegLoss(pipeline, model, dataset)
    return [float(pipeline._train_step(inputs, loss_fn)[0])
            for _ in range(10)]


def _rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def _step_vs_cpu(dataset, root):
    """One float32 training step, 1 x 11,264 points, full widths, the
    training budget, on the card and on the CPU from the same weights,
    batch and dropout mask. Returns (loss relative difference, gradient
    relative L2, running statistics relative L2, parameter relative L2
    after the Adam step, CPU step seconds)."""
    n = 11_264
    out = {}
    model = MODEL.get("RandLANet")(compute_dtype="float32", num_points=n)
    split = dataset.get_split("train")
    loader = PointCloudDataloader(split, preprocess=model.preprocess,
                                  transform=model.transform,
                                  sampler=split.sampler, use_cache=True)
    model.trans_point_sampler = split.sampler.get_point_sampler()
    batch = DefaultBatcher().collate_fn([loader[0]])
    keep = torch.rand((1, n, 32),
                      generator=torch.Generator().manual_seed(SEED)) >= 0.5
    state = None
    for device in (DEVICE, "cpu"):
        pipeline = SemanticSegmentation(model, dataset=dataset, device=device,
                                        seed=SEED, main_log_dir=str(root),
                                        **TRAIN_PIPELINE)
        if state is None:
            state = {k: v.cpu() for k, v in pipeline.net.state_dict().items()}
        pipeline.net.load_state_dict(state)
        pipeline.net.dropout = _FixedDropout(keep)
        pipeline.optimizer, pipeline.scheduler = model.get_optimizer(
            pipeline.cfg, pipeline.net)
        t0 = time.perf_counter()
        loss, _ = pipeline._train_step(pipeline._device_batch(batch),
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
    gpu, cpu = out[DEVICE], out["cpu"]
    return ((abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])).item(),
            _rel_l2(gpu["grad"], cpu["grad"]),
            _rel_l2(gpu["stats"], cpu["stats"]),
            _rel_l2(gpu["params"], cpu["params"]), cpu["seconds"])


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

        loss_rel, grad_rel, stats_rel, param_rel, cpu_s = _step_vs_cpu(
            dataset, root / "cpu")
        say("train", f"one float32 step B=1 N=11264, card vs CPU: loss "
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
    return state


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


def main():
    card = phase_device()
    model = MODEL.get("RandLANet")()
    phase_build()
    measured = phase_kernels(model.cfg)
    measured["knn_exact"] = phase_knn_exact(model.cfg)
    launches = phase_slice(model, card)
    # bucket_gather_bwd's launches are the training run's
    launches["bucket_gather_bwd"] = phase_train(card)["bucket_gather_bwd"]
    state = phase_eval(model, card)
    # knn_exact's launches are run_inference's, the main path of its slice
    launches["knn_exact"] = phase_inference(model, state, card)["knn_exact"]
    sources = {"bucket_knn": ("open3d_ml_tpu_torch/csrc/bucket_knn.cu",
                              f"{TPU_KERNELS}:261"),
               "bucket_gather": ("open3d_ml_tpu_torch/csrc/bucket_gather.cu",
                                 f"{TPU_KERNELS}:428, {TPU_KERNELS}:408"),
               "bucket_gather_bwd": (
                   "open3d_ml_tpu_torch/csrc/bucket_gather_bwd.cu",
                   f"{TPU_KERNELS}:563, {TPU_KERNELS}:539"),
               "knn_exact": ("open3d_ml_tpu_torch/csrc/knn_exact.cu",
                             "open3d_ml_tpu/ops/pallas/knn.py:116")}
    kernels = []
    for name, (err, ms, plain_ms) in measured.items():
        source, replaces = sources[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
