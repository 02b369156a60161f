"""Drive the PyTorch port's paths once on one CUDA card and check them.

Three paths of RandLA-Net inference at the shipped SemanticKITTI config,
with random weights drawn from a seeded generator:

* the fused path: a batch of 4 patches of 45,056 points through the fused
  bucket pyramid and the network (``get_net``);
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
5. eval: the same for the eval net at B = 1.
6. inference: ``run_inference`` on the scan; its launch counts, patches,
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
import time
from pathlib import Path

import numpy as np
import torch

from open3d_ml_tpu_torch import MODEL
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
EXPECTED_LAUNCHES = {"bucket_knn": 5, "bucket_gather": 16, "knn_exact": 0}
SCAN_POINTS = 120_000  # about one SemanticKITTI scan
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


def phase_kernels(model_cfg):
    """Both kernels against their plain versions at the main path's
    shapes: the level-0 search, and one neighbour, pool and upsample gather
    from the pyramid of the same batch."""
    dev = torch.device(DEVICE)
    b, n = 4, model_cfg.num_points
    seg, qblock = model_cfg.seg, model_cfg.block
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((b, n, 3), generator=gen, device=dev) * 50 - 25
    _, sp = hilbert_sort(pts)
    sids = tb.select_segments(sp, sp, seg=seg, qblock=qblock,
                              num_segs=model_cfg.infer_num_segs)
    knn = _knn_check(sp, sids, seg, qblock)

    pyr = tb.build_bucket_pyramid(
        pts, model_cfg.num_neighbors, model_cfg.sub_sampling_ratio, seg=seg,
        qblock=qblock, num_segs=model_cfg.infer_num_segs,
        gather_segs=model_cfg.infer_gather_segs)

    def values(rows, c):
        return tb.pad_seg(torch.randn((b, rows, c), generator=gen,
                                      device=dev), seg)

    n1, n3 = (pyr["coords"][i].shape[1] for i in (1, 3))
    # level 1's first neighbour gather (3 coords + 32 features), its pool
    # gather (2 * 64 channels) and the decoder's first upsample (level 4's
    # 2 * 256 channels onto level 3)
    gathers = [
        _gather_check(label, values(rows, c), pyr[f"{name}_seg_ids"][level],
                      pyr[f"{name}_rel"][level], seg,
                      pyr[f"{name}_qblock"][level])
        for label, level, name, rows, c in (
            ("neighbour", 1, "nbr", n1, 35), ("pool", 1, "pool", n1, 128),
            ("upsample", 3, "up", n3 // 4, 512))]
    gather = (max(g[0] for g in gathers), sum(g[1] for g in gathers),
              sum(g[2] for g in gathers))
    say("kernels", f"bucket_gather, three shapes at round_bf16=True: device "
        f"ms: kernel {gather[1]:.4f}, plain {gather[2]:.4f} in all")
    return {"bucket_knn": knn, "bucket_gather": gather}


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
    check_counts("eval", launches, {"bucket_knn": 0, "bucket_gather": 0,
                                    "knn_exact": model_cfg.num_layers})
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
    pipeline.net.load_state_dict(state)
    spent = collections.Counter()
    for name in ("preprocess", "transform", "update_probs"):
        setattr(model, name, _timed(getattr(model, name), spent, name))
    pipeline.net.forward = _timed(pipeline.net.forward, spent, "forward",
                                  sync=True)
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
    check_counts("inference", launches, {
        "bucket_knn": 0, "bucket_gather": 0,
        "knn_exact": model_cfg.num_layers * forwards})
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
    state = phase_eval(model, card)
    # knn_exact's launches are run_inference's, the main path of its slice
    launches["knn_exact"] = phase_inference(model, state, card)["knn_exact"]
    sources = {"bucket_knn": ("open3d_ml_tpu_torch/csrc/bucket_knn.cu",
                              f"{TPU_KERNELS}:261"),
               "bucket_gather": ("open3d_ml_tpu_torch/csrc/bucket_gather.cu",
                                 f"{TPU_KERNELS}:428, {TPU_KERNELS}:408"),
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
