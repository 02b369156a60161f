"""Furthest point sampling: the CUDA kernel, its plain version and the
wrapper that ``ops/sampling.py`` calls.

The wrapper takes the plain version for tensors on the CPU and launches
the ``fps`` kernel (``csrc/fps.cu``) for tensors on a CUDA device; it has
no other route. ``LAUNCHES`` counts the kernel launches, one a call.

The contract is the JAX package's ``furthest_point_sampling``
(``open3d_ml_tpu/ops/sampling.py``): start at index 0; each step takes
d = (dx*dx + dy*dy) + dz*dz of every point to the last chosen one,
dist = min(dist, d), and chooses the argmax of dist, the lowest index
first among equal values; a masked point carries dist = -1, so it is never
chosen while a valid point is left. The plain version writes each product
and sum as its own elementwise op, and the kernel computes the same with
explicit round-to-nearest intrinsics, so both choose the same points.
"""

import functools

import torch

from ._launch import check, ptr, raise_on, route, stream

LAUNCHES = {"fps": 0}

MAX_POINTS = 32_768  # points a cloud
MAX_THREADS = 1024  # threads of a CTA
PER_THREAD = 2  # points a thread holds in registers, where the plan can
MAX_PER_THREAD = 8  # points a thread holds in registers, at most
CLUSTERS = (1, 2, 4, 8, 16)  # CTAs a cloud (16 is a non-portable size)
# the plan's split: one CTA up to ONE_CTA points, else the least cluster
# of CTAs of up to CTA_POINTS points (16 CTAs at most). On the H100 a
# cluster's exchange costs more than it saves below 4,096 points, and
# 16 CTAs of 1,024 points beat 8 of 2,048 and 4 of 4,096 at 16,384
ONE_CTA = 4096
CTA_POINTS = 1024


def fps_plain(points, m, *, points_mask=None):
    """FPS of each cloud: points [B, N, 3] float32, points_mask [B, N]
    bool or None -> [B, m] int32 indices. A loop of m - 1 steps, each a
    pass over [B, N]."""
    b, n, _ = points.shape
    dist = torch.full((b, n), float("inf"), device=points.device)
    if points_mask is not None:
        dist = torch.where(points_mask, dist, -1.0)
    out = torch.zeros((b, m), dtype=torch.int32, device=points.device)
    rows = torch.arange(b, device=points.device)
    last = torch.zeros(b, dtype=torch.long, device=points.device)
    for s in range(1, m):
        diff = points - points[rows, last][:, None]
        d = ((diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) +
             diff[..., 2] * diff[..., 2])
        if points_mask is not None:
            d = torch.where(points_mask, d, -1.0)
        dist = torch.minimum(dist, d)
        last = dist.argmax(dim=1)
        out[:, s] = last.int()
    return out


def fps_plan(n, cluster=None):
    """(CTAs a cloud, threads a CTA) of the kernel for clouds of ``n``
    points: one CTA up to ``ONE_CTA`` points, else the least cluster in
    ``CLUSTERS`` whose CTAs hold at most ``CTA_POINTS`` points each (the
    largest where none does), unless ``cluster`` names one; and whole
    warps of ``PER_THREAD`` points a thread, up to ``MAX_THREADS`` threads
    of up to ``MAX_PER_THREAD`` points."""
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"the fps kernel takes 1 to {MAX_POINTS} points a "
                         f"cloud, not {n}")
    if cluster is None:
        cluster = 1 if n <= ONE_CTA else next(
            (c for c in CLUSTERS if -(-n // c) <= CTA_POINTS), CLUSTERS[-1])
    elif cluster not in CLUSTERS:
        raise ValueError(f"fps clusters are {CLUSTERS}, not {cluster}")
    per_cta = -(-n // cluster)
    threads = min(MAX_THREADS, 32 * -(-per_cta // (32 * PER_THREAD)))
    if per_cta > threads * MAX_PER_THREAD:
        raise ValueError(f"fps: {n} points need more than {MAX_THREADS} "
                         f"threads of {MAX_PER_THREAD} points a CTA in "
                         f"clusters of {cluster}")
    return cluster, threads


@functools.cache
def max_clusters(device, cluster, threads, n):
    """``cudaOccupancyMaxActiveClusters`` of the kernel's launch for clouds
    of ``n`` points in clusters of ``cluster`` CTAs of ``threads`` on CUDA
    device ``device``; raises where it is 0 (the card cannot run the
    launch) or the query fails."""
    from ._build import library
    with torch.cuda.device(device):
        got = library().fps_max_clusters(n, cluster, threads)
    if got < 0:
        raise RuntimeError(f"fps: the cluster occupancy query failed: "
                           f"cudaError {-got}")
    if got == 0:
        raise RuntimeError(f"fps: no cluster of {cluster} CTAs of "
                           f"{threads} threads fits on the card")
    return got


def fps(points, m, *, points_mask=None):
    """``fps_plain``'s contract, checked for both routes; on a CUDA device
    it launches the ``fps`` kernel, one thread-block cluster a cloud
    (``fps_plan``)."""
    dev = points.device
    check(points, "points", torch.float32, 3, dev)
    b, n, _ = points.shape
    if points.shape[2] != 3:
        raise ValueError(f"points [B,N,3]: got {tuple(points.shape)}")
    if points_mask is not None:
        check(points_mask, "points_mask", torch.bool, 2, dev)
        if points_mask.shape != (b, n):
            raise ValueError(f"points_mask {tuple(points_mask.shape)}, "
                             f"expected {(b, n)}")
    if not (b >= 1 and n >= 1 and m >= 1):
        raise ValueError(f"fps needs B, N, m >= 1: got B {b}, N {n}, m {m}")
    if route(points, "fps") == "plain":
        return fps_plain(points, m, points_mask=points_mask)
    if b > 65535:
        raise ValueError(f"the fps kernel takes up to 65535 clouds, not {b}")
    from ._build import library
    cluster, threads = fps_plan(n)
    max_clusters(dev.index, cluster, threads, n)
    out = torch.empty((b, m), dtype=torch.int32, device=dev)
    err = library().fps_launch(points.data_ptr(), ptr(points_mask),
                               out.data_ptr(), b, n, m, cluster, threads,
                               stream())
    raise_on(err, "fps")
    LAUNCHES["fps"] += 1
    return out
