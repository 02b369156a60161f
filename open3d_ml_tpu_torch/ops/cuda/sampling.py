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

import torch

from ._launch import check, ptr, raise_on, route, stream

LAUNCHES = {"fps": 0}

MAX_THREADS = 1024  # threads of the kernel's one block a cloud
MAX_PER_THREAD = 32  # points a thread holds the running minimum of
MAX_POINTS = MAX_THREADS * MAX_PER_THREAD


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


def fps_threads(n):
    """Threads of the kernel's block for clouds of ``n`` points: one a
    point up to ``MAX_THREADS`` (whole warps), and then ``MAX_THREADS``,
    each with up to ``MAX_PER_THREAD`` points."""
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"the fps kernel takes 1 to {MAX_POINTS} points a "
                         f"cloud, not {n}")
    return min(MAX_THREADS, 32 * -(-n // 32))


def fps(points, m, *, points_mask=None):
    """``fps_plain``'s contract, checked for both routes; on a CUDA device
    it launches the ``fps`` kernel, one block a cloud."""
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
    from ._build import library
    threads = fps_threads(n)
    out = torch.empty((b, m), dtype=torch.int32, device=dev)
    err = library().fps_launch(points.data_ptr(), ptr(points_mask),
                               out.data_ptr(), b, n, m, threads, stream())
    raise_on(err, "fps")
    LAUNCHES["fps"] += 1
    return out
