"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources under ``open3d_ml_tpu_torch/csrc/`` have a plain C interface.
At first use each is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and the objects are linked into one shared library under
``csrc/build/``, named by a hash of the sources, their headers and the
flags, so an edited source builds anew and an unchanged one is loaded as
it is. Beside the library, ``<library>.ptxas.txt`` keeps what ptxas said
of each kernel (registers, spill bytes, shared memory): ``== <source>``
and then its lines.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = ("bucket_knn.cu", "bucket_gather.cu", "bucket_gather_bwd.cu",
           "knn_exact.cu", "stencil_conv.cu", "stencil_match.cu", "fps.cu",
           "nms_bev.cu", "trilinear_devoxelize.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types of each C entry point; each returns an int: the
# cudaError_t of its launch, for the *_shared ones a kernel's shared
# memory in bytes, for fps_max_clusters a cluster count
ENTRY_POINTS = {
    # points, queries, seg_ids, rel, d2, part_i, part_d, tickets, B, npad, Q,
    # nqb, S, seg_shift, qblock, k, qpt, threads, groups, span, shared,
    # stream
    "bucket_knn_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # values, seg_ids, rel, out, B, npad, Q, K, C, nqb, S, seg, qblock,
    # round_bf16, vec4, stream
    "bucket_gather_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P),
    # g, seg_ids, rel, dvalues, B, npad, Q, K, C, nqb, S, seg, qblock,
    # round_bf16, vec4, stream
    "bucket_gather_bwd_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P),
    # points, queries, mask (or NULL), idx, d2, B, N, Q, k, qpt, warps,
    # chunk, shared, stream
    "knn_exact_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P),
    # points, mask (or NULL), out, B, N, m, cluster, threads, stream
    "fps_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # values, keys, qkeys, seg_ids, w, out, B, V, npad, Q, K, Cin, Cout, nqb,
    # S, seg, qblock, route, ct, mw, stages, shared, stream
    "stencil_conv_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # keys, qkeys, seg_ids, rel, found, B, npad, Q, K, nqb, S, seg, qblock,
    # shared, stream
    "stencil_match_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P),
    # boxes, valid, mask, keep, R, N, threshold, stages, stream
    "nms_bev_launch": (_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _P),
    # coords, cell, perm, offsets, weights, counts, unsorted, partial, B,
    # N, r, stream
    "trilinear_devoxelize_plan_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _P),
    # grid, coords, perm, cell, out, B, N, r, C, stream
    "trilinear_devoxelize_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # g, perm, offsets, weights, dgrid, B, r, C, stream
    "trilinear_devoxelize_bwd_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # route, ct, mw, stages, qblock, K, S, seg
    "stencil_conv_shared": (_I, _I, _I, _I, _I, _I, _I, _I),
    # S, seg
    "stencil_match_shared": (_I, _I),
    # table rows
    "bucket_knn_shared": (_I,),
    # N, cluster, threads: cudaOccupancyMaxActiveClusters of fps_launch's
    # launch, or minus a cudaError
    "fps_max_clusters": (_I, _I, _I),
}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build():
    """Compile the kernels if no library for these sources exists yet.

    Returns (path of the library, seconds spent compiling; 0 when the
    library was already built)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the sources and the headers they include
    paths = [CSRC / name for name in SOURCES] + sorted(CSRC.glob("*.cuh"))
    for path in paths:
        digest.update(path.read_bytes())
    out = CSRC / "build" / f"libo3dtorch_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.with_suffix(f".{os.getpid()}.{name}.o") for name in SOURCES]
    logs = [obj.with_suffix(".log") for obj in objs]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        procs = []
        for name, obj, log in zip(SOURCES, objs, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                     str(CSRC / name)], stdout=f, stderr=subprocess.STDOUT))
        codes = [proc.wait() for proc in procs]
        said = [f"== {name}\n{log.read_text()}"
                for name, log in zip(SOURCES, logs)]
        failed = [name for name, code in zip(SOURCES, codes) if code]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" +
                               "".join(t for t, code in zip(said, codes)
                                       if code))
        subprocess.run([nvcc, "-shared", "-o", str(tmp),
                        *(str(obj) for obj in objs)], check=True)
        out.with_suffix(".ptxas.txt").write_text("".join(said))
    finally:
        for path in objs + logs:
            path.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


@functools.cache
def library():
    """The loaded kernel library, built at the first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
