"""The port's host KD-tree (``nanoknn.cpp``), built with g++ and loaded with
ctypes.

Counterpart of ``open3d_ml_tpu/native/__init__.py`` ``NativeKDTree``: the
same C++ tree, so both packages give the same neighbours in the same order.
At first use the source is compiled with the JAX package's flags (``-O3
-std=c++17 -shared -fPIC -fopenmp``) into ``csrc/build/``, named by a hash
of the source and the flags; an unchanged source is loaded as it is. There
is no fallback: where the library cannot be built, ``library()`` raises,
since another search returns the neighbours of a radius query in another
order, and where a query has more than ``cap`` of them that order decides
which are kept.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "nanoknn.cpp"
BUILD = Path(__file__).resolve().parents[1] / "csrc" / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
# name -> (return type, argument types) of each C entry point
ENTRY_POINTS = {
    # points [n * 3], n -> a tree
    "kdtree_build": (ctypes.c_void_p, (_F, ctypes.c_int64)),
    "kdtree_free": (None, (ctypes.c_void_p,)),
    # tree, queries, q, k, out_idx [q * k], out_d2 [q * k]
    "kdtree_knn": (None, (ctypes.c_void_p, _F, ctypes.c_int64,
                          ctypes.c_int32, _I32, _F)),
    # tree, queries, q, radius, cap, out_idx [q * cap], out_counts [q]
    "kdtree_radius": (None, (ctypes.c_void_p, _F, ctypes.c_int64,
                             ctypes.c_float, ctypes.c_int32, _I32, _I32)),
}


def build():
    """Compile the library unless one of this source exists; its path."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    out = BUILD / f"libnanoknn_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    run = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{run.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def library():
    """The loaded KD-tree library, built at the first call."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _f32(arr):
    return arr.ctypes.data_as(_F)


def _i32(arr):
    return arr.ctypes.data_as(_I32)


class NativeKDTree:
    """KD-tree over [N, 3] float32 points with k-nearest and padded radius
    queries."""

    def __init__(self, points):
        self._lib = library()
        self._points = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
        self.n = self._points.shape[0]
        self._handle = self._lib.kdtree_build(_f32(self._points), self.n)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kdtree_free(self._handle)
            self._handle = None

    def query(self, queries, k=1):
        """(distances [Q, k] float32, indices [Q, k] int32), nearest first,
        as scipy's ``cKDTree.query``; where the tree holds fewer than k
        points the last columns repeat the nearest."""
        q = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
        out_i = np.empty((q.shape[0], k), np.int32)
        out_d = np.empty((q.shape[0], k), np.float32)
        self._lib.kdtree_knn(self._handle, _f32(q), q.shape[0], k,
                             _i32(out_i), _f32(out_d))
        return np.sqrt(out_d), out_i

    def query_radius_padded(self, queries, r, cap=4096, fill=None):
        """The points within ``r`` of each query, in the order the tree
        visits them: (indices [Q, cap] int32, counts [Q] int32). A query's
        first min(count, cap) entries are its neighbours and the rest hold
        ``fill`` (default n, the sentinel row); the counts are not capped."""
        q = np.ascontiguousarray(queries, np.float32).reshape(-1, 3)
        out_i = np.zeros((q.shape[0], cap), np.int32)
        out_c = np.zeros((q.shape[0],), np.int32)
        self._lib.kdtree_radius(self._handle, _f32(q), q.shape[0], r, cap,
                                _i32(out_i), _i32(out_c))
        pad = np.arange(cap, dtype=np.int32)[None, :] >= out_c[:, None]
        out_i[pad] = self.n if fill is None else fill
        return out_i, out_c
