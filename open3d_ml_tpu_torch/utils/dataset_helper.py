"""Disk cache of per-cloud preprocessing, and small file helpers.

Counterpart of ``open3d_ml_tpu/utils/dataset_helper.py``: a cache keyed by a
hash of the preprocess function's repr, one ``.npy`` file (a pickled dict)
per cloud. It reads back only files it wrote itself; the pickled objects
(a KD-tree among them) come from this program.
"""

import hashlib
import os
from pathlib import Path

import numpy as np


def make_dir(folder_name):
    """Create a directory and its parents if they do not exist."""
    Path(folder_name).mkdir(parents=True, exist_ok=True)


def get_hash(x: str):
    """Deterministic 64-bit integer hash of a string (md5)."""
    return int(hashlib.md5(x.encode()).hexdigest(), 16) & ((1 << 64) - 1)


class Cache:
    """``func``'s outputs cached on disk under ``cache_dir/cache_key``, by
    sample name."""

    def __init__(self, func, cache_dir, cache_key):
        self.func = func
        self.cache_dir = os.path.join(cache_dir, str(cache_key))
        make_dir(self.cache_dir)
        self.cached_ids = [p.stem for p in Path(self.cache_dir).glob("*.npy")]

    def __call__(self, unique_id, *data):
        """The cached output for ``unique_id``; on a miss, ``func(*data)``,
        written to the cache first."""
        fpath = os.path.join(self.cache_dir, f"{unique_id}.npy")
        if unique_id not in self.cached_ids or not os.path.exists(fpath):
            output = self.func(*data)
            np.save(fpath, np.array(output, dtype=object), allow_pickle=True)
            self.cached_ids.append(unique_id)
            return output
        return np.load(fpath, allow_pickle=True).item()
