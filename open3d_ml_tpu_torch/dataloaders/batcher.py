"""Collate per-sample dicts into batched numpy arrays.

Counterpart of ``open3d_ml_tpu/dataloaders/batcher.py`` ``DefaultBatcher``
for the samples the port's models emit: dicts of fixed-shape arrays. The
per-level lists of a host-built pyramid are not ported.
"""

import numpy as np


class DefaultBatcher:
    """Stacks same-shaped numpy arrays along a new leading batch axis;
    other entries are collected into lists."""

    def collate_fn(self, batch):
        if len(batch) == 0:
            return {}
        elem = batch[0]
        if isinstance(elem, dict):
            return {key: self.collate_fn([b[key] for b in batch])
                    for key in elem}
        if isinstance(elem, np.ndarray):
            return np.stack(batch, axis=0)
        return list(batch)
