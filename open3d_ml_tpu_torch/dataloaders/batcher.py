"""Collate per-sample dicts into batched numpy arrays.

Counterpart of ``open3d_ml_tpu/dataloaders/batcher.py`` ``DefaultBatcher``
for the samples the port's models emit: arrays of one shape stack along a
new batch axis; dicts collate key by key (a detection sample's calib dict
becomes a dict of stacked arrays); lists of arrays of one length in every
sample (the per-level arrays of KPConv's host-built pyramid) collate level
by level into a list of stacked arrays; ints (a detection sample's point
count) become an int64 array; anything else, as a sample's list of
``BEVBox3D``, is collected into a list of one entry per sample.
"""

import numpy as np


class DefaultBatcher:
    """Stacks same-shaped numpy arrays along a new leading batch axis."""

    def collate_fn(self, batch):
        if len(batch) == 0:
            return {}
        elem = batch[0]
        if isinstance(elem, dict):
            return {key: self.collate_fn([b[key] for b in batch])
                    for key in elem}
        if isinstance(elem, (list, tuple)):
            if (len(elem) > 0 and isinstance(elem[0], np.ndarray) and
                    all(len(b) == len(elem) for b in batch)):
                return [self.collate_fn([b[i] for b in batch])
                        for i in range(len(elem))]
            return list(batch)
        if isinstance(elem, np.ndarray):
            return np.stack(batch, axis=0)
        if isinstance(elem, (int, np.integer)):
            return np.asarray(batch, np.int64)
        return list(batch)
