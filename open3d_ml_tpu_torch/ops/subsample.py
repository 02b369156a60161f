"""Grid subsampling on the host, of one cloud or of a ragged batch.

Counterpart of ``open3d_ml_tpu/ops/subsample.py``. The one-cloud function
is ``DataProcessing.grid_subsampling`` (``datasets/utils/
dataprocessing.py``), the JAX module's numpy code; the batch function
runs it on each cloud of ``row_splits`` in turn, as the JAX one does.
"""

import numpy as np

from ..datasets.utils.dataprocessing import DataProcessing

grid_subsampling = DataProcessing.grid_subsampling


def grid_subsampling_batch(points, row_splits, features=None, labels=None,
                           grid_size=0.1):
    """``grid_subsampling`` of each cloud points[row_splits[i]:
    row_splits[i + 1]]. Returns (sub_points, sub_row_splits int64, then
    sub_features and sub_labels where given), concatenated over the
    clouds."""
    outs, feat_outs, lab_outs = [], [], []
    splits = [0]
    for i in range(len(row_splits) - 1):
        s, e = int(row_splits[i]), int(row_splits[i + 1])
        f = features[s:e] if features is not None else None
        lab = labels[s:e] if labels is not None else None
        res = grid_subsampling(points[s:e], features=f, labels=lab,
                               grid_size=grid_size)
        if not isinstance(res, tuple):
            res = (res,)
        outs.append(res[0])
        j = 1
        if features is not None:
            feat_outs.append(res[j])
            j += 1
        if labels is not None:
            lab_outs.append(res[j])
        splits.append(splits[-1] + res[0].shape[0])
    ret = [np.concatenate(outs, axis=0), np.asarray(splits, np.int64)]
    if features is not None:
        ret.append(np.concatenate(feat_outs, axis=0))
    if labels is not None:
        ret.append(np.concatenate(lab_outs, axis=0))
    return tuple(ret)
