"""Host-side data processing: grid subsampling.

Counterpart of ``open3d_ml_tpu/datasets/utils/dataprocessing.py``
``DataProcessing.grid_subsampling``, whose body is the numpy sort-reduce of
``open3d_ml_tpu/ops/subsample.py``; the same numpy operations in the same
order give the same bits.
"""

import numpy as np


class DataProcessing:

    @staticmethod
    def grid_subsampling(points, features=None, labels=None, grid_size=0.1):
        """Barycenter grid subsampling: the points of one voxel of edge
        ``grid_size`` become their barycenter, their features the mean and
        their labels the majority vote (ties to the larger label id).

        points [N, 3] float32, features [N, D] or None, labels [N] or None.
        Returns sub_points, then sub_features and sub_labels where given;
        a single array when neither is.
        """
        points = np.asarray(points, np.float32)
        coords = np.floor((points - points.min(axis=0)) / grid_size)
        coords = coords.astype(np.int64)
        dims = coords.max(axis=0) + 1
        key = (coords[:, 2] * dims[1] + coords[:, 1]) * dims[0] + coords[:, 0]

        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        nv = uniq.shape[0]
        denom = counts[:, None].astype(np.float32)

        sub_points = np.zeros((nv, 3), np.float64)
        np.add.at(sub_points, inv, points.astype(np.float64))
        sub_points = (sub_points / denom).astype(np.float32)

        out = [sub_points]
        if features is not None:
            features = np.asarray(features)
            sub_feat = np.zeros((nv, features.shape[1]), np.float64)
            np.add.at(sub_feat, inv, features.astype(np.float64))
            out.append((sub_feat / denom).astype(np.float32))
        if labels is not None:
            labels = np.asarray(labels).reshape(-1).astype(np.int64)
            # majority vote per voxel: count (voxel, label) pairs
            nl = int(labels.max()) + 1 if labels.size else 1
            pair = inv.astype(np.int64) * nl + labels
            pair_uniq, pair_counts = np.unique(pair, return_counts=True)
            vox = pair_uniq // nl
            lab = pair_uniq % nl
            # sorted by (voxel, count, label), the last entry per voxel wins
            order = np.lexsort((lab, pair_counts, vox))
            vox_o, lab_o = vox[order], lab[order]
            last = np.concatenate([vox_o[1:] != vox_o[:-1], [True]])
            sub_labels = np.zeros((nv,), np.int32)
            sub_labels[vox_o[last]] = lab_o[last].astype(np.int32)
            out.append(sub_labels)
        if len(out) == 1:
            return out[0]
        return tuple(out)
