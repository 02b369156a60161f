"""Spatially regular patch sampler driven by per-point possibility maps.

Counterpart of ``open3d_ml_tpu/datasets/samplers/semseg_spatially_regular.py``:
every point of a cloud carries a possibility score; a patch is centred on
the least covered point; its points gain (1 - d^2 / max d^2)^2; a cloud is
done when its least possibility exceeds 0.5. The JAX sampler draws from an
unseeded generator; this one takes an optional ``seed`` with the same
default. The training splits' cloud order and the radius (ball) patches
of KPConv are not ported.
"""

import numpy as np

from ...utils.registry import SAMPLER


@SAMPLER.register_module()
class SemSegSpatiallyRegularSampler:

    def __init__(self, dataset, seed=None):
        self.dataset = dataset
        self.length = len(dataset)
        self.rng = np.random.default_rng(seed)
        self.cloud_id = 0

    def __len__(self):
        return self.length

    def initialize_with_dataloader(self, dataloader):
        """Draw a small random possibility for every point of every cloud
        of the dataloader's split."""
        self.possibilities = []
        self.min_possibilities = []
        self.length = len(dataloader)
        dataset = self.dataset
        for index in range(len(dataset)):
            data = dataset.get_data(index)
            if dataloader.preprocess is not None:
                data = dataloader.preprocess(data, dataset.get_attr(index))
            n = data["point"].shape[0]
            self.possibilities.append(self.rng.random(n) * 1e-3)
            self.min_possibilities.append(
                float(np.min(self.possibilities[-1])))

    def get_cloud_sampler(self):
        """Generator of the test split's cloud ids: each cloud in turn
        until it is covered."""
        curr = 0
        while curr < self.length:
            if self.min_possibilities[curr] > 0.5:
                curr += 1
                continue
            self.cloud_id = curr
            yield self.cloud_id

    def get_point_sampler(self):
        """The patch sampler that ``transform`` calls: (pc, num_points,
        search_tree, rng) -> (patch points, their indices, the centre)."""

        def _sampler(pc, num_points, search_tree, rng=None, **kwargs):
            rng = rng or self.rng
            cid = self.cloud_id
            n = 0
            while n < 2:
                center_id = int(np.argmin(self.possibilities[cid]))
                center_point = pc[center_id, :].reshape(1, -1)
                if pc.shape[0] < num_points:
                    diff = num_points - pc.shape[0]
                    idxs = np.concatenate([np.arange(pc.shape[0]),
                                           rng.choice(pc.shape[0], diff)])
                else:
                    idxs = np.asarray(search_tree.query(center_point,
                                                        k=num_points)[1][0])
                n = len(idxs)
                if n < 2:
                    self.possibilities[cid][center_id] += 0.001

            idxs = np.asarray(idxs)
            rng.shuffle(idxs)
            patch = pc[idxs]
            dists = np.sum(
                np.square((patch - center_point).astype(np.float32)), axis=1)
            delta = np.square(1 - dists / np.max(dists))
            self.possibilities[cid][idxs] += delta
            self.min_possibilities[cid] = float(
                np.min(self.possibilities[cid]))
            return patch, idxs, center_point

        return _sampler
