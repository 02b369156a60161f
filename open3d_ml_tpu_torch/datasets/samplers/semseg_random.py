"""Random cloud order and random nearest-neighbour patches.

Counterpart of ``open3d_ml_tpu/datasets/samplers/semseg_random.py``: each
epoch visits the clouds in a fresh random order; a patch is the
``num_points`` nearest points of a random centre (the whole cloud padded by
random repeats when it is smaller), shuffled, so that a model may take
pc[:n // r] as a random subsample. The JAX sampler's generator is unseeded;
this one takes an optional ``seed`` with the same default. The point
sampler draws from the ``rng`` it is called with, and ignores a
``radius`` (KPConv's ``in_radius``), as the JAX sampler does: KPConv
trains and validates on ``num_points``-nearest patches, not balls.
"""

import numpy as np

from ...utils.registry import SAMPLER


@SAMPLER.register_module()
class SemSegRandomSampler:

    def __init__(self, dataset, seed=None):
        self.dataset = dataset
        self.length = len(dataset)
        self.split = dataset.split
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.length

    def initialize_with_dataloader(self, dataloader):
        self.length = len(dataloader)

    def get_cloud_sampler(self):
        """Generator of cloud ids: a random permutation of the split."""

        def gen():
            for i in self.rng.permutation(self.length):
                yield int(i)

        return gen()

    @staticmethod
    def get_point_sampler():
        """The patch sampler that ``transform`` calls: (pc, num_points,
        search_tree, rng) -> (patch points, their indices, the centre)."""

        def _random_centered_gen(**kwargs):
            pc = kwargs.get("pc")
            num_points = kwargs.get("num_points")
            search_tree = kwargs.get("search_tree")
            rng = kwargs.get("rng") or np.random.default_rng()
            if pc is None or num_points is None or search_tree is None:
                raise KeyError("Provide pc, num_points and search_tree to "
                               "the SemSegRandomSampler point sampler")
            center_idx = rng.choice(len(pc), 1)
            center_point = pc[center_idx, :].reshape(1, -1)
            if pc.shape[0] < num_points:
                diff = num_points - pc.shape[0]
                idxs = np.concatenate([np.arange(pc.shape[0]),
                                       rng.choice(pc.shape[0], diff)])
            else:
                idxs = np.asarray(
                    search_tree.query(center_point, k=num_points)[1][0])
            rng.shuffle(idxs)
            return pc[idxs], idxs, center_point

        return _random_centered_gen
