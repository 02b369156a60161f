"""Spatially regular patch sampler driven by per-point possibility maps.

Counterpart of ``open3d_ml_tpu/datasets/samplers/semseg_spatially_regular.py``:
every point of a cloud carries a possibility score; a patch is centred on
the least covered point; its points gain (1 - d^2 / max d^2)^2; a cloud is
done when its least possibility exceeds 0.5. A patch is the ``num_points``
nearest points of the centre or, when the caller gives a ``radius``
(KPConv's ``in_radius``), every point within it (a ball). The JAX sampler
draws from an unseeded generator; this one takes an optional ``seed``
with the same default.
"""

import numpy as np

from ...utils.registry import SAMPLER

TRAIN_SPLITS = ("train", "training", "valid", "validation")


@SAMPLER.register_module()
class SemSegSpatiallyRegularSampler:

    def __init__(self, dataset, seed=None):
        self.dataset = dataset
        self.length = len(dataset)
        self.split = dataset.split
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
        """Generator of cloud ids. On a training or validation split,
        ``length`` draws, each the cloud whose least possibility is lowest;
        on any other, each cloud in turn until it is covered."""

        def gen_train():
            for _ in range(self.length):
                self.cloud_id = int(np.argmin(self.min_possibilities))
                yield self.cloud_id

        def gen_test():
            curr = 0
            while curr < self.length:
                if self.min_possibilities[curr] > 0.5:
                    curr += 1
                    continue
                self.cloud_id = curr
                yield self.cloud_id

        return gen_train() if self.split in TRAIN_SPLITS else gen_test()

    def get_point_sampler(self):
        """The patch sampler that ``transform`` calls with keywords ``pc``,
        ``num_points``, ``radius``, ``search_tree`` and ``rng``: (patch
        points, their indices, the centre). With ``radius`` the patch is
        the ball, from a scipy ``cKDTree`` (``query_ball_point``) or an
        sklearn-style tree (``query_radius``); a centre with fewer than 2
        points in it gains 0.001 and the next least covered point is
        tried. ``patchwise=False`` marks the whole cloud covered and
        returns None. Raises KeyError without ``pc``, or without both
        ``search_tree`` and ``radius``."""

        def _sampler(patchwise=True, **kwargs):
            if not patchwise:
                self.possibilities[self.cloud_id][:] = 1.0
                self.min_possibilities[self.cloud_id] = 1.0
                return None
            pc = kwargs.get("pc")
            num_points = kwargs.get("num_points")
            radius = kwargs.get("radius")
            search_tree = kwargs.get("search_tree")
            rng = kwargs.get("rng") or self.rng
            if pc is None or (search_tree is None and radius is None):
                raise KeyError("Provide pc and (search_tree or radius) to "
                               "the spatially-regular point sampler")

            cid = self.cloud_id
            n = 0
            while n < 2:
                center_id = int(np.argmin(self.possibilities[cid]))
                center_point = pc[center_id, :].reshape(1, -1)
                if radius is not None:
                    if hasattr(search_tree, "query_radius"):
                        idxs = search_tree.query_radius(center_point,
                                                        r=radius)[0]
                    else:
                        idxs = np.asarray(search_tree.query_ball_point(
                            center_point[0], r=radius), dtype=np.int64)
                elif num_points is not None:
                    if pc.shape[0] < num_points:
                        diff = num_points - pc.shape[0]
                        idxs = np.concatenate([
                            np.arange(pc.shape[0]),
                            rng.choice(pc.shape[0], diff)])
                    else:
                        idxs = np.asarray(search_tree.query(
                            center_point, k=num_points)[1][0])
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
