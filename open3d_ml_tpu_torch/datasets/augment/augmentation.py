"""Host-side point cloud augmentation (numpy).

Counterpart of ``open3d_ml_tpu/datasets/augment/augmentation.py``
``SemsegAugmentation`` with the steps of the training recipe: ``recenter``,
``normalize``, ``rotate``, ``scale`` and ``noise``. Random steps draw from
``rng``, a ``numpy.random.Generator`` made from ``seed`` (a generator
passed as the seed is used as it is, so the model's generator drives
them). The other augmentations of the JAX package raise.
"""

import warnings

import numpy as np


class SemsegAugmentation:
    """Semantic segmentation augmentation."""

    _PORTED = ("recenter", "normalize", "rotate", "scale", "noise")

    def __init__(self, cfg, seed=None):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def recenter(data, cfg):
        """Subtract the mean over the axes ``cfg["dim"]``, in place."""
        if not cfg:
            return data
        dim = cfg.get("dim", [0, 1, 2])
        data[:, dim] = data[:, dim] - data.mean(0)[dim]
        return data

    @staticmethod
    def normalize(pc, feat, cfg):
        """Linear normalisation of the points (centred, scaled by the
        largest extent) and of the features (bias, scale), in place."""
        if "points" in cfg:
            method = cfg["points"].get("method", "linear")
            if method != "linear":
                raise ValueError(f"Unsupported normalize method: {method}")
            pc -= pc.mean(0)
            pc /= (pc.max(0) - pc.min(0)).max()
        if "feat" in cfg and feat is not None:
            cfg_f = cfg["feat"]
            if cfg_f.get("method", "linear") != "linear":
                raise ValueError("Unsupported feat normalize method")
            feat -= cfg_f.get("bias", 0)
            feat /= cfg_f.get("scale", 1)
        return pc, feat

    def rotate(self, pc, cfg):
        """Rotate about the vertical axis by a random angle
        (``method="vertical"``, the only one ported)."""
        if np.abs(pc[:, :2].mean()) > 1e-2:
            warnings.warn("Recenter pointcloud before calling rotate.")
        method = cfg.get("method", "vertical")
        if method != "vertical":
            raise NotImplementedError(f"rotate method {method!r} is not "
                                      "ported; the port runs 'vertical'")
        theta = self.rng.random() * 2 * np.pi
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        return np.matmul(pc, rot)

    def scale(self, pc, cfg):
        """Scale by a random factor in [min_s, max_s), one per axis when
        ``scale_anisotropic``."""
        min_s = cfg.get("min_s", 1.0)
        max_s = cfg.get("max_s", 1.0)
        if cfg.get("scale_anisotropic", False):
            factor = self.rng.random(pc.shape[1]) * (max_s - min_s) + min_s
        else:
            factor = self.rng.random() * (max_s - min_s) + min_s
        return pc * factor

    def noise(self, pc, cfg):
        """Add Gaussian noise of deviation ``noise_std``."""
        noise_std = cfg.get("noise_std", 0.001)
        return pc + (self.rng.standard_normal(pc.shape) *
                     noise_std).astype(np.float32)

    def augment(self, point, feat, labels, cfg, seed=None):
        """Apply the steps that ``cfg`` names, in the JAX package's order;
        a ``seed`` replaces the generator first. Returns (point, feat,
        labels)."""
        if cfg is None:
            return point, feat, labels
        missing = [key for key in cfg if key not in self._PORTED]
        if missing:
            raise NotImplementedError(
                f"augmentations {missing} are not ported; the port runs "
                f"{list(self._PORTED)}")
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        if "recenter" in cfg:
            point = self.recenter(point, cfg["recenter"])
        if "normalize" in cfg:
            point, feat = self.normalize(point, feat, cfg["normalize"])
        if "rotate" in cfg:
            point = self.rotate(point, cfg["rotate"])
        if "scale" in cfg:
            point = self.scale(point, cfg["scale"])
        if "noise" in cfg:
            point = self.noise(point, cfg["noise"])
        return point, feat, labels
