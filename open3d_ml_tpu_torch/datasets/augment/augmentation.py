"""Host-side point cloud augmentation (numpy).

Counterpart of ``open3d_ml_tpu/datasets/augment/augmentation.py``
``SemsegAugmentation`` with the steps of the training recipes: ``recenter``,
``normalize``, ``rotate``, ``scale`` and ``noise`` (RandLA-Net's), and
``RandomDropout``, ``RandomHorizontalFlip``, ``ChromaticAutoContrast``,
``ChromaticTranslation`` and ``ChromaticJitter`` (SparseConvUnet's), in
the JAX package's order and with its draws. Random steps draw from
``rng``, a ``numpy.random.Generator`` made from ``seed`` (a generator
passed as the seed is used as it is, so the model's generator drives
them), so one seed gives the JAX package's arrays. The other
augmentations of the JAX package (``HueSaturationTranslation``,
``rotate`` with ``method="all"``) raise.
"""

import warnings

import numpy as np


class SemsegAugmentation:
    """Semantic segmentation augmentation."""

    _PORTED = ("recenter", "normalize", "rotate", "scale", "noise",
               "RandomDropout", "RandomHorizontalFlip",
               "ChromaticAutoContrast", "ChromaticTranslation",
               "ChromaticJitter")

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

    def RandomDropout(self, pc, feats, labels, cfg):
        """With probability ``dropout_ratio``, keep a random
        (1 - ratio) share of the points."""
        ratio = cfg.get("dropout_ratio", 0.2)
        if self.rng.random() < ratio:
            n = len(pc)
            inds = self.rng.choice(n, int(n * (1 - ratio)), replace=False)
            return (pc[inds], feats[inds] if feats is not None else None,
                    labels[inds])
        return pc, feats, labels

    def RandomHorizontalFlip(self, pc, cfg):
        """With probability 0.95, mirror each of ``axes`` with probability
        0.5 (x -> max x - x), in place."""
        axes = cfg.get("axes", [0, 1])
        if self.rng.random() < 0.95:
            for ax in axes:
                if self.rng.random() < 0.5:
                    pc[:, ax] = np.max(pc[:, ax]) - pc[:, ax]
        return pc

    def ChromaticAutoContrast(self, feats, cfg):
        """With probability 0.2, blend the colours (0-255) with their
        per-channel contrast stretch, in place."""
        randomize = cfg.get("randomize_blend_factor", True)
        blend = cfg.get("blend_factor", 0.5)
        if self.rng.random() < 0.2:
            lo = feats[:, :3].min(0, keepdims=True)
            hi = feats[:, :3].max(0, keepdims=True)
            if not hi.max() > 1:
                raise ValueError("ChromaticAutoContrast expects colors in "
                                 "[0, 255]")
            contrast = (feats[:, :3] - lo) * (255 / (hi - lo))
            blend = self.rng.random() if randomize else blend
            feats[:, :3] = (1 - blend) * feats[:, :3] + blend * contrast
        return feats

    def ChromaticTranslation(self, feats, cfg):
        """With probability 0.95, shift the colours by a random offset of
        at most ``trans_range_ratio`` * 255 per channel, clipped to 0-255,
        in place."""
        ratio = cfg.get("trans_range_ratio", 0.1)
        if self.rng.random() < 0.95:
            tr = (self.rng.random((1, 3)) - 0.5) * 255 * 2 * ratio
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return feats

    def ChromaticJitter(self, feats, cfg):
        """With probability 0.95, add Gaussian noise of deviation ``std`` *
        255 to the colours, clipped to 0-255, in place."""
        std = cfg.get("std", 0.01)
        if self.rng.random() < 0.95:
            noise = self.rng.standard_normal((feats.shape[0], 3)) * std * 255
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return feats

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
        if "RandomDropout" in cfg:
            point, feat, labels = self.RandomDropout(point, feat, labels,
                                                     cfg["RandomDropout"])
        if "RandomHorizontalFlip" in cfg:
            point = self.RandomHorizontalFlip(point,
                                              cfg["RandomHorizontalFlip"])
        if "ChromaticAutoContrast" in cfg:
            feat = self.ChromaticAutoContrast(feat,
                                              cfg["ChromaticAutoContrast"])
        if "ChromaticTranslation" in cfg:
            feat = self.ChromaticTranslation(feat,
                                             cfg["ChromaticTranslation"])
        if "ChromaticJitter" in cfg:
            feat = self.ChromaticJitter(feat, cfg["ChromaticJitter"])
        return point, feat, labels
