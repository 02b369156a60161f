"""Host-side point cloud augmentation (numpy).

Counterpart of ``open3d_ml_tpu/datasets/augment/augmentation.py``
``SemsegAugmentation``, with the test-time steps only: ``recenter`` and
``normalize``. The training augmentations, and the random generator they
draw from, come with the training slice; asking for one raises.
"""


class SemsegAugmentation:
    """Semantic segmentation augmentation: recenter and normalize."""

    _PORTED = ("recenter", "normalize")

    def __init__(self, cfg):
        self.cfg = cfg

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

    def augment(self, point, feat, labels, cfg):
        """Apply the steps that ``cfg`` names; returns (point, feat,
        labels)."""
        if cfg is None:
            return point, feat, labels
        missing = [key for key in cfg if key not in self._PORTED]
        if missing:
            raise NotImplementedError(
                f"augmentations {missing} are not ported; the port runs "
                f"{list(self._PORTED)}")
        if "recenter" in cfg:
            point = self.recenter(point, cfg["recenter"])
        if "normalize" in cfg:
            point, feat = self.normalize(point, feat, cfg["normalize"])
        return point, feat, labels
