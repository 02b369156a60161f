"""Host-side point cloud augmentation (numpy).

Counterpart of ``open3d_ml_tpu/datasets/augment/augmentation.py``: the
shared geometric steps (``Augmentation``: ``recenter``, ``normalize``,
``rotate``, ``scale``, ``noise``); ``SemsegAugmentation`` with the steps
of the segmentation recipes, ``RandomDropout``, ``RandomHorizontalFlip``,
``ChromaticAutoContrast``, ``ChromaticTranslation``, ``ChromaticJitter``
(SparseConvUnet's) and ``HueSaturationTranslation`` (PointTransformer's);
and ``ObjdetAugmentation`` with
``PointShuffle``, ``ObjectRangeFilter`` and ``ObjectSample`` (gt boxes
pasted from a database that ``utils/collect_bboxes.py`` writes), in the
JAX package's order and with its draws. Random steps draw from ``rng``, a
``numpy.random.Generator`` made from ``seed`` (a generator passed as the
seed is used as it is, so the model's generator drives them), so one
seed gives the JAX package's arrays.
"""

import pickle
import warnings

import numpy as np

from ..utils.operations import (box_collision_test, remove_points_in_boxes,
                                sample_class)


def _rotation_matrices(axes, angles):
    """Rotation matrices [N, 3, 3] about unit axes [N, 3] by angles [N]
    (Rodrigues' formula in float64, returned as float32)."""
    axes = np.asarray(axes, np.float64).reshape(-1, 3)
    angles = np.asarray(angles, np.float64).reshape(-1)
    c = np.cos(angles)
    s = np.sin(angles)
    t = 1 - c
    x, y, z = axes[:, 0], axes[:, 1], axes[:, 2]
    rot = np.stack([
        t * x * x + c, t * x * y - s * z, t * x * z + s * y,
        t * x * y + s * z, t * y * y + c, t * y * z - s * x,
        t * x * z - s * y, t * y * z + s * x, t * z * z + c
    ], axis=-1).reshape(-1, 3, 3)
    return rot.astype(np.float32)


class Augmentation:
    """The geometric steps that both tasks' augmentations share."""

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
        """Rotate by a random angle about the vertical axis
        (``method="vertical"``) or about a random axis (``method="all"``:
        the axis's azimuth theta and elevation phi, then the angle alpha,
        drawn in that order)."""
        if np.abs(pc[:, :2].mean()) > 1e-2:
            warnings.warn("Recenter pointcloud before calling rotate.")
        method = cfg.get("method", "vertical")
        if method == "vertical":
            theta = self.rng.random() * 2 * np.pi
            c, s = np.cos(theta), np.sin(theta)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        elif method == "all":
            theta = self.rng.random() * 2 * np.pi
            phi = (self.rng.random() - 0.5) * np.pi
            axis = np.array([np.cos(theta) * np.cos(phi),
                             np.sin(theta) * np.cos(phi), np.sin(phi)])
            alpha = self.rng.random() * 2 * np.pi
            rot = _rotation_matrices(axis, alpha)[0]
        else:
            raise ValueError(f"Unsupported rotate method: {method}")
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


class SemsegAugmentation(Augmentation):
    """Semantic segmentation augmentation."""

    _PORTED = ("recenter", "normalize", "rotate", "scale", "noise",
               "RandomDropout", "RandomHorizontalFlip",
               "ChromaticAutoContrast", "ChromaticTranslation",
               "ChromaticJitter", "HueSaturationTranslation")

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

    @staticmethod
    def _rgb_to_hsv(rgb):
        """``colorsys.rgb_to_hsv`` over [..., 3] colours in 0-255, in
        float64: h and s in [0, 1], v in 0-255."""
        rgb = rgb.astype(np.float64)
        hsv = np.zeros_like(rgb)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        maxc = np.max(rgb[..., :3], axis=-1)
        minc = np.min(rgb[..., :3], axis=-1)
        hsv[..., 2] = maxc
        grey = maxc == minc
        span = np.where(grey, 1.0, maxc - minc)
        hsv[..., 1] = np.where(grey, 0.0, (maxc - minc) /
                               np.where(maxc == 0, 1, maxc))
        rc = np.where(grey, 0.0, (maxc - r) / span)
        gc = np.where(grey, 0.0, (maxc - g) / span)
        bc = np.where(grey, 0.0, (maxc - b) / span)
        h = np.select([r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc],
                      default=4.0 + gc - rc)
        hsv[..., 0] = (h / 6.0) % 1.0
        return hsv

    @staticmethod
    def _hsv_to_rgb(hsv):
        """``colorsys.hsv_to_rgb`` over [..., 3] (h, s in [0, 1], v in
        0-255), cast to uint8 as the JAX package casts it."""
        rgb = np.empty_like(hsv)
        h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
        i = (h * 6.0).astype(np.uint8)
        f = (h * 6.0) - i
        p = v * (1.0 - s)
        q = v * (1.0 - s * f)
        t = v * (1.0 - s * (1.0 - f))
        i = i % 6
        conds = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
        rgb[..., 0] = np.select(conds, [v, q, p, p, t, v], default=v)
        rgb[..., 1] = np.select(conds, [v, v, v, q, p, p], default=t)
        rgb[..., 2] = np.select(conds, [v, p, t, v, v, q], default=p)
        return rgb.astype(np.uint8)

    def HueSaturationTranslation(self, feat, cfg):
        """Shift the hue by a random offset of at most ``hue_max`` (mod 1)
        and scale the saturation by a random factor within
        1 +- ``saturation_max`` (clipped to [0, 1]), in place: the colours
        come back as whole numbers, through uint8."""
        hue_max = cfg.get("hue_max", 0.5)
        sat_max = cfg.get("saturation_max", 0.2)
        hsv = self._rgb_to_hsv(feat[:, :3])
        hue_val = (self.rng.random() - 0.5) * 2 * hue_max
        sat_ratio = 1 + (self.rng.random() - 0.5) * 2 * sat_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        feat[:, :3] = np.clip(self._hsv_to_rgb(hsv), 0, 255)
        return feat

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
        if "HueSaturationTranslation" in cfg:
            feat = self.HueSaturationTranslation(
                feat, cfg["HueSaturationTranslation"])
        return point, feat, labels


class ObjdetAugmentation(Augmentation):
    """Object detection augmentation."""

    _ALL = ("recenter", "normalize", "rotate", "scale", "noise",
            "PointShuffle", "ObjectRangeFilter", "ObjectSample")

    def __init__(self, cfg, seed=None):
        super().__init__(cfg, seed=seed)
        for method in (cfg or {}):
            if method not in self._ALL:
                warnings.warn(f"Unknown objdet augmentation: {method}")

    def PointShuffle(self, data):
        """Shuffle the points in place."""
        self.rng.shuffle(data["point"])
        return data

    @staticmethod
    def in_range_bev(box_range, box_xyzwhlr):
        """Whether a box's BEV center lies inside [x0, y0, x1, y1]."""
        return ((box_xyzwhlr[0] > box_range[0]) &
                (box_xyzwhlr[1] > box_range[1]) &
                (box_xyzwhlr[0] < box_range[2]) &
                (box_xyzwhlr[1] < box_range[3]))

    def ObjectRangeFilter(self, data, pcd_range):
        """Keep the gt boxes whose BEV center lies inside the point cloud
        range."""
        bev_range = np.asarray(pcd_range)[[0, 1, 3, 4]]
        data["bounding_boxes"] = [
            box for box in data["bounding_boxes"]
            if self.in_range_bev(bev_range, box.to_xyzwhlr())]
        return data

    def ObjectSample(self, data, db_boxes_dict, sample_dict):
        """Paste gt boxes of the database, with their points, into the
        scene until each class of ``sample_dict`` reaches its count, each
        drawn box kept only where it overlaps (BEV) no box kept so far;
        the scene's points inside a pasted box go."""
        points = data["point"]
        bboxes = data["bounding_boxes"]
        labels = [box.label_class for box in bboxes]
        sampled_num_dict = {}
        for class_name, max_sample_num in sample_dict.items():
            existing = np.sum([n == class_name for n in labels])
            sampled_num_dict[class_name] = np.round(
                int(max_sample_num - existing)).astype(np.int64)

        sampled = []
        for class_name, sampled_num in sampled_num_dict.items():
            if sampled_num < 0:
                continue
            sampled_cls = sample_class(class_name, sampled_num, bboxes,
                                       db_boxes_dict[class_name],
                                       rng=self.rng)
            sampled += sampled_cls
            bboxes = bboxes + sampled_cls

        if sampled:
            sampled_points = np.concatenate(
                [box.points_inside_box for box in sampled], axis=0)
            points = remove_points_in_boxes(points, sampled)
            points = np.concatenate([sampled_points[:, :4], points], axis=0)
        data["point"] = points
        data["bounding_boxes"] = bboxes
        return data

    @staticmethod
    def load_gt_database(pickle_path, min_points_dict, sample_dict):
        """{class: boxes} of the database pickle at ``pickle_path``, each
        class of ``sample_dict``, keeping the boxes of the classes of
        ``min_points_dict`` with at least that many points inside."""
        with open(pickle_path, "rb") as f:
            db_boxes = pickle.load(f)
        if min_points_dict is not None:
            db_boxes = [
                box for box in db_boxes
                if box.label_class in min_points_dict and
                box.points_inside_box.shape[0] >=
                min_points_dict[box.label_class]]
        db_boxes_dict = {key: [] for key in sample_dict}
        for box in db_boxes:
            if box.label_class in sample_dict:
                db_boxes_dict[box.label_class].append(box)
        return db_boxes_dict

    def augment(self, data, attr, seed=None):
        """Apply the steps that ``cfg`` names to ``data`` {"point",
        "bounding_boxes", ...}, in the JAX package's order: the geometric
        steps, ObjectSample (the database loaded at the first call),
        ObjectRangeFilter, PointShuffle; a ``seed`` replaces the
        generator first."""
        cfg = self.cfg
        if cfg is None:
            return data
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        if "recenter" in cfg:
            data["point"] = self.recenter(data["point"], cfg["recenter"])
        if "normalize" in cfg:
            data["point"], _ = self.normalize(data["point"], None,
                                              cfg["normalize"])
        if "rotate" in cfg:
            data["point"] = self.rotate(data["point"], cfg["rotate"])
        if "scale" in cfg:
            data["point"] = self.scale(data["point"], cfg["scale"])
        if "noise" in cfg:
            data["point"] = self.noise(data["point"], cfg["noise"])
        if "ObjectSample" in cfg:
            sample = cfg["ObjectSample"]
            if not hasattr(self, "db_boxes_dict"):
                self.db_boxes_dict = self.load_gt_database(
                    sample["pickle_path"], sample.get("min_points_dict"),
                    sample["sample_dict"])
            data = self.ObjectSample(data, self.db_boxes_dict,
                                     sample["sample_dict"])
        if cfg.get("ObjectRangeFilter", False):
            data = self.ObjectRangeFilter(
                data, cfg["ObjectRangeFilter"]["point_cloud_range"])
        if cfg.get("PointShuffle", False):
            data = self.PointShuffle(data)
        return data
