"""Transform helpers of the models' data pipelines (numpy).

Counterpart of ``open3d_ml_tpu/datasets/utils/transforms.py``, the same
code: ``trans_normalize`` (a model's ``t_normalize`` config),
``trans_augment`` (recentre, rotate, scale and noise through the port's
``Augmentation``) and ``trans_crop_pc`` (a patch of ``num_points`` around
one point, from a KD-tree).
"""

import numpy as np


def trans_normalize(pc, feat, t_normalize):
    """Normalize the points and features as ``t_normalize`` says:
    ``method`` "linear" (the points centred and scaled by their largest
    extent where ``normalize_points``; the features less ``feat_bias``,
    over ``feat_scale``) or "coords_only" (the points so, the features
    dropped). In place where the arrays allow; returns (pc, feat)."""
    if not t_normalize or t_normalize.get("method") is None:
        return pc, feat
    method = t_normalize.get("method")
    if method == "linear":
        if t_normalize.get("normalize_points", False):
            pc -= pc.mean(0)
            pc /= (pc.max(0) - pc.min(0)).max()
        if feat is not None:
            feat -= t_normalize.get("feat_bias", 0)
            feat /= t_normalize.get("feat_scale", 1)
    elif method == "coords_only":
        pc -= pc.mean(0)
        pc /= (pc.max(0) - pc.min(0)).max()
        feat = None
    return pc, feat


def trans_augment(points, t_augment, rng=None):
    """Where ``t_augment["turn_on"]``: recentre ``points`` (a copy), rotate
    them (``rotation_method``), scale them (``min_s``, ``max_s``,
    ``scale_anisotropic``) and add noise (``noise_level``), drawing from a
    generator seeded ``rng``."""
    if not t_augment or not t_augment.get("turn_on", False):
        return points
    from ..augment import Augmentation
    aug = Augmentation({}, seed=rng)
    points = aug.recenter(points.copy(), {"dim": [0, 1, 2]})
    points = aug.rotate(
        points, {"method": t_augment.get("rotation_method", "vertical")})
    points = aug.scale(points, {
        "min_s": t_augment.get("min_s", 1.0),
        "max_s": t_augment.get("max_s", 1.0),
        "scale_anisotropic": t_augment.get("scale_anisotropic", False),
    })
    if t_augment.get("noise_level"):
        points = aug.noise(points, {"noise_std": t_augment["noise_level"]})
    return points


def trans_crop_pc(points, feat, labels, search_tree, pick_idx, num_points):
    """The ``num_points`` nearest points of point ``pick_idx`` by
    ``search_tree`` (all points, then random repeats, where there are
    fewer), in a random order from unseeded generators, as the JAX
    package draws them. Returns (points, feat or None, labels, indices).
    """
    center_point = points[pick_idx, :].reshape(1, -1)
    if points.shape[0] < num_points:
        select_idx = np.arange(points.shape[0])
        diff = num_points - points.shape[0]
        select_idx = np.concatenate(
            [select_idx, np.random.choice(points.shape[0], diff)])
    else:
        select_idx = np.asarray(
            search_tree.query(center_point, k=num_points)[1][0])
    rng = np.random.default_rng()
    rng.shuffle(select_idx)
    select_points = points[select_idx]
    select_feat = feat[select_idx] if feat is not None else None
    select_labels = labels[select_idx]
    return select_points, select_feat, select_labels, select_idx
