"""Point clouds and boxes in TensorBoard summaries.

Counterpart of ``open3d_ml_tpu/pipelines/summaries.py``
``add_pointcloud_summary``, ``add_boxes_summary`` and ``record_summary``:
a cloud goes to TensorBoard's mesh plugin as coloured vertices through the
``torch.utils.tensorboard.SummaryWriter`` that the pipeline gives, its
points coloured by label through a ``LabelLUT``; boxes go there as the
vertices of their line sets (``BoundingBox3D.create_lines``: the mesh
plugin has no line primitive).
"""

import numpy as np
import torch

from ..vis import BoundingBox3D, LabelLUT


def _label_colors(labels, lut):
    """uint8 RGB [N, 3] of ``labels`` [N] from ``lut``; grey where a label
    is not in it."""
    colors = np.full((len(labels), 3), 200, np.uint8)
    for val, label in lut.labels.items():
        colors[labels == val] = (np.clip(label.color, 0, 1) *
                                 255).astype(np.uint8)
    return colors


def add_pointcloud_summary(writer, tag, points, labels=None, lut=None,
                           step=0, max_outputs=1, max_pts=20000):
    """Log up to ``max_outputs`` clouds of ``points`` ([N, 3] or
    [B, N, 3]) under ``<tag>/<i>``, each cut to ``max_pts`` points drawn
    without replacement from a generator seeded 0, coloured by ``labels``
    through ``lut`` where both are given, else grey."""
    points = np.asarray(points)
    if points.ndim == 2:
        points = points[None]
        if labels is not None:
            labels = np.asarray(labels)[None]
    for i in range(min(points.shape[0], max_outputs)):
        pts = points[i]
        lab = None if labels is None else labels[i]
        if pts.shape[0] > max_pts:
            sel = np.random.default_rng(0).choice(pts.shape[0], max_pts,
                                                  replace=False)
            pts = pts[sel]
            lab = None if lab is None else lab[sel]
        if lab is not None and lut is not None:
            colors = _label_colors(np.asarray(lab).reshape(-1), lut)
        else:
            colors = np.full((pts.shape[0], 3), 180, np.uint8)
        writer.add_mesh(
            f"{tag}/{i}",
            vertices=torch.from_numpy(pts[None].astype(np.float32)),
            colors=torch.from_numpy(colors[None].astype(np.int32)),
            global_step=step)


def add_boxes_summary(writer, tag, boxes, step=0, lut=None):
    """Log ``boxes`` under ``tag`` as the 14 vertices a box of their line
    set; nothing for no boxes. The line colours are not drawn (nor are
    they in JAX)."""
    if not boxes:
        return
    lines = BoundingBox3D.create_lines(boxes, lut=lut, out_format="dict")
    writer.add_mesh(tag,
                    vertices=torch.from_numpy(
                        lines["vertex_positions"][None].astype(np.float32)),
                    global_step=step)


def record_summary(writer, cfg_summary, split, tag_prefix, data, results,
                   step, label_to_names=None):
    """The pipeline's hook: where ``split`` is in the summary config's
    ``record_for``, log the batch's clouds (``data["coords"]``, else
    ``data["point"]``) coloured by the argmax of ``results``, under
    ``<tag_prefix>/<split>``, with the config's ``max_outputs`` and
    ``max_pts``."""
    cfg_summary = cfg_summary or {}
    if split not in (cfg_summary.get("record_for") or []):
        return
    points = data.get("coords", data.get("point"))
    if points is None:
        return
    lut = LabelLUT(label_to_names) if label_to_names else None
    labels = (None if results is None else
              np.argmax(np.asarray(results), axis=-1))
    add_pointcloud_summary(writer, f"{tag_prefix}/{split}",
                           np.asarray(points), labels, lut, step=step,
                           max_outputs=cfg_summary.get("max_outputs", 1) or 1,
                           max_pts=cfg_summary.get("max_pts") or 20000)
