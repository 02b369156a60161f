"""Semantic segmentation loss with ignored-label masking.

Counterpart of ``open3d_ml_tpu/modules/losses/semseg_loss.py``: ignored
labels are masked, not compacted away, so the shapes stay fixed; the loss
is the mean of the per-point cross-entropy weighted by class weights and
the mask.
"""

import torch
import torch.nn.functional as F

from ...datasets.utils import DataProcessing
from ...parallel.mesh import global_sum


def filter_valid_label(scores, labels, num_classes, ignored_label_inds):
    """(remapped labels, valid mask) of raw ``labels``.

    Labels in ``ignored_label_inds`` are invalid (and remapped to 0); the
    others move down by the number of ignored labels below them, so the
    class axis stays dense. ``scores`` is unused (kept for the JAX
    signature).
    """
    valid = torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
    for ign in ignored_label_inds:
        valid &= labels != ign
    reducer = torch.zeros_like(labels)
    for ign in sorted(ignored_label_inds):
        reducer += (labels > ign).to(labels.dtype)
    remapped = torch.where(valid, labels - reducer, torch.zeros_like(labels))
    return remapped.clamp(0, num_classes - 1), valid


class SemSegLoss:
    """Weighted cross-entropy; the class weights are
    ``DataProcessing.get_class_weights`` of the dataset's ``class_weights``
    (class counts) when it has them, else 1."""

    def __init__(self, pipeline, model, dataset):
        self.num_classes = model.cfg.num_classes
        self.ignored_label_inds = model.cfg.get("ignored_label_inds", [])
        self.class_weights = None
        counts = (dataset.cfg.get("class_weights") if dataset is not None
                  else None)
        if counts:
            self.class_weights = torch.from_numpy(
                DataProcessing.get_class_weights(counts))

    def weighted_cross_entropy(self, logits, labels, valid_mask):
        """-sum(w * log p[label]) / max(sum(w), 1e-6) over the rows, with
        w = class weight * valid mask; while a split batch runs, sum(w) is
        the global batch's, so the loss is this rank's share.

        logits [N, C] float32, labels [N] (dense class ids), valid_mask [N]
        bool.
        """
        logp = F.log_softmax(logits, dim=-1).gather(
            1, labels.long()[:, None])[:, 0]
        if self.class_weights is None:
            w = torch.ones_like(logp)
        else:
            w = self.class_weights.to(logp.device)[labels.long()]
        w = w * valid_mask.to(w.dtype)
        # the weights of the global batch's rows
        return -(logp * w).sum() / torch.clamp(global_sum(w.sum()),
                                               min=1e-6)
