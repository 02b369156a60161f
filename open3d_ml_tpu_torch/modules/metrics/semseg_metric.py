"""Confusion-matrix metric for semantic segmentation.

Counterpart of ``open3d_ml_tpu/modules/metrics/semseg_metric.py``: each
step's [C, C] confusion matrix is counted on the device
(``confusion_matrix_device``), so only C^2 integers reach the host, where
``SemSegMetric`` sums them; ``acc`` and ``iou`` give per-class values (NaN
for an absent class) with their nan-mean appended.
"""

import numpy as np
import torch


def confusion_matrix_device(scores, labels, valid_mask, num_classes):
    """[C, C] int64 counts (rows ground truth, columns prediction) of the
    argmax of ``scores`` [..., C] against ``labels`` [...] where
    ``valid_mask`` holds, on the tensors' device."""
    pred = scores.reshape(-1, num_classes).argmax(-1)
    labels = labels.reshape(-1).long()
    flat = torch.where(valid_mask.reshape(-1), labels * num_classes + pred,
                       torch.full_like(pred, num_classes * num_classes))
    counts = torch.bincount(flat, minlength=num_classes * num_classes + 1)
    return counts[:-1].reshape(num_classes, num_classes)


class SemSegMetric:
    """Accumulates confusion matrices on the host."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.confusion_matrix = None
        self.num_classes = None

    def update_cm(self, cm):
        """Add a [C, C] confusion matrix (numpy or a tensor on any
        device)."""
        if torch.is_tensor(cm):
            cm = cm.cpu().numpy()
        cm = np.asarray(cm)
        if self.confusion_matrix is None:
            self.confusion_matrix = cm.copy()
            self.num_classes = cm.shape[0]
        else:
            self.confusion_matrix += cm

    def acc(self):
        """Per-class accuracy and their mean (NaN for absent classes)."""
        if self.confusion_matrix is None:
            return []
        cm = self.confusion_matrix
        accs = [cm[c, c] / cm[c, :].sum() if cm[c, :].sum() > 0 else np.nan
                for c in range(self.num_classes)]
        accs.append(np.nanmean(accs))
        return accs

    def iou(self):
        """Per-class IoU and their mean (NaN for absent classes)."""
        if self.confusion_matrix is None:
            return []
        cm = self.confusion_matrix
        ious = []
        for c in range(self.num_classes):
            denom = cm[c, :].sum() + cm[:, c].sum() - cm[c, c]
            ious.append(cm[c, c] / denom if denom > 0 else np.nan)
        ious.append(np.nanmean(ious))
        return ious
