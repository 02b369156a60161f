"""KITTI-protocol mAP of 3D object detection (numpy, on the host).

Counterpart of ``open3d_ml_tpu/metrics/mAP.py``, the same code: true and
false positives per class and difficulty by BEV or 3D rotated IoU
(``ops/iou.py``'s numpy path), precision at 41 recall-spaced thresholds
made monotone, and similar classes (Van for Car) whose gt boxes count
neither as true positives nor as misses.

The boxes in 'bbox' are the camera-frame 7-vectors (x, y, z, l, h, w, ry)
of ``BEVBox3D.to_camera`` and ``to_dicts``.
"""

import numpy as np

from ..ops.iou import iou_3d as _iou_3d
from ..ops.iou import iou_bev as _iou_bev


def filter_data(data, labels, diffs=None):
    """Select entries whose label is in ``labels`` (and difficulty in
    ``diffs``). Returns (filtered dict, indices)."""
    cond = np.any([data["label"] == label for label in labels], axis=0)
    if diffs is not None and "difficulty" in data:
        dcond = np.any([
            np.all([data["difficulty"] >= 0, data["difficulty"] <= diff],
                   axis=0) for diff in diffs
        ], axis=0)
        cond = np.all([cond, dcond], axis=0)
    idx = np.where(cond)[0]
    return {k: data[k][idx] for k in data}, idx


def precision_3d(pred, target, classes=[0], difficulties=[0],
                 min_overlap=[0.5], bev=True, similar_classes={}):
    """Per-box detection quantities (score, tp, fp) + false-negative counts
    for one frame."""
    sim_values = list(similar_classes.values())
    pred = filter_data(pred, classes)[0]
    target = filter_data(target, classes + sim_values)[0]

    if bev:
        overlap = _iou_bev(
            pred["bbox"][:, [0, 2, 3, 5, 6]].astype(np.float32),
            target["bbox"][:, [0, 2, 3, 5, 6]].astype(np.float32))
    else:
        overlap = _iou_3d(pred["bbox"].astype(np.float32),
                          target["bbox"].astype(np.float32))

    detection = np.zeros(
        (len(classes), len(difficulties), len(pred["bbox"]), 3))
    fns = np.zeros((len(classes), len(difficulties), 1), dtype="int64")
    for i, label in enumerate(classes):
        pred_label, pred_idx_l = filter_data(pred, [label])
        target_label, target_idx_l = filter_data(
            target, [label, similar_classes.get(label)])
        overlap_label = overlap[pred_idx_l][:, target_idx_l]
        for j, diff in enumerate(difficulties):
            pred_idx = filter_data(pred_label, [label], [diff])[1]
            target_idx = filter_data(target_label, [label], [diff])[1]

            if len(pred_idx) > 0:
                # preds with no gt overlap at all (any difficulty) are FP
                fp = np.all(overlap_label[pred_idx] < min_overlap[i],
                            axis=1).astype("float32")

                match_cond = np.any(
                    overlap_label[pred_idx][:, target_idx] >= min_overlap[i],
                    axis=-1)
                tp = np.zeros((len(pred_idx),))
                # matches start as FP; only the best-overlap pred per gt
                # becomes TP
                fp[np.where(match_cond)] = 1
                if len(target_idx) > 0:
                    max_idx = np.argmax(overlap_label[:, target_idx], axis=0)
                else:
                    max_idx = np.array([], dtype=np.int64)
                max_cond = [idx in max_idx for idx in pred_idx]
                match_cond = np.all([max_cond, match_cond], axis=0)
                tp[match_cond] = 1
                fp[match_cond] = 0

                fns[i, j] = np.sum(
                    np.all(overlap_label[:, target_idx] < min_overlap[i],
                           axis=0))
                detection[i, j, [pred_idx]] = np.stack(
                    [pred_label["score"][pred_idx], tp, fp], axis=-1)
            else:
                fns[i, j] = len(target_idx)
    return detection, fns


def sample_thresholds(scores, gt_cnt, sample_cnt=41):
    """Equally-recall-spaced score thresholds (KITTI protocol)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / gt_cnt
        r_recall = (i + 2) / gt_cnt if i < (len(scores) - 1) else l_recall
        if (((r_recall - current_recall) < (current_recall - l_recall)) and
                (i < (len(scores) - 1))):
            continue
        thresholds.append(score)
        current_recall += 1 / (sample_cnt - 1.0)
    return thresholds


def mAP(pred, target, classes=[0], difficulties=[0], min_overlap=[0.5],
        bev=True, samples=41, similar_classes={}):
    """mean Average Precision over frames.

    Args:
        pred/target: lists of per-frame dicts with keys
            bbox [N,7], label [N] (str or int), score [N], difficulty [N].
        classes: class names/ids to evaluate.
        difficulties: difficulty levels to evaluate.
        min_overlap: per-class IoU thresholds (len 1 broadcasts).
        bev: BEV IoU if True else 3D IoU.
        samples: recall sample count (41 = KITTI).

    Returns: [num_classes, num_difficulties, 1] AP values (percent).
    """
    if len(min_overlap) != len(classes):
        assert len(min_overlap) == 1
        min_overlap = min_overlap * len(classes)

    cnt = 0
    box_cnts = [0]
    for p in pred:
        cnt += len(filter_data(p, classes)[1])
        box_cnts.append(cnt)

    gt_cnt = np.zeros((len(classes), len(difficulties)))
    for i, c in enumerate(classes):
        for j, d in enumerate(difficulties):
            for t in target:
                gt_cnt[i, j] += len(filter_data(t, [c], [d])[1])

    detection = np.zeros((len(classes), len(difficulties), box_cnts[-1], 3))
    fns = np.zeros((len(classes), len(difficulties), 1), dtype="int64")
    for i in range(len(pred)):
        d, f = precision_3d(pred=pred[i], target=target[i], classes=classes,
                            difficulties=difficulties,
                            min_overlap=min_overlap, bev=bev,
                            similar_classes=similar_classes)
        detection[:, :, box_cnts[i]:box_cnts[i + 1]] = d
        fns += f

    ap = np.zeros((len(classes), len(difficulties), 1))
    if samples <= 0:
        return ap

    for i in range(len(classes)):
        for j in range(len(difficulties)):
            det = detection[i, j, np.argsort(-detection[i, j, :, 0])]
            thresholds = sample_thresholds(
                det[np.where(det[:, 1] > 0)[0], 0], gt_cnt[i, j], samples)
            if len(thresholds) == 0:
                continue

            prec = np.zeros((len(thresholds),))
            for ti in range(len(thresholds))[::-1]:
                d = det[np.where(det[:, 0] >= thresholds[ti])]
                tp_acc = np.sum(d[:, 1])
                fp_acc = np.sum(d[:, 2])
                if (tp_acc + fp_acc) > 0:
                    prec[ti] = tp_acc / (tp_acc + fp_acc)
                prec[ti] = np.max(prec[ti:], axis=-1)

            if len(prec[::4]) < int(samples / 4 + 1):
                ap[i, j] = np.sum(prec) / len(prec) * 100
            else:
                ap[i, j] = np.sum(prec[::4]) / int(samples / 4 + 1) * 100
    return ap
