"""Accuracy floor of the port's training path: train a small RandLA-Net on
procedural scenes through ``SemanticSegmentation.run_train`` and
``run_test`` and hold the mIoU above fixed floors.

The recipe and the floors are those of the JAX package's
``tests/test_accuracy_regression.py`` (``_train_semseg``): 16 training
scenes of 8,192 points, 4,096-point patches, 60 epochs, lr 8e-3 decayed
by 0.99 an epoch, the exact neighbour path, floors 0.11 train and 0.09
test mIoU. One difference in what runs: the port's epoch draws
``steps_per_epoch_train`` = 24 patches (6 steps of 4), cycling over the
scenes, where the JAX package's sampler stops after one pass over the 16
scenes (4 steps). Slow tier: it trains for real on the CPU.
"""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

SEMSEG_TRAIN_MIOU_FLOOR = 0.11
SEMSEG_TEST_MIOU_FLOOR = 0.09


def _miou(results_per_cloud, split, num_classes, ignored=(0,)):
    """Mean IoU over the classes present, predictions moved from the dense
    class axis back to label space."""
    k = num_classes + 1
    cm = np.zeros((k, k), np.int64)
    for cid, res in results_per_cloud.items():
        labels = split.get_data(cid)["label"]
        pred = np.asarray(res["predict_labels"]).reshape(-1).copy()
        for ign in sorted(ignored):
            pred[pred >= ign] += 1
        valid = labels > 0
        cm += np.bincount(labels[valid] * k + pred[valid],
                          minlength=k * k).reshape(k, k)
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - np.diag(cm)
    present = cm.sum(1) > 0
    present[0] = False
    return float((inter[present] / np.maximum(union[present], 1)).mean())


@pytest.mark.slow
def test_port_train_and_test_miou_floors(tmp_path):
    from open3d_ml_tpu_torch.datasets import SyntheticShapes
    from open3d_ml_tpu_torch.models import RandLANet
    from open3d_ml_tpu_torch.pipelines import SemanticSegmentation

    dataset = SyntheticShapes(
        num_points_per_cloud=8192,
        num_clouds={"training": 16, "validation": 4, "test": 2},
        use_cache=True, cache_dir=str(tmp_path / "cache"),
        steps_per_epoch_train=24,
        test_result_folder=str(tmp_path / "results"))
    model = RandLANet(
        num_points=4096, num_classes=19, ignored_label_inds=[0],
        in_channels=3, dim_features=8, dim_output=[16, 64, 128, 256],
        sub_sampling_ratio=[4, 4, 4, 4], grid_size=0.12,
        knn_method="exact", seed=0,
        augment={"recenter": {"dim": [0, 1]},
                 "rotate": {"method": "vertical"},
                 "scale": {"min_s": 0.9, "max_s": 1.1},
                 "noise": {"noise_std": 0.01}})
    pipeline = SemanticSegmentation(
        model, dataset=dataset, device="cpu", seed=0, max_epoch=60,
        batch_size=4, val_batch_size=4, test_batch_size=4,
        optimizer={"lr": 8e-3}, scheduler_gamma=0.99,
        main_log_dir=str(tmp_path / "logs"), num_workers=0)
    pipeline.run_train()
    train_miou = pipeline.metric_train.iou()[-1]
    assert train_miou > SEMSEG_TRAIN_MIOU_FLOOR, train_miou

    pipeline.run_test()
    miou = _miou(pipeline.test_results, dataset.get_split("test"), 19)
    assert miou > SEMSEG_TEST_MIOU_FLOOR, miou
