"""Data-parallel dry runs: one training step of a small RandLA-Net and of a
small PointPillars, split over the process group's ranks.

Counterpart of ``open3d_ml_tpu/parallel/dryrun.py`` (``dryrun_train_step``
at ``model_parallel`` 1, ``dryrun_objdet_step``), at its configs. Every
rank calls the function, in a group that ``mesh.init_distributed`` joined
(or alone), and builds the same global batch of max(ranks, 2) rows from
``np.random.default_rng(0)``; the pipeline's training step runs this
rank's share (``BasePipeline._on_rows``), and every rank returns the
global batch's loss. The weights come from the pipeline's seed (0).
"""

import numpy as np

from .mesh import make_mesh

# the JAX dry run's RandLA-Net: 2 stages, not the shipped 4
RANDLANET_DRYRUN = dict(ignored_label_inds=[0], in_channels=3,
                        dim_features=8, num_layers=2, dim_output=[16, 32],
                        sub_sampling_ratio=[4, 4])

_PC_RANGE = [0.0, -6.4, -3.0, 12.8, 6.4, 1.0]
# the JAX dry run's PointPillars: a 32 x 32 canvas, two classes
POINTPILLARS_DRYRUN = dict(
    point_cloud_range=_PC_RANGE,
    classes=["Pedestrian", "Car"],
    voxelize={"max_num_points": 8, "voxel_size": [0.4, 0.4, 4],
              "max_voxels": [128, 128]},
    voxel_encoder={"in_channels": 4, "feat_channels": [16],
                   "voxel_size": [0.4, 0.4, 4]},
    scatter={"in_channels": 16, "output_shape": [32, 32]},
    backbone={"in_channels": 16, "out_channels": [16, 32],
              "layer_nums": [1, 1], "layer_strides": [2, 2]},
    neck={"in_channels": [16, 32], "out_channels": [16, 16],
          "upsample_strides": [1, 2]},
    head={"ranges": [_PC_RANGE, _PC_RANGE],
          "sizes": [[0.6, 0.8, 1.73], [1.6, 3.9, 1.56]],
          "rotations": [0, 1.5707963],
          "iou_thr": [[0.35, 0.5], [0.45, 0.6]]},
    max_points=256, max_gt=4)


def randlanet_batch(b, num_points=256, num_classes=8):
    """The JAX dry run's RandLA-Net batch of ``b`` rows."""
    rng = np.random.default_rng(0)
    return {"coords": rng.standard_normal((b, num_points, 3)).astype(
                np.float32),
            "features": rng.standard_normal((b, num_points, 3)).astype(
                np.float32),
            "labels": rng.integers(0, num_classes, (b, num_points)).astype(
                np.int32)}


def pointpillars_batch(b):
    """The JAX dry run's PointPillars batch of ``b`` frames: 200 points
    uniform in the range, two Pedestrian boxes a frame."""
    rng = np.random.default_rng(0)
    pc = _PC_RANGE
    n_real = 200
    pts = np.zeros((b, 256, 4), np.float32)
    for axis in range(3):
        pts[:, :n_real, axis] = rng.uniform(pc[axis], pc[axis + 3],
                                            (b, n_real))
    boxes = np.zeros((b, 4, 7), np.float32)
    boxes[:, :2, :3] = rng.uniform(1, 6, (b, 2, 3))
    boxes[:, :2, 2] = -1.0
    boxes[:, :2, 3:6] = [[0.6, 0.8, 1.73]]
    return {"point": pts, "point_count": np.full((b,), n_real, np.int32),
            "bboxes": boxes, "labels": np.zeros((b, 4), np.int32),
            "bbox_count": np.full((b,), 2, np.int32)}


def dryrun_train_step(num_points=256, num_classes=8, device="cuda",
                      model_parallel=1):
    """One RandLA-Net Adam step (lr 1e-3) on the global batch, split over
    the ranks; returns the (finite) global loss."""
    from ..models import RandLANet
    from ..modules.losses import SemSegLoss
    from ..pipelines import SemanticSegmentation

    mesh = make_mesh(model_parallel=model_parallel)
    model = RandLANet(num_points=num_points, num_classes=num_classes,
                      seed=0, **RANDLANET_DRYRUN)
    pipeline = SemanticSegmentation(model, device=device, seed=0,
                                    optimizer={"lr": 1e-3})
    pipeline.optimizer, pipeline.scheduler = model.get_optimizer(
        pipeline.cfg, pipeline.net)
    batch = randlanet_batch(max(mesh.size, 2), num_points, num_classes)
    loss, _ = pipeline._on_rows(pipeline._train_step, {"data": batch},
                                SemSegLoss(pipeline, model, None))
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun loss not finite: {loss}")
    return loss


def dryrun_objdet_step(device="cuda"):
    """One PointPillars AdamW step on the global batch, split over the
    ranks; returns the (finite) global loss, the sum of the three."""
    from ..models import PointPillars
    from ..pipelines import ObjectDetection

    mesh = make_mesh()
    model = PointPillars(seed=0, **POINTPILLARS_DRYRUN)
    pipeline = ObjectDetection(model, device=device, seed=0,
                               optimizer={"lr": 1e-3})
    pipeline.optimizer, _ = model.get_optimizer(pipeline.cfg, pipeline.net)
    losses = pipeline._on_rows(pipeline._train_step,
                               {"data": pointpillars_batch(
                                   max(mesh.size, 2))})
    loss = float(sum(losses.values()))
    if not np.isfinite(loss):
        raise AssertionError(f"objdet dryrun loss not finite: {loss}")
    return loss
