"""open3d_ml_tpu_torch: the PyTorch and CUDA port of open3d_ml_tpu.

It covers RandLA-Net inference two ways: on the fused bucket path (the
Hilbert sort, the bucket pyramid, the bucket KNN and bucket gather
kernels), and through ``SemanticSegmentation.run_inference`` on the exact
evaluation path (the exact k-NN pyramid on the ``knn_exact`` kernel, the
possibility-map patch loop and its host side); RandLA-Net training on the
fused path (the gather backward kernel); and SparseConvUnet inference and
training on the stencil path (the voxelizer, Morton block tables, the
``stencil_conv`` kernel and, in its backward, the ``stencil_match``
kernel and the bucket gather and its backward) with its exact hash-path
twin; and PointPillars detection serving (``get_net``: canvas-major
pillars, bf16 convolutions) and evaluation (``get_eval_net``: compact
pillars, float32) with ``ObjectDetection``'s ``run_valid`` (mAP),
``run_test`` and ``run_inference`` on ``KITTI`` and ``SyntheticBoxes``.
Each kernel is CUDA C++ for Hopper with a plain PyTorch version for CPU
tensors; PointPillars' path reaches no kernel of the JAX package, and its
convolutions are PyTorch's. The command line ``python -m
open3d_ml_tpu_torch.run_pipeline`` trains, validates and tests from a
config file (the port's copies of the shipped YAMLs are in ``configs/``)
on the readers those configs name. The port imports PyTorch, numpy and
scipy (PyYAML only to read a config file), and never JAX, nor anything of
``open3d_ml_tpu``: its registries and configuration are its own
(``utils``).
"""

from . import dataloaders, datasets, metrics, models, pipelines, utils
from .utils import DATASET, MODEL, PIPELINE, SAMPLER

__all__ = ["DATASET", "MODEL", "PIPELINE", "SAMPLER", "dataloaders",
           "datasets", "metrics", "models", "pipelines", "utils"]
