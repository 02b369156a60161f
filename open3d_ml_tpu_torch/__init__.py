"""open3d_ml_tpu_torch: the PyTorch and CUDA port of open3d_ml_tpu.

It covers RandLA-Net inference two ways: on the fused bucket path (the
Hilbert sort, the bucket pyramid, the bucket KNN and bucket gather
kernels), and through ``SemanticSegmentation.run_inference`` on the exact
evaluation path (the exact k-NN pyramid on the ``knn_exact`` kernel, the
possibility-map patch loop and its host side); RandLA-Net training on the
fused path (the gather backward kernel); and SparseConvUnet inference on
the stencil path (the voxelizer, Morton block tables and the
``stencil_conv`` kernel) with its exact hash-path twin. Each kernel is CUDA
C++ for Hopper with a plain PyTorch version for CPU tensors. It imports PyTorch,
numpy and scipy, and never JAX, nor anything of ``open3d_ml_tpu``: its
registries and configuration are its own (``utils``).
"""

from . import dataloaders, datasets, models, pipelines, utils
from .utils import MODEL, PIPELINE, SAMPLER

__all__ = ["MODEL", "PIPELINE", "SAMPLER", "dataloaders", "datasets",
           "models", "pipelines", "utils"]
