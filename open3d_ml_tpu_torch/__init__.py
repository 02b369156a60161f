"""open3d_ml_tpu_torch: the PyTorch and CUDA port of open3d_ml_tpu.

It covers RandLA-Net inference on the fused bucket path: the Hilbert sort,
the bucket pyramid, the bucket KNN and bucket gather kernels (CUDA C++ for
Hopper, each with a plain PyTorch version for CPU tensors) and the network.
It imports PyTorch and never JAX, nor anything of ``open3d_ml_tpu``: its
registry and configuration are its own (``utils``).
"""

from . import models, utils
from .utils import MODEL

__all__ = ["MODEL", "models", "utils"]
