"""Load the reference's PyTorch checkpoints into the port's networks.

Counterpart of ``open3d_ml_tpu/utils/convert_torch.py``, which maps a
reference ``state_dict`` onto the JAX package's flax variables; here the
map goes onto the port's parameter names (those of the flax tree, see
``utils/convert_jax.py``). Conventions:

* a 1x1 ``Conv1d`` or ``Conv2d`` weight [out, in, 1(, 1)] -> Linear
  ``weight [out, in]``;
* a ``Conv3d`` weight [out, in, kd, kh, kw] -> Conv3d ``weight``, as it is
  (both the reference and the port voxelise x, y, z onto the grid's
  D, H, W axes);
* BatchNorm ``weight``, ``bias``, ``running_mean`` and ``running_var``
  keep their names under the port's module path; the reference's
  ``num_batches_tracked`` is dropped.

Ported: ``convert_pvcnn``. The other models' converters are ROADMAP
queue 1 item 8.
"""

import numpy as np
import torch

# the reference's PVCNN trunk (pvcnn.py:107-134): (out_channels,
# num_blocks, voxel_resolution), None for a shared MLP
PVCNN_BLOCKS = ((64, 1, 32), (64, 2, 16), (128, 1, 16), (1024, 1, None))
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _tensor(value):
    return torch.tensor(np.asarray(value, np.float32))


def convert_pvcnn(state_dict):
    """A reference PVCNN ``state_dict`` (``point_features`` a ModuleList of
    PVConv and SharedMLP blocks, ``cloud_features`` and ``classifier``
    Sequentials; ``with_se=False``, as the reference builds it) -> the
    port's ``PVCNNNet`` state_dict of float32 tensors:

    * ``point_features.{i}.voxel_layers.{0, 3}`` (Conv3d) and ``.{1, 4}``
      (BatchNorm) -> ``pf{i}.vconv{0, 1}`` and ``pf{i}.vbn{0, 1}``;
    * a SharedMLP's ``layers.0`` (1x1 Conv1d) and ``layers.1``
      (BatchNorm) -> ``dense_0`` and ``bn_0`` (a PVConv's under
      ``point_features``, the last block's under ``pf{i}``);
    * ``cloud_features.{j}.0`` and ``.1`` -> ``cloud{j}`` and
      ``cloud_bn{j}``;
    * ``classifier.0`` and ``.2`` (SharedMLPs) -> ``cls0`` and ``cls1``,
      ``classifier.4`` (1x1 Conv1d) -> ``cls2``.

    Widths are read from the tensors, so any width multiplier converts.
    Raises KeyError where a key the net needs is missing."""
    sd = dict(state_dict)
    out = {}

    def linear(src, dst):
        w = np.asarray(sd[src + ".weight"], np.float32)
        out[dst + ".weight"] = _tensor(w.reshape(w.shape[0], w.shape[1]))
        if src + ".bias" in sd:
            out[dst + ".bias"] = _tensor(sd[src + ".bias"])

    def bn(src, dst):
        for leaf in _BN_LEAVES:
            out[f"{dst}.{leaf}"] = _tensor(sd[f"{src}.{leaf}"])

    def shared_mlp(src, dst):
        linear(src + ".layers.0", dst + ".dense_0")
        bn(src + ".layers.1", dst + ".bn_0")

    li = 0
    for _, num_blocks, res in PVCNN_BLOCKS:
        for _ in range(num_blocks):
            src, dst = f"point_features.{li}", f"pf{li}"
            if res is None:
                shared_mlp(src, dst)
            else:
                for i in range(2):
                    conv = f"{src}.voxel_layers.{3 * i}"
                    out[f"{dst}.vconv{i}.weight"] = _tensor(sd[conv +
                                                               ".weight"])
                    out[f"{dst}.vconv{i}.bias"] = _tensor(sd[conv + ".bias"])
                    bn(f"{src}.voxel_layers.{3 * i + 1}", f"{dst}.vbn{i}")
                shared_mlp(src + ".point_features",
                           dst + ".point_features")
            li += 1
    for j in range(2):
        linear(f"cloud_features.{j}.0", f"cloud{j}")
        bn(f"cloud_features.{j}.1", f"cloud_bn{j}")
    shared_mlp("classifier.0", "cls0")
    shared_mlp("classifier.2", "cls1")
    linear("classifier.4", "cls2")
    return out
