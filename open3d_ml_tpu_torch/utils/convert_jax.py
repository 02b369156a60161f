"""Load the JAX package's flax variables into a port network, and turn a
port state_dict back into flax variables.

The port names its modules after the flax variable tree, so a flax path
``params/net/encoder_0/lse1/mlp/conv/kernel`` becomes the state_dict key
``encoder_0.lse1.mlp.conv.weight``. The semantic segmentation nets' trees
sit in the scope ``"net"`` (the JAX ``BatchedNet`` wrapper);
PointPillars' and PointRCNN's trees have no such scope (``JAX_SCOPE =
None`` on their nets): PointRCNN's leaves are ``rpn/backbone/sa{i}/
mlp{j}/conv{k}`` and ``bn{k}``, ``rpn/backbone/fp{j}/mlp/...``, the
heads' ``rpn/{cls,reg}_blocks/{conv0,bn0,final}``, and ``rcnn/...``
(``xyz_up_layer`` and ``merge_down_layer`` biased, without BatchNorm),
each a Dense or a BatchNorm mapped as below.
Leaves map as follows:

* Dense ``kernel [in, out]`` -> Linear ``weight [out, in]`` (transposed);
* a stencil ``kernel [K, Cin, Cout]`` (SparseConvUnet's convolutions) ->
  ``weight [K, Cin, Cout]``, as it is;
* Conv ``kernel [kh, kw, in, out]`` -> Conv2d ``weight [out, in, kh,
  kw]``;
* a 3D Conv ``kernel [kd, kh, kw, in, out]`` (PVCNN's voxel branch,
  NDHWC) -> Conv3d ``weight [out, in, kd, kh, kw]``;
* ConvTranspose ``kernel [kh, kw, in, out]`` -> ConvTranspose2d
  ``weight [in, out, kh, kw]``, spatially flipped: flax's default
  (``transpose_kernel=False``) is a fractionally strided convolution with
  the kernel as it is, torch's the gradient of a convolution;
* a stencil weight that sits in a scope by its own name
  (SparseConvUnet's ``l{i}_down_kernel``, ``l{i}_up_kernel``) -> the
  parameter of the same name, as it is;
* Dense, Conv and BatchNorm ``bias`` -> ``bias``;
* BatchNorm ``scale`` -> ``weight``;
* batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
* KPConv's leaves keep their names: ``weights [P, Cin, Cout]`` (not
  transposed), ``offset_bias``, a block's ``{prefix}_bias`` (its bias
  where it has no batch norm), and the ``kp_points`` collection's
  ``points`` (the kernel points), which is a buffer.

``state_dict_to_jax`` is the inverse map, so weights trained on the card
can be applied by the JAX package. BatchNorm hyper-parameters need no
conversion: each port net builds its layers with the JAX net's eps (1e-6
for RandLA-Net, 1e-4 for SparseConvUnet, 1e-3 for PointPillars) and
torch momentum 0.01, which is flax momentum 0.99.
"""

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
# a weight leaf named after its layer, not inside a scope of its own
_NAMED_KERNEL = "_kernel"
# KPConv's parameter leaves that keep their names (and every "*_bias")
_KEPT = ("weights",)
_KEPT_SUFFIX = "_bias"
# KPConv's kernel points: the collection and its one leaf, a buffer
_KP_COLLECTION, _KP_LEAF = "kp_points", "points"


def _kept(leaf):
    return leaf in _KEPT or leaf.endswith(_KEPT_SUFFIX) or \
        leaf.endswith(_NAMED_KERNEL)


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _kernel_to_torch(value, transposed):
    if value.ndim == 2:
        return value.T
    if value.ndim == 4:
        return (value[::-1, ::-1].transpose(2, 3, 0, 1) if transposed
                else value.transpose(3, 2, 0, 1))
    if value.ndim == 5:
        return value.transpose(4, 3, 0, 1, 2)
    return value


def _kernel_to_jax(value, transposed):
    if value.ndim == 2:
        return value.T
    if value.ndim == 4:
        return (value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1) if transposed
                else value.transpose(2, 3, 1, 0))
    if value.ndim == 5:
        return value.transpose(2, 3, 4, 1, 0)
    return value


def net_layout(net):
    """The conversion's arguments for ``net``: its flax scope
    (``JAX_SCOPE``, default ``"net"``) and the paths of its transposed
    convolutions."""
    return {"scope": getattr(net, "JAX_SCOPE", "net"),
            "transposed": frozenset(
                name for name, m in net.named_modules()
                if isinstance(m, torch.nn.ConvTranspose2d))}


def jax_to_state_dict(variables, scope="net", transposed=frozenset()):
    """``{"params": ..., "batch_stats": ...}`` and, for KPConv,
    ``"kp_points"`` (numpy leaves, the net's tree under ``scope``, or at
    the root for ``scope=None``) -> a port state_dict of float32 tensors.
    ``transposed``: the dotted paths of the modules whose 4-d kernel is a
    ConvTranspose's."""
    out = {}
    for collection, leaves in (("params", _PARAM_LEAVES),
                               ("batch_stats", _STAT_LEAVES),
                               (_KP_COLLECTION, {_KP_LEAF: _KP_LEAF})):
        tree = variables.get(collection, {})
        if scope is not None:
            if tree and set(tree) != {scope}:
                raise KeyError(f"{collection}: expected the single scope "
                               f"{scope!r}, got {sorted(tree)}")
            tree = tree.get(scope, {})
        for path, value in _flatten(tree):
            value = np.asarray(value, np.float32)
            if collection == "params" and _kept(path[-1]):
                out[".".join(path)] = torch.tensor(value)
                continue
            if path[-1] not in leaves:
                raise KeyError(f"unknown {collection} leaf {'/'.join(path)}")
            if path[-1] == "kernel":
                value = _kernel_to_torch(value,
                                         ".".join(path[:-1]) in transposed)
            key = ".".join(path[:-1] + (leaves[path[-1]],))
            out[key] = torch.tensor(value.copy())
    return out


def load_jax_variables(net, variables):
    """Copy flax variables into ``net`` in place.

    Raises KeyError when a port tensor has no JAX leaf or a JAX leaf has no
    port tensor, and ValueError on a shape mismatch.
    """
    sd = jax_to_state_dict(variables, **net_layout(net))
    target = {k: v for k, v in net.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    missing = sorted(set(target) - set(sd))
    unused = sorted(set(sd) - set(target))
    if missing or unused:
        raise KeyError(f"missing {missing}, unused {unused}")
    for key, value in sd.items():
        if value.shape != target[key].shape:
            raise ValueError(f"{key}: JAX shape {tuple(value.shape)}, port "
                             f"shape {tuple(target[key].shape)}")
    net.load_state_dict(sd, strict=False)
    return net


def state_dict_to_jax(state_dict, scope="net", transposed=frozenset()):
    """A port state_dict -> ``{"params": ..., "batch_stats": ...}`` with
    float32 numpy leaves (under ``scope``, or at the root for
    ``scope=None``), the inverse of ``jax_to_state_dict``: a 2-d
    ``weight`` is a Dense ``kernel`` (transposed), a 3-d one a stencil
    ``kernel``, a 4-d one a Conv ``kernel`` (a ConvTranspose's for a path
    in ``transposed``), a 5-d one a 3D Conv ``kernel``, a 1-d one a
    BatchNorm ``scale``; a parameter named
    ``*_kernel`` keeps its name; the running statistics go to
    ``batch_stats``; ``num_batches_tracked`` has no flax leaf.
    ``net_layout(net)`` gives a net's arguments."""
    out = {"params": {}, "batch_stats": {}}
    if scope is not None:
        out = {k: {scope: v} for k, v in out.items()}
    stats = {v: k for k, v in _STAT_LEAVES.items()}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        value = value.detach().cpu().float().numpy()
        if leaf in stats:
            collection, name = "batch_stats", stats[leaf]
        elif leaf == _KP_LEAF:
            collection, name = _KP_COLLECTION, leaf
            out.setdefault(collection, {} if scope is None else {scope: {}})
        elif _kept(leaf):
            collection, name = "params", leaf
        elif leaf == "weight":
            collection = "params"
            name = "scale" if value.ndim == 1 else "kernel"
            value = _kernel_to_jax(value, ".".join(path) in transposed)
        elif leaf == "bias":
            collection, name = "params", "bias"
        else:
            raise KeyError(f"no flax leaf for {key}")
        tree = out[collection]
        if scope is not None:
            tree = tree[scope]
        for part in path:
            tree = tree.setdefault(part, {})
        tree[name] = value.copy()
    return out
