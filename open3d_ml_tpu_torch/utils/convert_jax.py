"""Load the JAX package's flax variables into a port network.

The port names its modules after the flax variable tree, so a flax path
``params/net/encoder_0/lse1/mlp/conv/kernel`` becomes the state_dict key
``encoder_0.lse1.mlp.conv.weight``. Leaves map as follows:

* Dense ``kernel [in, out]`` -> Linear ``weight [out, in]`` (transposed);
* Dense and BatchNorm ``bias`` -> ``bias``;
* BatchNorm ``scale`` -> ``weight``;
* batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

BatchNorm hyper-parameters need no conversion: the port builds its layers
with eps 1e-6 and torch momentum 0.01, which is flax momentum 0.99.
"""

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def jax_to_state_dict(variables):
    """``{"params": {"net": ...}, "batch_stats": {"net": ...}}`` (numpy
    leaves; ``"net"`` is the JAX ``BatchedNet`` wrapper's scope) -> a
    port state_dict of float32 tensors."""
    out = {}
    for collection, leaves in (("params", _PARAM_LEAVES),
                               ("batch_stats", _STAT_LEAVES)):
        tree = variables.get(collection, {})
        if tree and set(tree) != {"net"}:
            raise KeyError(f"{collection}: expected the single scope 'net', "
                           f"got {sorted(tree)}")
        for path, value in _flatten(tree.get("net", {})):
            if path[-1] not in leaves:
                raise KeyError(f"unknown {collection} leaf {'/'.join(path)}")
            value = np.asarray(value, np.float32)
            if path[-1] == "kernel":
                value = value.T
            key = ".".join(path[:-1] + (leaves[path[-1]],))
            out[key] = torch.tensor(value)
    return out


def load_jax_variables(net, variables):
    """Copy flax variables into ``net`` in place.

    Raises KeyError when a port tensor has no JAX leaf or a JAX leaf has no
    port tensor, and ValueError on a shape mismatch.
    """
    sd = jax_to_state_dict(variables)
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
