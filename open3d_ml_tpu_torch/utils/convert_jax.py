"""Load the JAX package's flax variables into a port network, and turn a
port state_dict back into flax variables.

The port names its modules after the flax variable tree, so a flax path
``params/net/encoder_0/lse1/mlp/conv/kernel`` becomes the state_dict key
``encoder_0.lse1.mlp.conv.weight``. Leaves map as follows:

* Dense ``kernel [in, out]`` -> Linear ``weight [out, in]`` (transposed);
* Dense and BatchNorm ``bias`` -> ``bias``;
* BatchNorm ``scale`` -> ``weight``;
* batch_stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.

``state_dict_to_jax`` is the inverse map, so weights trained on the card
can be applied by the JAX package. BatchNorm hyper-parameters need no
conversion: the port builds its layers
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


def state_dict_to_jax(state_dict):
    """A port state_dict -> ``{"params": {"net": ...}, "batch_stats":
    {"net": ...}}`` with float32 numpy leaves, the inverse of
    ``jax_to_state_dict``: a 2-d ``weight`` is a Dense ``kernel``
    (transposed), a 1-d one a BatchNorm ``scale``; the running statistics
    go to ``batch_stats``; ``num_batches_tracked`` has no flax leaf."""
    out = {"params": {"net": {}}, "batch_stats": {"net": {}}}
    stats = {v: k for k, v in _STAT_LEAVES.items()}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        value = value.detach().cpu().float().numpy()
        if leaf in stats:
            collection, name = "batch_stats", stats[leaf]
        elif leaf == "weight":
            collection = "params"
            name = "kernel" if value.ndim == 2 else "scale"
            value = value.T if value.ndim == 2 else value
        elif leaf == "bias":
            collection, name = "params", "bias"
        else:
            raise KeyError(f"no flax leaf for {key}")
        tree = out[collection]["net"]
        for part in path:
            tree = tree.setdefault(part, {})
        tree[name] = np.ascontiguousarray(value)
    return out
