"""Optimizers with weight decay kept off biases and normalisation, and
one-cycle Adam.

Counterpart of ``open3d_ml_tpu/modules/optimizers.py``, whose optax mask
becomes two ``torch.optim`` parameter groups. A parameter is decayed
exactly where the JAX path rule decays its flax leaf: the parameter's
name is mapped to its flax path as ``utils/convert_jax.py`` maps the
weights (a 1-d ``weight`` is a BatchNorm ``scale``, the module's
``JAX_SCOPE`` or ``"net"`` first), and the leaf is not decayed when a
key holds "batch_norm", the key above the leaf holds "bn", or the leaf is
a ``bias`` or a ``scale``.
"""

import torch

from ..utils.convert_jax import net_layout, state_dict_to_jax
from .schedulers import one_cycle_lr


def _flax_path(name, param, layout):
    """The flax path of parameter ``name`` (its ``params`` tree's keys),
    from the converter's own map on a tensor of the parameter's rank."""
    tree = state_dict_to_jax({name: param.new_zeros((1,) * param.ndim)},
                             **layout)["params"]
    path = []
    while isinstance(tree, dict):
        (key, tree), = tree.items()
        path.append(key)
    return path


def _is_norm_or_bias(path):
    keys = [k.lower() for k in path]
    joined = "/".join(keys)
    return ("batch_norm" in joined or "bn" in joined.split("/")[-2:][0]
            if keys else False) or keys[-1] in ("bias", "scale")


def no_decay_mask(module):
    """{parameter name: True} for the parameters of ``module`` that
    receive weight decay (kernels), False for biases and normalisation
    parameters."""
    layout = net_layout(module)
    return {name: not _is_norm_or_bias(_flax_path(name, p, layout))
            for name, p in module.named_parameters()}


def _groups(module, weight_decay):
    """The decayed and the undecayed parameters as two groups."""
    mask = no_decay_mask(module)
    params = dict(module.named_parameters())
    return [{"params": [p for n, p in params.items() if mask[n]],
             "weight_decay": weight_decay},
            {"params": [p for n, p in params.items() if not mask[n]],
             "weight_decay": 0.0}]


def adamw_grouped(module, learning_rate, weight_decay=1e-2,
                  betas=(0.9, 0.999), decay_norm_and_bias=False):
    """AdamW over ``module``'s parameters, weight decay masked off the
    normalisation and bias parameters (unless ``decay_norm_and_bias``)."""
    if decay_norm_and_bias:
        return torch.optim.AdamW(module.parameters(), lr=learning_rate,
                                 betas=tuple(betas),
                                 weight_decay=weight_decay)
    return torch.optim.AdamW(_groups(module, weight_decay),
                             lr=learning_rate, betas=tuple(betas))


def one_cycle_adam(module, total_steps, lr, moms=(0.95, 0.85),
                   div_factor=10.0, pct_start=0.4, weight_decay=0.0):
    """One-cycle Adam: (optimizer, ``LambdaLR``) at peak rate ``lr`` over
    ``total_steps`` updates (``schedulers.one_cycle_lr``), b1 =
    moms[0] and b2 = 0.99 throughout (the momentum does not cycle, as in
    JAX); AdamW with the masked decay where ``weight_decay``, else Adam."""
    betas = (moms[0], 0.99)
    if weight_decay:
        optimizer = torch.optim.AdamW(_groups(module, weight_decay), lr=lr,
                                      betas=betas)
    else:
        optimizer = torch.optim.Adam(module.parameters(), lr=lr,
                                     betas=betas)
    return optimizer, one_cycle_lr(optimizer, total_steps, div_factor,
                                   pct_start)
