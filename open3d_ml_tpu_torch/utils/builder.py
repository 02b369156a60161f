"""``get_module``: a registered class by kind and name.

Counterpart of ``open3d_ml_tpu/utils/builder.py``, over the port's own
registries, with one backend and so no framework argument. Importing the
port's subpackages registers their classes.
"""

import importlib

from .registry import DATASET, MODEL, PIPELINE, SAMPLER, get_from_name

_REGISTRIES = {"model": (MODEL, "models"),
               "dataset": (DATASET, "datasets"),
               "pipeline": (PIPELINE, "pipelines"),
               "sampler": (SAMPLER, "datasets.samplers")}


def get_module(module_type, module_name):
    """The class registered as ``module_name`` of ``module_type``
    ('model', 'dataset', 'pipeline' or 'sampler')."""
    if module_type not in _REGISTRIES:
        raise KeyError(f"Unknown module type: {module_type!r}; one of "
                       f"{sorted(_REGISTRIES)}")
    registry, package = _REGISTRIES[module_type]
    importlib.import_module(f"open3d_ml_tpu_torch.{package}")
    return get_from_name(module_name, registry)
