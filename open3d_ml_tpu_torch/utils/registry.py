"""The port's own registries: name -> class.

Counterpart of ``open3d_ml_tpu/utils/registry.py``, with one backend and so
no framework key. A model registered here never appears in the JAX
package's ``MODEL``, and the reverse.
"""


class Registry:
    """name -> class map."""

    def __init__(self, name):
        self.name = name
        self._modules = {}

    def get(self, key):
        return self._modules.get(key)

    def register_module(self, name=None):
        def _register(cls):
            self._modules[cls.__name__ if name is None else name] = cls
            return cls

        return _register

    def keys(self):
        return sorted(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def __repr__(self):
        return f"Registry(name={self.name}, items={self.keys()})"


MODEL = Registry("model")
PIPELINE = Registry("pipeline")
SAMPLER = Registry("sampler")
DATASET = Registry("dataset")


def get_from_name(module_name, registry):
    """The class registered as ``module_name`` in ``registry``; raises
    with the registry's keys when there is none."""
    if module_name is None:
        raise ValueError(f"Missing module name for registry {registry.name}")
    cls = registry.get(module_name)
    if cls is None:
        raise KeyError(f"{module_name!r} is not registered in "
                       f"{registry.name} registry. Available: "
                       f"{registry.keys()}")
    return cls


__all__ = ["DATASET", "MODEL", "PIPELINE", "SAMPLER", "Registry",
           "get_from_name"]
