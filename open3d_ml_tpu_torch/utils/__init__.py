"""Registries, configuration, the preprocess cache and weight conversion of
the port."""

from .builder import get_module
from .config import Config, ConfigDict, ModuleConfig
from .convert_jax import load_jax_variables, state_dict_to_jax
from .dataset_helper import Cache, get_hash, make_dir
from .registry import DATASET, MODEL, PIPELINE, SAMPLER, get_from_name

__all__ = ["DATASET", "MODEL", "PIPELINE", "SAMPLER", "Cache", "Config",
           "ConfigDict", "ModuleConfig", "get_from_name", "get_hash",
           "get_module", "load_jax_variables", "make_dir",
           "state_dict_to_jax"]
