"""Registries, configuration, the preprocess cache and weight conversion of
the port."""

from .config import Config
from .convert_jax import load_jax_variables, state_dict_to_jax
from .dataset_helper import Cache, get_hash, make_dir
from .registry import DATASET, MODEL, PIPELINE, SAMPLER

__all__ = ["DATASET", "MODEL", "PIPELINE", "SAMPLER", "Cache", "Config",
           "get_hash",
           "load_jax_variables", "make_dir", "state_dict_to_jax"]
