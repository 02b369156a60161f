"""Registries, configuration, the preprocess cache, logging helpers and
weight conversion of the port."""

from .builder import get_module
from .config import Config, ConfigDict, ModuleConfig
from .convert_jax import load_jax_variables, state_dict_to_jax
from .dataset_helper import Cache, get_hash, make_dir
from .log import LogRecord, code2md, get_runid
from .registry import DATASET, MODEL, PIPELINE, SAMPLER, get_from_name

__all__ = ["DATASET", "MODEL", "PIPELINE", "SAMPLER", "Cache", "Config",
           "ConfigDict", "LogRecord", "ModuleConfig", "code2md",
           "get_from_name", "get_hash", "get_module", "get_runid",
           "load_jax_variables", "make_dir", "state_dict_to_jax"]
