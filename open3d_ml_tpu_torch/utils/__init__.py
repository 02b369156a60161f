"""Registries, configuration and weight conversion of the port."""

from .config import Config
from .convert_jax import load_jax_variables
from .registry import MODEL, PIPELINE, SAMPLER

__all__ = ["MODEL", "PIPELINE", "SAMPLER", "Config", "load_jax_variables"]
