"""Configurations of the port: the DPRT workload (``radon_251``) and the
LM substrate's ten architectures (``registry``)."""
from .registry import ARCH_IDS, ALIASES, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "ALIASES", "get_config", "get_smoke_config"]
