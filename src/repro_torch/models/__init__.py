"""The LM substrate of the port: ten architectures on one model assembly
(the port of :mod:`repro.models`, plain PyTorch)."""
from .config import ModelConfig
from .lm import Model

__all__ = ["ModelConfig", "Model"]
