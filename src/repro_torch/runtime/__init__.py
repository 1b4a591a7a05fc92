"""The training runtime (the port of the reference's ``runtime``)."""
from .trainer import SimulatedFailure, Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "SimulatedFailure"]
