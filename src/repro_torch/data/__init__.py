"""Deterministic synthetic data (numpy), copied from the reference."""
from .synthetic import phantom_image, radon_images

__all__ = ["phantom_image", "radon_images"]
