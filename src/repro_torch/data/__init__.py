"""Deterministic synthetic data (numpy), copied from the reference."""
from .synthetic import TokenStream, phantom_image, radon_images

__all__ = ["TokenStream", "phantom_image", "radon_images"]
