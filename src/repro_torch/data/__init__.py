"""Deterministic synthetic data (numpy, copied from the reference) and
the input pipeline (prefetch, placement on the device)."""
from .pipeline import Prefetcher, shard_batch
from .synthetic import TokenStream, phantom_image, radon_images

__all__ = ["TokenStream", "phantom_image", "radon_images", "Prefetcher",
           "shard_batch"]
