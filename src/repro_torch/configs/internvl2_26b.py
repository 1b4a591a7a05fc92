"""internvl2-26b [arXiv:2404.16821]: InternViT (stub) + InternLM2 backbone.

The vision frontend is a STUB per assignment: ``input_specs`` provides
precomputed patch embeddings as a prefix; the backbone below is the
InternLM2-20B-class decoder given in the assignment.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=92553, rope_theta=1000000.0,
        frontend="patch_stub", prefix_len=256)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, prefix_len=4, chunk_kv=32, chunk_q=32)
