"""phi3-medium-14b [arXiv:2404.14219]: dense, RoPE + SwiGLU + GQA."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
        head_dim=128, d_ff=17920, vocab_size=100352, rope_theta=10000.0)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, chunk_kv=32, chunk_q=32)
