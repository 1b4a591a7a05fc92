"""tinyllama-1.1b [arXiv:2401.02385]: llama2-arch small dense GQA."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=64, d_ff=5632, vocab_size=32000, rope_theta=10000.0)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, chunk_kv=32, chunk_q=32)
