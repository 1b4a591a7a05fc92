"""minitron-8b [arXiv:2407.14679]: width-pruned Nemotron dense GQA."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=16384, vocab_size=256000, rope_theta=10000.0)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, chunk_kv=32, chunk_q=32)
