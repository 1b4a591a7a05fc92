"""qwen3-0.6b [hf:Qwen/Qwen3-8B family]: dense GQA with qk-norm."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=128, d_ff=3072, vocab_size=151936, rope_theta=1000000.0,
        qk_norm=True, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, chunk_kv=32, chunk_q=32)
