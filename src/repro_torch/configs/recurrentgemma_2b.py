"""recurrentgemma-2b [arXiv:2402.19427]: RG-LRU + local attn, 1:2 pattern."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256000,
        block_pattern=("recurrent", "recurrent", "local_attn"),
        window=2048, lru_width=2560, tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, window=16, lru_width=64,
        chunk_kv=32, chunk_q=32)
