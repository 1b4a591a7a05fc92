"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B]: 128 experts, top-8."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
        head_dim=128, d_ff=1536, vocab_size=151936, rope_theta=1000000.0,
        qk_norm=True,
        num_experts=128, experts_per_token=8, moe_d_ff=1536,
        capacity_factor=1.25)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_experts=8, experts_per_token=2,
        moe_d_ff=64, chunk_kv=32, chunk_q=32)
