"""deepseek-v2-236b [arXiv:2405.04434]: MLA (kv_lora=512) + 2 shared +
160 routed experts top-6; first layer dense."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        head_dim=128, d_ff=12288, vocab_size=102400, rope_theta=10000.0,
        num_experts=160, experts_per_token=6, moe_d_ff=1536,
        shared_experts=2, first_dense_layers=1, capacity_factor=1.25,
        q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
        nope_head_dim=128, v_head_dim=128)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, num_experts=8, experts_per_token=2,
        moe_d_ff=64, shared_experts=1, q_lora_rank=32, kv_lora_rank=16,
        rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
        chunk_kv=32, chunk_q=32)
