"""mamba2-2.7b [arXiv:2405.21060]: SSD (state-space duality), attn-free."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=1, num_kv_heads=1,
        head_dim=64, d_ff=0, vocab_size=50280,
        block_pattern=("mamba",), ssm_state=128, ssm_expand=2,
        ssm_head_dim=64, ssm_groups=1, ssm_chunk=256, conv_width=4)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=32, chunk_kv=32, chunk_q=32)
