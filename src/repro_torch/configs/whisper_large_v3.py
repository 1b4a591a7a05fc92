"""whisper-large-v3 [arXiv:2212.04356]: enc-dec; conv frontend is a STUB
(``input_specs`` provides precomputed 1500-frame embeddings)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="audio",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        head_dim=64, d_ff=5120, vocab_size=51866, mlp_act="gelu",
        encoder_layers=32, encoder_seq=1500, cross_attention=True,
        frontend="audio_stub", learned_pos=32768)


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, encoder_layers=2, encoder_seq=16,
        learned_pos=128, chunk_kv=32, chunk_q=32)
