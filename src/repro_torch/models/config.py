"""Unified model configuration of the LM substrate (a copy of the
reference's ``models/config.py``: every field and property)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # block pattern, cycled over layers: attn|local_attn|recurrent|mamba
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 2048                # local attention window
    rope_theta: float = 10000.0
    qk_norm: bool = False
    tie_embeddings: bool = False
    mlp_act: str = "silu"             # silu (SwiGLU) | gelu (plain MLP)
    learned_pos: int = 0              # >0: learned positions (disables RoPE)
    pad_vocab_multiple: int = 128     # pad embedding table for clean TP

    # mixture of experts
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "grouped"   # grouped (optimized, §Perf B) | global (baseline)

    # multi-head latent attention (DeepSeek-V2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # state-space (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU (RecurrentGemma / Griffin)
    lru_width: int = 0

    # encoder-decoder (Whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500
    cross_attention: bool = False

    # modality frontend stub
    frontend: str = "none"            # none|audio_stub|patch_stub
    prefix_len: int = 0               # precomputed patch/frame prefix length

    norm_eps: float = 1e-6
    remat: str = "full"               # none|full|dots
    scan_layers: bool = True
    chunk_q: int = 512
    chunk_kv: int = 4096
    causal_skip: bool = True          # skip fully-masked kv chunks (perf)
    attn_impl: str = "segmented" # segmented (optimized, §Perf C) | chunked (baseline) | qchunked
    attn_segments: int = 8       # triangle segments for attn_impl=segmented

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        if m <= 1:
            return self.vocab_size
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self):
        """Per-layer (block_kind, mlp_kind) resolved from the pattern."""
        kinds = []
        for i in range(self.num_layers):
            blk = self.block_pattern[i % len(self.block_pattern)]
            if blk == "mamba":
                mlp = "none"
            elif self.num_experts > 0 and i >= self.first_dense_layers:
                mlp = "moe"
            else:
                mlp = "dense"
            kinds.append((blk, mlp))
        return kinds

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
