"""The paper's own workload: 251x251 8-bit images (Sec. V)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class RadonConfig:
    n: int = 251          # prime image size
    bits: int = 8         # B, bits per pixel
    strip_rows: int = 16  # H, the paper's scalability knob
    m_block: int = 8      # direction block (TPU sublane tiling)
    batch: int = 256      # images per service batch


def config() -> RadonConfig:
    return RadonConfig()


def smoke_config() -> RadonConfig:
    return RadonConfig(n=31, batch=8, strip_rows=4, m_block=8)
