"""Architecture registry of the LM substrate: --arch <id> resolves here.

Every module defines ``config()`` (the exact assigned configuration) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

ARCH_IDS: List[str] = [
    "phi3_medium_14b",
    "tinyllama_1_1b",
    "minitron_8b",
    "qwen3_0_6b",
    "internvl2_26b",
    "qwen3_moe_235b_a22b",
    "deepseek_v2_236b",
    "whisper_large_v3",
    "recurrentgemma_2b",
    "mamba2_2_7b",
]

# canonical dashed ids from the assignment
ALIASES: Dict[str, str] = {
    "phi3-medium-14b": "phi3_medium_14b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "minitron-8b": "minitron_8b",
    "qwen3-0.6b": "qwen3_0_6b",
    "internvl2-26b": "internvl2_26b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "whisper-large-v3": "whisper_large_v3",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-2.7b": "mamba2_2_7b",
}


def _module(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f".{arch}", __package__)


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke_config()
