"""Registry of assigned architectures + input shapes — a copy of
``repro.configs.registry`` whose modules load from this package.

Every entry matches the assignment block verbatim (layer counts, dims, GQA,
vocab, MoE arrangement); provenance in each config's `source`.  Family
notes / simplifications are in DESIGN.md §Arch-applicability.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from .base import ModelConfig, reduced

ARCH_IDS = [
    "qwen2-72b",
    "qwen2-0.5b",
    "codeqwen1.5-7b",
    "gemma3-1b",
    "xlstm-350m",
    "recurrentgemma-9b",
    "deepseek-moe-16b",
    "granite-moe-3b-a800m",
    "musicgen-medium",
    "internvl2-1b",
]

_MODULES = {
    "qwen2-72b": "qwen2_72b",
    "qwen2-0.5b": "qwen2_0_5b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "gemma3-1b": "gemma3_1b",
    "xlstm-350m": "xlstm_350m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "musicgen-medium": "musicgen_medium",
    "internvl2-1b": "internvl2_1b",
}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"{__package__}.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


# ------------------------------------------------------------- shapes -------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k runs only for sub-quadratic archs (SSM / hybrid / mostly-local
# attention); pure full-attention archs skip it (assignment note).
SUBQUADRATIC = {"xlstm-350m", "recurrentgemma-9b", "gemma3-1b"}


def shapes_for(arch: str):
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in SUBQUADRATIC:
        names.append("long_500k")
    return [SHAPES[n] for n in names]


def all_cells():
    return [(a, s) for a in ARCH_IDS for s in shapes_for(a)]
