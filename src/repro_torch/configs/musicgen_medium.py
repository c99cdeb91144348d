"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24 ⇒ MHA) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only (per assignment): the EnCodec frontend is a STUB —
input_specs() provides precomputed frame embeddings (B,S,d_model); the head
predicts the next EnCodec token (vocab 2048).  Adaptation note: MusicGen
uses sinusoidal positions; we use RoPE (TPU-idiomatic, documented in
DESIGN.md).  Classic (non-gated) GELU MLP per the original transformer LM.
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    unit=(Block("attn"),),
    num_units=48,
    rope_theta=10_000.0,
    mlp_kind="gelu",
    frontend="audio",
    max_seq_len=32768,
    source="arXiv:2306.05284; hf:facebook/musicgen-medium",
)
