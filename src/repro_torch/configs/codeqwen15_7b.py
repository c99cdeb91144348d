"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H (GQA kv=32 ⇒ MHA) d_ff=13440
vocab=92416 — qwen1.5 arch (QKV bias). [hf:Qwen/CodeQwen1.5-7B]"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    unit=(Block("attn"),),
    num_units=32,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    max_seq_len=65536,
    source="hf:Qwen/CodeQwen1.5-7B",
)
