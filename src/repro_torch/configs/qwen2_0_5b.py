"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias, tied embeddings. [arXiv:2407.10671; hf]"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151936,
    unit=(Block("attn"),),
    num_units=24,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    tie_embeddings=True,
    max_seq_len=32768,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-0.5B",
)
