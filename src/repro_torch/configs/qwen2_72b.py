"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA, QKV bias. [arXiv:2407.10671; hf]"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab=152064,
    unit=(Block("attn"),),
    num_units=80,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    max_seq_len=32768,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-72B",
)
