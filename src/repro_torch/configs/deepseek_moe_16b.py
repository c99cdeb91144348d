"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) vocab=102400,
fine-grained MoE: 2 shared + 64 routed experts top-6, expert d_ff=1408.
Layer 0 is a dense SwiGLU (d_ff=10944); layers 1..27 are MoE.
[arXiv:2401.06066; hf]
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense layer 0 only
    vocab=102400,
    prefix=(Block("attn"),),
    unit=(Block("moe"),),
    num_units=27,
    n_experts=64,
    top_k=6,
    n_shared=2,
    d_expert=1408,
    d_shared=2816,  # 2 shared experts fused (2 × 1408)
    capacity_factor=1.25,
    rope_theta=10_000.0,
    mlp_kind="swiglu",
    max_seq_len=16384,
    source="arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
)
