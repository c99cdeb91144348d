"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, MoE 40 experts top-8, no shared experts.
[hf:ibm-granite (granite-3.0 family)]
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,  # all layers MoE
    vocab=49155,
    unit=(Block("moe"),),
    num_units=32,
    n_experts=40,
    n_experts_pad=48,  # EP: 48 divides the 16-way model axis (40 does not)
    top_k=8,
    n_shared=0,
    d_expert=512,
    capacity_factor=1.25,
    rope_theta=10_000.0,
    mlp_kind="swiglu",
    tie_embeddings=True,
    max_seq_len=4096,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (scaled)",
)
