"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 1 attention per 2 recurrent.
[arXiv:2402.19427; unverified tier]

38 layers = (rglru, rglru, local-attn-2048) × 12 units + 2 rglru suffix.
Griffin conventions: GeGLU MLP, (1+w) RMSNorm, √d embed scale, tied
embeddings, lru_width = d_model.
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    unit=(Block("rglru"), Block("rglru"), Block("attn", window=2048)),
    num_units=12,
    suffix=(Block("rglru"), Block("rglru")),
    lru_width=4096,
    rope_theta=10_000.0,
    mlp_kind="geglu",
    norm_plus_one=True,
    embed_scale=True,
    tie_embeddings=True,
    max_seq_len=1_048_576,  # local attention bounds the KV; state is O(1)
    source="arXiv:2402.19427 (unverified)",
)
