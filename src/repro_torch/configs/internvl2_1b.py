"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT (stub) + Qwen2-0.5B-family LM backbone.
[arXiv:2404.16821; hf]

Backbone only (per assignment): the InternViT frontend is a STUB —
input_specs() provides precomputed patch embeddings (B, n_patches, d_model)
which are prepended to the token embeddings; loss is masked over the patch
region.  No decode over patches (encoder-side), so decode shapes exercise
the LM only.
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    unit=(Block("attn"),),
    num_units=24,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    tie_embeddings=True,
    frontend="vision",
    n_patches=256,
    max_seq_len=32768,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B",
)
