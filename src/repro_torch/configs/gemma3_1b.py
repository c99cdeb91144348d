"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
— 5:1 local:global sliding-window pattern, 128k-class context.
[hf:google/gemma-3-1b-pt; unverified tier]

26 layers = (5 local + 1 global) × 4 units + 2 local suffix. Local layers:
512-token sliding window, rope θ=10k; global layers rope θ=1M.  Gemma
conventions: (1+w) RMSNorm, sandwich norms, √d embedding scale, tied
embeddings.
"""

from .base import Block, ModelConfig

_LOCAL = Block("attn", window=512, rope_theta=10_000.0)
_GLOBAL = Block("attn", window=0, rope_theta=1_000_000.0)

CONFIG = ModelConfig(
    name="gemma3-1b",
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    unit=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    num_units=4,
    suffix=(_LOCAL, _LOCAL),
    qkv_bias=False,
    mlp_kind="geglu",
    norm_plus_one=True,
    sandwich_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    max_seq_len=131072,
    source="hf:google/gemma-3-1b-pt (unverified)",
)
