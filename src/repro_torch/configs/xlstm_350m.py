"""xlstm-350m [ssm] — 24L d_model=1024 4 heads, d_ff=0 vocab=50304 —
alternating sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified tier]

Block ratio choice (config tier is unverified): 1:1 alternating
(mLSTM, sLSTM) × 12 — see DESIGN.md §Arch-applicability for the
simplifications vs the reference CUDA kernels.  d_ff=0: xLSTM blocks carry
their own up/down projections (mLSTM pf=2, sLSTM pf=4/3).
"""

from .base import Block, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50304,
    unit=(Block("mlstm"), Block("slstm")),
    num_units=12,
    xlstm_heads=4,
    mlp_kind="gelu",
    max_seq_len=1_048_576,  # recurrent: O(1) state in sequence length
    source="arXiv:2405.04517 (unverified)",
)
