"""Config schema — a copy of ``repro.configs.base`` for the port (plain
dataclasses; the port imports nothing of ``repro``).  A model is a
(prefix, repeating-unit × N, suffix) stack of heterogeneous blocks; the
port's `models.transformer` runs the units as a plain loop.  Prefix and
suffix hold non-repeating layers (e.g. DeepSeekMoE's dense layer 0,
RecurrentGemma's ragged tail).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Block:
    kind: str  # "attn" | "moe" | "mlstm" | "slstm" | "rglru"
    window: int = 0  # attn: sliding window (0 = full causal)
    rope_theta: float = 0.0  # attn: per-block rope base override (0 = cfg default)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    unit: tuple[Block, ...]
    num_units: int
    prefix: tuple[Block, ...] = ()
    suffix: tuple[Block, ...] = ()
    head_dim: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    mlp_kind: str = "swiglu"  # "swiglu" | "gelu"
    norm_plus_one: bool = False  # gemma (1+w) RMSNorm
    sandwich_norms: bool = False  # gemma3 post-attn / post-ffn norms
    embed_scale: bool = False  # gemma x *= sqrt(d)
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    d_shared: int = 0
    capacity_factor: float = 1.25
    # EP padding: expert tensors padded to this count so the expert dim
    # divides the model axis (granite: 40 → 48); router stays at n_experts,
    # padded experts are dead weight (counted in the HLO-vs-model FLOPs
    # ratio, see EXPERIMENTS.md).
    n_experts_pad: int = 0
    # recurrent
    lru_width: int = 0
    xlstm_heads: int = 4
    # modality frontend stub: None | "audio" | "vision"
    frontend: str | None = None
    n_patches: int = 256  # vision stub: patch-embedding count
    max_seq_len: int = 32768
    # loss
    z_loss_weight: float = 0.0
    # notes for DESIGN.md §Arch-applicability / provenance
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + self.num_units * len(self.unit) + len(self.suffix)

    @property
    def blocks(self) -> list[Block]:
        return list(self.prefix) + list(self.unit) * self.num_units + list(self.suffix)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head); used for
        MODEL_FLOPS = 6·N·D in the roofline."""
        d, hd = self.d_model, self.hd
        n = self.vocab * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab * d  # head
        for b in self.blocks:
            if b.kind in ("attn", "moe"):
                attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
                if self.qkv_bias:
                    attn += (self.n_heads + 2 * self.n_kv_heads) * hd
                n += attn + 2 * d  # + norms
                if b.kind == "attn":
                    mult = 3 if self.mlp_kind == "swiglu" else 2
                    n += mult * d * self.d_ff
                else:
                    n += d * self.n_experts  # router
                    n += self.n_experts * 3 * d * self.d_expert
                    if self.n_shared:
                        n += 3 * d * self.d_shared
            elif b.kind == "mlstm":
                di = 2 * d
                n += d + 2 * d * di + 4 * di + di * (3 * di + 2 * self.xlstm_heads) + di * d + di
            elif b.kind == "slstm":
                hd_s = d // self.xlstm_heads
                n += d + d * 4 * d + self.xlstm_heads * hd_s * 4 * hd_s + 4 * d + d * d
                n += d + 3 * d * int(d * 4 / 3)
            elif b.kind == "rglru":
                w = self.lru_width
                n += d + 2 * d * w + 4 * w + 2 * w * w + 2 * w + w * d
                mult = 3 if self.mlp_kind == "swiglu" else 2
                n += d + mult * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        full = self.param_count()
        n_moe_blocks = sum(1 for b in self.blocks if b.kind == "moe")
        inactive = n_moe_blocks * (self.n_experts - self.top_k) * 3 * self.d_model * self.d_expert
        return full - inactive


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests: same block pattern,
    same kinds, small dims."""
    hd = 16
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    small = dict(
        d_model=n_heads * hd,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=96 if cfg.d_ff else 0,
        vocab=512,
        num_units=min(2, cfg.num_units),
        n_experts=min(8, cfg.n_experts) if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        d_expert=32 if cfg.d_expert else 0,
        d_shared=64 if cfg.d_shared else 0,
        lru_width=n_heads * hd if cfg.lru_width else 0,
        xlstm_heads=2,
        n_patches=8,
        max_seq_len=128,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


field  # (re-export guard)
