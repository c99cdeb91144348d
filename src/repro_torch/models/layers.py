"""Shared neural building blocks — the port of ``repro.models.layers``:
RMSNorm, RoPE, GQA attention (full / sliding-window, bias-optional),
SwiGLU, GeGLU and GELU MLPs.

``blockwise_attention`` (an online softmax over KV blocks, O(S·d)
memory) and ``single_query_attention`` (the dense decode path) are the
plain versions of the port's attention kernels and live beside the other
plain versions in `kernels.ref`; this module re-exports them under the
reference's names.  The reference's sharding hints (``constrain``) have
no counterpart here.

Conventions: activations (B, S, D); params are plain dicts of tensors in
the reference's layouts (``wq`` (D, H, hd), ``wo`` (H, hd, D)); f32
softmax statistics.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ref import (  # noqa: F401  (the reference's layer names)
    blockwise_attention, single_query_attention)

# ---------------------------------------------------------------- norms ----


def rms_norm(x, weight, eps: float = 1e-6, plus_one: bool = False,
             dtype=None):
    """RMSNorm; ``plus_one`` selects the Gemma convention ((1+w)·x̂).
    The output takes ``dtype`` (x's by default): a bf16 stream's residual
    sum comes here as its unrounded f32 value where XLA hands the norm
    that value (`residual`)."""
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    w = weight.float()
    if plus_one:
        w = w + 1.0
    return (x32 * inv * w).to(dtype or x.dtype)


def residual(x, d):
    """The residual sum ``x + d`` unrounded, in f32: XLA takes a bf16 sum
    in f32 and rounds it for the stream (``residual(x, d).to(x.dtype)``
    is ``x + d``), but a norm that reads the sum in the same straight-line
    region (no loop boundary between them) gets the f32 value.  At f32
    it is ``x + d``.  (One widening and one add; d is promoted inside
    the add.)"""
    return torch.add(x.float(), d)


def init_rms_norm(d, dtype, plus_one: bool = False, device=None):
    f = torch.zeros if plus_one else torch.ones
    return f((d,), dtype=dtype, device=device)


# ----------------------------------------------------------------- rope ----


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)     # (hd/2,)
    angles = positions[..., None].float() * freqs           # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------- attention block ---


def _normal(generator, shape, std, dtype, device):
    return (torch.randn(shape, generator=generator, device=device)
            * std).to(dtype)


def init_attention(generator, cfg_layer, d_model, dtype, device=None):
    """cfg_layer: dict with n_heads, n_kv_heads, head_dim, qkv_bias."""
    H, KV, hd = (cfg_layer["n_heads"], cfg_layer["n_kv_heads"],
                 cfg_layer["head_dim"])
    std = d_model ** -0.5
    p = {
        "wq": _normal(generator, (d_model, H, hd), std, dtype, device),
        "wk": _normal(generator, (d_model, KV, hd), std, dtype, device),
        "wv": _normal(generator, (d_model, KV, hd), std, dtype, device),
        "wo": _normal(generator, (H, hd, d_model), (H * hd) ** -0.5, dtype,
                      device),
    }
    if cfg_layer.get("qkv_bias", False):
        z = dict(dtype=dtype, device=device)
        p["bq"] = torch.zeros((H, hd), **z)
        p["bk"] = torch.zeros((KV, hd), **z)
        p["bv"] = torch.zeros((KV, hd), **z)
    return p


def qkv_project(p, x, positions, rope_theta=10000.0):
    """x (B,S,D) → q (B,S,H,hd), k/v (B,S,KV,hd), RoPE applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def attn_output(p, ctx):
    """ctx (B,S,H,hd) → (B,S,D) via the o-projection."""
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"])


# ------------------------------------------------------------------ mlps ----


def init_swiglu(generator, d_model, d_ff, dtype, device=None):
    return {
        "wi": _normal(generator, (d_model, d_ff), d_model ** -0.5, dtype,
                      device),
        "wg": _normal(generator, (d_model, d_ff), d_model ** -0.5, dtype,
                      device),
        "wo": _normal(generator, (d_ff, d_model), d_ff ** -0.5, dtype,
                      device),
    }


def silu(x):
    """The reference's ``jax.nn.silu``, x · σ(x) with σ(x) = 1 / (1 +
    exp(−x)).  In bf16 each op rounds to bf16, as XLA rounds each op of
    ``lax.logistic``'s expansion and the product (bit-equal to JAX on the
    CPU); ``F.silu`` rounds once and parts from it on ~40% of the
    outputs.  f32 takes ``F.silu``."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x, widen: bool = False):
    """The reference's ``jax.nn.gelu`` (its tanh approximation), x · 0.5 ·
    (1 + tanh(√(2/π) · (x + 0.044715 · x³))).  In bf16 each op rounds to
    bf16 and the constants are bf16, as in JAX, where ``F.gelu`` rounds
    once; f32 takes ``F.gelu``.  ``widen`` returns f32 with the last
    product unrounded: ``gelu(x).astype(float32)`` as XLA compiles it
    (`models.xlstm._causal_conv1d`)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    inner = scale(x + scale(x * x * x, 0.044715), (2 / math.pi) ** 0.5)
    cdf = 0.5 * (1.0 + torch.tanh(inner))
    return x.float() * cdf.float() if widen else x * cdf


def scale(x, c: float):
    """``x · c`` with the constant rounded to x's dtype first, as JAX
    multiplies an array by a Python number (a weak type), where torch
    would multiply by its f32 value.  The rounded constant stays a Python
    number (no device tensor, no host sync)."""
    return x * float(torch.tensor(c, dtype=x.dtype))


def swiglu_forward(p, x):
    return (silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def init_gelu_mlp(generator, d_model, d_ff, dtype, device=None):
    return {
        "wi": _normal(generator, (d_model, d_ff), d_model ** -0.5, dtype,
                      device),
        "wo": _normal(generator, (d_ff, d_model), d_ff ** -0.5, dtype,
                      device),
    }


def gelu_mlp_forward(p, x):
    # jax.nn.gelu defaults to the tanh approximation
    return gelu(x @ p["wi"]) @ p["wo"]


def geglu_forward(p, x):
    """GeGLU (Griffin/Gemma MLP): gelu-gated — same params as swiglu."""
    return (gelu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


MLP_INIT = {"swiglu": init_swiglu, "geglu": init_swiglu,
            "gelu": init_gelu_mlp}
MLP_FWD = {"swiglu": swiglu_forward, "geglu": geglu_forward,
           "gelu": gelu_mlp_forward}


# --------------------------------------------------------------- helpers ----


def init_embedding(generator, vocab, d_model, dtype, device=None):
    return _normal(generator, (vocab, d_model), d_model ** -0.5, dtype,
                   device)
