"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) —
the port of ``repro.models.rglru``.

Temporal mixing: x → {gate branch, recurrent branch}; the recurrent
branch passes a width-4 causal conv, then the Real-Gated Linear Recurrent
Unit:

    r_t = σ(W_a x_t + b_a)                (recurrence gate)
    i_t = σ(W_x x_t + b_x)                (input gate)
    a_t = exp(c · softplus(Λ) · (−r_t))   (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The recurrence is linear in h.  The reference runs
``lax.associative_scan``; the port runs a log-depth Hillis–Steele scan
over the same (a, b) pairs (`_linear_scan`): ⌈log₂ S⌉ rounds of
elementwise products on (B, S, W), where a time loop would issue S small
steps.  The two associate the products differently, so ``h`` agrees to
f32 rounding (1e-5 in the tests).  Decode is the single-step transition.
The JAX package runs no Pallas kernel here, so neither does the port.
Under a mesh the gates' products run on each rank's shard
(`parallel.shard_recurrent.mesh_rglru_coeffs`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .cache import make_rglru_state
from .layers import _normal, gelu, residual, rms_norm
from .xlstm import _causal_conv1d

_C = 8.0  # the paper's fixed decay sharpening constant


def init_rglru_block(generator, d_model, lru_width, dtype, device=None):
    std, stdl = d_model ** -0.5, lru_width ** -0.5
    # Λ so that a^(1/c) ∈ [0.9, 0.999] (the paper's init)
    u = (torch.rand((lru_width,), generator=generator, device=device)
         * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2)
    lam = torch.log(torch.exp(-torch.log(u) / (2 * _C)) - 1.0)

    def n(shape, s):
        return _normal(generator, shape, s, dtype, device)

    z = dict(dtype=dtype, device=device)
    return {
        "ln": torch.ones((d_model,), **z),
        "w_y": n((d_model, lru_width), std),     # gate branch
        "w_x": n((d_model, lru_width), std),     # recurrent branch
        "conv": n((4, lru_width), 0.1),
        "w_a": n((lru_width, lru_width), stdl),
        "b_a": torch.zeros((lru_width,), **z),
        "w_i": n((lru_width, lru_width), stdl),
        "b_i": torch.zeros((lru_width,), **z),
        "lam": lam.float(),
        "w_out": n((lru_width, d_model), stdl),
    }


def _rglru_coeffs(p, u, u_in=None):
    """u: (B, S, W) conv'd branch in f32 (`_branches`) → (a, b) with h_t =
    a_t h_{t−1} + b_t; the gates' products take it in the weights'
    dtype.  ``u_in``: what the products take, when ``u`` holds a column
    shard of it (`parallel.shard_recurrent.mesh_rglru_coeffs`)."""
    u_in = (u if u_in is None else u_in).to(p["w_a"].dtype)
    r = torch.sigmoid(torch.einsum("bsw,wv->bsv", u_in, p["w_a"]).float()
                      + p["b_a"].float())
    i = torch.sigmoid(torch.einsum("bsw,wv->bsv", u_in, p["w_i"]).float()
                      + p["b_i"].float())
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    # sqrt(1−a²) with a clamp for numerical safety at a → 1
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * (i * u.float())


def _linear_scan(a, b, h0):
    """h_t = a_t h_{t−1} + b_t over axis 1 from h_{−1} = h0: the initial
    state folds into b_0, then each round d composes every pair with the
    one 2^d steps before it, (a, b)_t ← (a_{t−d} a_t, a_t b_{t−d} + b_t)."""
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    for r in range(math.ceil(math.log2(S)) if S > 1 else 0):
        d = 1 << r
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
    return b


def _branches(p, x, state, coeffs=None, x32=None):
    """The gate branch and the recurrence's (a, b).  The gate and the
    conv's output enter f32 products, and the reference casts them there
    (``gate.astype(f32)``, ``u.astype(f32)``): XLA takes the last bf16 op
    of each in f32, so they come here widened (bit-equal to JAX's block
    output on the CPU where rounding them first parts on ~10%)."""
    xn = rms_norm(x if x32 is None else x32, p["ln"], plus_one=True,
                  dtype=x.dtype)
    gate = gelu(torch.einsum("bsd,dw->bsw", xn, p["w_y"]), widen=True)
    u = torch.einsum("bsd,dw->bsw", xn, p["w_x"])
    u, conv_tail = _causal_conv1d(u, p["conv"], state["conv"], widen=True)
    a, b = (coeffs or _rglru_coeffs)(p, u)
    return gate, a, b, conv_tail


def rglru_block_forward(p, x, state=None, coeffs=None, x32=None,
                        unrounded=False):
    """x: (B, S, D) → (x + out, new_state); the residual inside.
    ``coeffs`` replaces `_rglru_coeffs` (under a mesh:
    `parallel.shard_recurrent.mesh_rglru_coeffs`).  ``x32`` and
    ``unrounded`` as in `xlstm.mlstm_forward`: the norm reads x's
    unrounded f32 value where given, and the output is the residual
    sum's unrounded f32 value where asked."""
    B = x.shape[0]
    if state is None:
        state = make_rglru_state(B, p["w_x"].shape[-1], device=x.device)
    gate, a, b, conv_tail = _branches(p, x, state, coeffs, x32)
    h = _linear_scan(a, b, state["h"].to(a.dtype))
    out = torch.einsum("bsw,wd->bsd", (h * gate).to(x.dtype),
                       p["w_out"])
    s = residual(x, out)
    return ((s if unrounded else s.to(x.dtype)),
            {"h": h[:, -1, :], "conv": conv_tail})


def rglru_block_step(p, x, state, coeffs=None, x32=None, unrounded=False):
    """One decode step.  x: (B, 1, D); exact (the conv tail is carried in
    the state).  ``x32`` and ``unrounded`` as in `rglru_block_forward`."""
    gate, a, b, conv_tail = _branches(p, x, state, coeffs, x32)
    h = a[:, 0] * state["h"] + b[:, 0]
    out = torch.einsum("bw,wd->bd", (h * gate[:, 0]).to(x.dtype),
                       p["w_out"])
    s = residual(x, out[:, None, :])
    return (s if unrounded else s.to(x.dtype)), {"h": h, "conv": conv_tail}
