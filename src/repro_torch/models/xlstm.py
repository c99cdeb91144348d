"""xLSTM blocks (arXiv:2405.04517) — the port of ``repro.models.xlstm``:
mLSTM (matrix memory) and sLSTM (scalar memory, exponential gating with a
stabiliser).

Each cell is a single-step transition; prefill runs it in a Python loop
over time (the reference's ``lax.scan``), decode runs it once with the
carried state.  The stabiliser arithmetic is the reference's line for
line.  The JAX package runs no Pallas kernel here, so neither does the
port: these blocks are plain PyTorch on every device.  Under a mesh the
time loops run on each rank's batch rows as local tensors
(`parallel.shard_recurrent.on_local_rows`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cache import make_mlstm_state, make_slstm_state
from .layers import _normal, residual, rms_norm, scale, silu


def _causal_conv1d(x, w, tail=None, widen: bool = False):
    """Depthwise causal conv.  x: (B, S, D), w: (K, D); ``tail`` carries
    the last K−1 inputs of earlier steps (zeros at the sequence start).
    Returns (out, new_tail): one-token decode with the tail equals the
    full-sequence result.  ``widen`` returns ``out`` in f32 with its last
    sum taken in f32: the reference's ``out.astype(float32)`` as XLA
    compiles it, which computes the last bf16 op before a cast to f32 in
    f32 and leaves it unrounded (``out.to(x.dtype)`` is the bf16 value)."""
    K = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(K - 1):
        out = out + xp[:, i:i + S, :] * w[i]
    last = xp[:, K - 1:K - 1 + S, :] * w[K - 1]
    out = out.float() + last.float() if widen else out + last
    return out, xp[:, xp.shape[1] - (K - 1):, :]


# ------------------------------------------------------------------ mLSTM ---


def init_mlstm(generator, d_model, n_heads, dtype, device=None):
    """mLSTM block: pre-LN → up-proj (pf=2) → (conv branch → q, k; v) →
    mLSTM cell → gated skip → down-proj."""
    d_in = 2 * d_model
    hd = d_in // n_heads
    std, stdi = d_model ** -0.5, d_in ** -0.5

    def n(shape, s):
        return _normal(generator, shape, s, dtype, device)

    return {
        "ln": torch.ones((d_model,), dtype=dtype, device=device),
        "w_up": n((d_model, d_in), std),
        "w_gate": n((d_model, d_in), std),
        "conv": n((4, d_in), 0.1),
        "wq": n((d_in, n_heads, hd), stdi),
        "wk": n((d_in, n_heads, hd), stdi),
        "wv": n((d_in, n_heads, hd), stdi),
        "w_if": n((d_in, n_heads, 2), stdi),
        "b_if": torch.tensor([0.0, 3.0], dtype=dtype,
                             device=device).repeat(n_heads, 1),
        "w_down": n((d_in, d_model), stdi),
        "out_ln": torch.ones((d_in,), dtype=dtype, device=device),
    }


def _mlstm_step(state, q, k, v, i_gate, f_gate):
    """One time step.  q/k/v: (B, H, hd); i/f gates: (B, H)
    pre-activations."""
    logf = -F.softplus(-f_gate)  # log sigmoid(f)
    m_new = torch.maximum(logf + state["m"], i_gate)
    i_ = torch.exp(i_gate - m_new)
    f_ = torch.exp(logf + state["m"] - m_new)
    C = (f_[..., None, None] * state["C"]
         + i_[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n = f_[..., None] * state["n"] + i_[..., None] * k
    h_num = torch.einsum("bhk,bhkv->bhv", q, C)
    h_den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", q, n)),
                          torch.exp(-m_new))
    h = h_num / h_den[..., None]
    return {"C": C, "n": n, "m": m_new}, h


def _mlstm_scan(cell, q, k, v, i_g, f_g):
    """The time loop (the reference's ``lax.scan``): q/k/v (B, S, H, hd),
    gates (B, S, H) → (the last cell, h (B, S, H·hd)).  The inputs are
    cut into their time steps once (``unbind``, whose backward stacks
    the steps' gradients: an index a step would write a whole-sequence
    gradient each, S² bytes in all)."""
    hs = []
    for q_t, k_t, v_t, i_t, f_t in zip(*(x.unbind(1)
                                         for x in (q, k, v, i_g, f_g))):
        cell, h = _mlstm_step(cell, q_t.float(), k_t.float(), v_t.float(),
                              i_t, f_t)
        hs.append(h)
    return cell, torch.stack(hs, 1).reshape(q.shape[0], q.shape[1], -1)


def mlstm_forward(p, x, n_heads, state=None, run=None, x32=None,
                  unrounded=False):
    """x: (B, S, D).  Returns (x + out (B, S, D), new_state).  ``run``
    runs the time loop, ``run(scan, x, weights, *inputs)`` (under a mesh:
    `parallel.shard_recurrent.on_local_rows`); without it the loop runs
    here.  ``x32``, x's unrounded f32 value where the previous block's
    residual sum reaches this block's norm unrounded, is what the norm
    reads; with ``unrounded`` the output is the residual sum's
    unrounded f32 value (`layers.residual`)."""
    B = x.shape[0]
    xn = rms_norm(x if x32 is None else x32, p["ln"], dtype=x.dtype)
    up = torch.einsum("bsd,de->bse", xn, p["w_up"])
    gate = torch.einsum("bsd,de->bse", xn, p["w_gate"])
    d_in = up.shape[-1]
    if state is None:
        state = make_mlstm_state(B, n_heads, d_in // n_heads,
                                 d_in // n_heads, d_in, device=x.device)
    conv, conv_tail = _causal_conv1d(up, p["conv"], state["conv"])
    conv = silu(conv)
    q = torch.einsum("bse,ehk->bshk", conv, p["wq"])
    k = scale(torch.einsum("bse,ehk->bshk", conv, p["wk"]),
              p["wq"].shape[-1] ** -0.5)
    v = torch.einsum("bse,ehk->bshk", up, p["wv"])
    gates = (torch.einsum("bse,ehg->bshg", up, p["w_if"])
             + p["b_if"].float())
    i_g, f_g = gates[..., 0].float(), gates[..., 1].float()
    cell = {k_: state[k_] for k_ in ("C", "n", "m")}
    args = (cell, q, k, v, i_g, f_g)
    cell, h = (_mlstm_scan(*args) if run is None
               else run(_mlstm_scan, x, (), *args))
    new_state = dict(cell, conv=conv_tail)
    h = h.to(x.dtype)  # (B, S, d_in)
    h = rms_norm(h, p["out_ln"]) * silu(gate)
    s = residual(x, torch.einsum("bse,ed->bsd", h, p["w_down"]))
    return (s if unrounded else s.to(x.dtype)), new_state


# ------------------------------------------------------------------ sLSTM ---


def init_slstm(generator, d_model, n_heads, dtype, device=None):
    hd = d_model // n_heads
    std = d_model ** -0.5
    d_ff = int(d_model * 4 / 3)

    def n(shape, s):
        return _normal(generator, shape, s, dtype, device)

    return {
        "ln": torch.ones((d_model,), dtype=dtype, device=device),
        "w_zifo": n((d_model, n_heads, 4 * hd), std),
        "r_zifo": n((n_heads, hd, 4 * hd), hd ** -0.5),
        "b_zifo": torch.zeros((n_heads, 4 * hd), dtype=dtype, device=device),
        "w_out": n((d_model, d_model), std),
        "ffn_ln": torch.ones((d_model,), dtype=dtype, device=device),
        "ffn_wi": n((d_model, d_ff), std),
        "ffn_wg": n((d_model, d_ff), std),
        "ffn_wo": n((d_ff, d_model), d_ff ** -0.5),
    }


def _slstm_step(p, state, zifo_x):
    """zifo_x: (B, H, 4·hd) input pre-activations; the recurrent term is
    added here."""
    rec = torch.einsum("bhk,hkg->bhg", state["h"].to(zifo_x.dtype),
                       p["r_zifo"].to(zifo_x.dtype))
    z, i, f, o = torch.chunk(zifo_x.float() + rec.float(), 4, dim=-1)
    logf = -F.softplus(-f)
    m_new = torch.maximum(logf + state["m"], i)
    i_ = torch.exp(i - m_new)
    f_ = torch.exp(logf + state["m"] - m_new)
    c = f_ * state["c"] + i_ * torch.tanh(z)
    n = f_ * state["n"] + i_
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_scan(r_zifo, state, zifo):
    """The time loop: zifo (B, S, H, 4·hd) → (the last state, h (B, S,
    H·hd))."""
    hs = []
    for z_t in zifo.unbind(1):  # the steps cut once, as in `_mlstm_scan`
        state = _slstm_step({"r_zifo": r_zifo}, state, z_t)
        hs.append(state["h"])
    return state, torch.stack(hs, 1).reshape(zifo.shape[0], zifo.shape[1],
                                             -1)


def slstm_forward(p, x, n_heads, state=None, run=None, x32=None,
                  unrounded=False):
    """x: (B, S, D).  Returns (x + out, new_state): the cell, its output
    projection and the post FFN (pf = 4/3 SwiGLU), residuals inside; the
    FFN's norm reads the first residual sum unrounded, as XLA's does.
    ``run``, ``x32`` and ``unrounded`` as in `mlstm_forward`."""
    B, D = x.shape[0], x.shape[-1]
    xn = rms_norm(x if x32 is None else x32, p["ln"], dtype=x.dtype)
    zifo = torch.einsum("bsd,dhg->bshg", xn, p["w_zifo"]) + p["b_zifo"]
    if state is None:
        state = make_slstm_state(B, n_heads, D // n_heads, device=x.device)
    state, h = (_slstm_scan(p["r_zifo"], state, zifo) if run is None
                else run(_slstm_scan, x, (p["r_zifo"],), state, zifo))
    h = h.to(x.dtype)
    y32 = residual(x, torch.einsum("bsd,de->bse", h, p["w_out"]))
    y = y32.to(x.dtype)
    yn = rms_norm(y32, p["ffn_ln"], dtype=x.dtype)
    ff = (silu(torch.einsum("bsd,df->bsf", yn, p["ffn_wg"]))
          * torch.einsum("bsd,df->bsf", yn, p["ffn_wi"]))
    s = residual(y, torch.einsum("bsf,fd->bsd", ff, p["ffn_wo"]))
    return (s if unrounded else s.to(x.dtype)), state
