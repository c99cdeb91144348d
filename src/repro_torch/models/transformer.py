"""The decoder stack over attention blocks — the port of
``repro.models.transformer`` for serving: ``init_params``, the caches,
``prefill`` and ``decode_step``.

A model is ``prefix + unit × num_units + suffix`` of blocks
(`configs.base`).  Parameters are a plain dict in the reference's
layout, the unit's leaves stacked on a leading unit axis, so
`convert.params_from_jax` carries the JAX pytree across unchanged;
``forward_hidden`` runs the units as a plain loop (no scan, no remat).

Attention goes through the port's kernels: prefill through
`kernels.ops.flash_attention` (query and key positions are the
``0..S−1`` that `embed_inputs` builds, so the kernel takes them by
construction), decode through `kernels.ops.decode_attention` over the
ring cache.  On CPU tensors both take their plain versions.  The caches
are written in place (`models.cache`).

Not ported (each raises ``NotImplementedError`` naming ROADMAP item 8):
the ``moe``, ``mlstm``, ``slstm`` and ``rglru`` block kinds, the audio
and vision frontends, and training (``train_loss``, the chunked loss,
the flash kernel's gradient).
"""

from __future__ import annotations

import torch

from ..configs.base import Block, ModelConfig
from ..device import resolve_device
from ..kernels import ops
from .cache import kv_cache_append, kv_cache_write_prefill, make_kv_cache
from .layers import (
    MLP_FWD,
    MLP_INIT,
    attn_output,
    init_attention,
    init_embedding,
    init_rms_norm,
    qkv_project,
    rms_norm,
)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1: item 8, "
        "the model stack)")


def _check_block(spec: Block) -> None:
    if spec.kind != "attn":
        raise _not_ported(f"the {spec.kind!r} block kind")


def _check_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend is not None:
        raise _not_ported(f"the {cfg.frontend!r} frontend")


# ------------------------------------------------------------------ init ----


def init_block(generator, spec: Block, cfg: ModelConfig, dtype, device=None):
    _check_block(spec)
    d = cfg.d_model
    p = {
        "ln1": init_rms_norm(d, dtype, cfg.norm_plus_one, device),
        "attn": init_attention(
            generator, dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                            head_dim=cfg.hd, qkv_bias=cfg.qkv_bias),
            d, dtype, device),
        "ln2": init_rms_norm(d, dtype, cfg.norm_plus_one, device),
    }
    if cfg.sandwich_norms:
        p["ln1b"] = init_rms_norm(d, dtype, cfg.norm_plus_one, device)
        p["ln2b"] = init_rms_norm(d, dtype, cfg.norm_plus_one, device)
    p["mlp"] = MLP_INIT[cfg.mlp_kind](generator, d, cfg.d_ff, dtype, device)
    return p


def _stack(trees: list):
    """Leaves of equal-shaped dicts stacked on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32, device=None) -> dict:
    """Random parameters with the reference's initial scales, drawn from
    ``generator`` on ``device`` (its numbers are not JAX's: a test that
    compares the two carries JAX's parameters across instead).
    ``device=None`` means the card (raises without CUDA); ``generator``
    must live on the same device — a CPU generator for a CUDA build is
    the caller's error."""
    device = resolve_device(device, "init_params")
    _check_frontend(cfg)
    params = {
        "embed": init_embedding(generator, cfg.vocab, cfg.d_model, dtype,
                                device),
        "final_ln": init_rms_norm(cfg.d_model, dtype, cfg.norm_plus_one,
                                  device),
    }
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((cfg.d_model, cfg.vocab),
                                      generator=generator, device=device)
                          * cfg.d_model ** -0.5).to(dtype)
    if cfg.num_units > 0:
        params["units"] = _stack([
            {f"b{i}": init_block(generator, spec, cfg, dtype, device)
             for i, spec in enumerate(cfg.unit)}
            for _ in range(cfg.num_units)])
    for name, blocks in (("prefix", cfg.prefix), ("suffix", cfg.suffix)):
        if blocks:
            params[name] = [init_block(generator, spec, cfg, dtype, device)
                            for spec in blocks]
    return params


# ---------------------------------------------------------------- caches ----


def init_block_cache(spec: Block, cfg: ModelConfig, batch: int,
                     capacity: int, dtype, device=None):
    _check_block(spec)
    cap = min(capacity, spec.window) if spec.window > 0 else capacity
    return make_kv_cache(batch, cap, cfg.n_kv_heads, cfg.hd, dtype, device)


def init_caches(cfg: ModelConfig, batch: int, capacity: int, dtype,
                device=None) -> dict:
    """Empty ring caches for every block; ``device=None`` means the card
    (raises without CUDA)."""
    device = resolve_device(device, "init_caches")
    caches = {}
    if cfg.num_units > 0:
        caches["units"] = _stack([
            {f"b{i}": init_block_cache(spec, cfg, batch, capacity, dtype,
                                       device)
             for i, spec in enumerate(cfg.unit)}
            for _ in range(cfg.num_units)])
    for name, blocks in (("prefix", cfg.prefix), ("suffix", cfg.suffix)):
        if blocks:
            caches[name] = [init_block_cache(s, cfg, batch, capacity, dtype,
                                             device) for s in blocks]
    return caches


# --------------------------------------------------------------- forward ----


def block_forward(spec: Block, cfg: ModelConfig, p, x, positions, cache,
                  mode: str):
    """One attention block (residuals inside).  ``mode`` is ``"prefill"``
    (attention over the whole sequence through the flash kernel, the
    cache overwritten with its K/V) or ``"decode"`` (one token per row
    appended to the ring cache, attention through the decode kernel).
    Returns ``(x', cache)``."""
    _check_block(spec)
    theta = spec.rope_theta or cfg.rope_theta
    xn = rms_norm(x, p["ln1"], plus_one=cfg.norm_plus_one)
    q, k, v = qkv_project(p["attn"], xn, positions, theta)
    if mode == "prefill":
        ctx = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=spec.window)
        cache = kv_cache_write_prefill(cache, k, v, positions)
    elif mode == "decode":
        cache = kv_cache_append(cache, k, v, positions)
        ctx = ops.decode_attention(q[:, 0].contiguous(), cache["k"],
                                   cache["v"], cache["pos"],
                                   positions[:, 0].to(torch.int32),
                                   window=spec.window)[:, None]
    else:
        raise _not_ported(f"the {mode!r} mode (training)")
    attn_out = attn_output(p["attn"], ctx)
    if cfg.sandwich_norms:
        attn_out = rms_norm(attn_out, p["ln1b"], plus_one=cfg.norm_plus_one)
    x = x + attn_out
    xn2 = rms_norm(x, p["ln2"], plus_one=cfg.norm_plus_one)
    ff = MLP_FWD[cfg.mlp_kind](p["mlp"], xn2)
    if cfg.sandwich_norms:
        ff = rms_norm(ff, p["ln2b"], plus_one=cfg.norm_plus_one)
    return x + ff, cache


def _index(tree, u: int):
    """Unit ``u`` of a stacked tree: views, so cache writes land in the
    stack."""
    if isinstance(tree, dict):
        return {k: _index(v, u) for k, v in tree.items()}
    return tree[u]


def forward_hidden(params, cfg: ModelConfig, x, positions, caches, mode):
    """x: (B, S, D) input embeddings → (h, caches): prefix blocks, the
    units in order, suffix blocks, the final norm."""
    for i, spec in enumerate(cfg.prefix):
        x, _ = block_forward(spec, cfg, params["prefix"][i], x, positions,
                             caches["prefix"][i], mode)
    for u in range(cfg.num_units):
        up = _index(params["units"], u)
        uc = _index(caches["units"], u)
        for i, spec in enumerate(cfg.unit):
            x, _ = block_forward(spec, cfg, up[f"b{i}"], x, positions,
                                 uc[f"b{i}"], mode)
    for i, spec in enumerate(cfg.suffix):
        x, _ = block_forward(spec, cfg, params["suffix"][i], x, positions,
                             caches["suffix"][i], mode)
    return rms_norm(x, params["final_ln"], plus_one=cfg.norm_plus_one), caches


# ------------------------------------------------------------ embeddings ----


def embed_inputs(params, cfg: ModelConfig, batch):
    """Token embeddings and positions ``0..S−1`` per row (text frontend;
    the reference's loss mask waits for training)."""
    _check_frontend(cfg)
    x = params["embed"][batch["tokens"]]
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x, positions


def lm_head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


# ---------------------------------------------------------------- serving ---


def prefill(params, cfg: ModelConfig, batch, caches):
    """Full-context forward that fills the caches (in place); returns
    (last-position logits (B, V) f32, caches)."""
    x, positions = embed_inputs(params, cfg, batch)
    h, caches = forward_hidden(params, cfg, x, positions, caches, "prefill")
    logits = h[:, -1, :] @ lm_head(params, cfg).to(h.dtype)
    return logits.float(), caches


def decode_step(params, cfg: ModelConfig, tokens, positions, caches):
    """tokens (B, 1) int, positions (B, 1) int32 → (logits (B, V) f32,
    caches), the caches appended in place."""
    _check_frontend(cfg)
    x = params["embed"][tokens.to(torch.int64)]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    h, caches = forward_hidden(params, cfg, x, positions.to(torch.int32),
                               caches, "decode")
    logits = h[:, -1, :] @ lm_head(params, cfg).to(h.dtype)
    return logits.float(), caches
