"""The decoder stack over heterogeneous blocks — the port of
``repro.models.transformer`` for serving: ``init_params``, the caches,
``prefill`` and ``decode_step``.

A model is ``prefix + unit × num_units + suffix`` of blocks
(`configs.base`) of five kinds: ``attn``, ``moe`` (attention with a
semaphore-admitted mixture of experts, `models.moe`), ``rglru``
(`models.rglru`), ``mlstm`` and ``slstm`` (`models.xlstm`).  Parameters
are a plain dict in the reference's layout, the unit's leaves stacked on
a leading unit axis, so `convert.params_from_jax` carries the JAX pytree
across unchanged; ``forward_hidden`` runs the units as a plain loop (no
scan, no remat) and returns the MoE aux sums beside the hidden state.

Attention goes through the port's kernels: prefill through
`kernels.ops.flash_attention` (query and key positions are the
``0..S−1`` that `embed_inputs` builds, so the kernel takes them by
construction), decode through `kernels.ops.decode_attention` over the
ring cache.  On CPU tensors both take their plain versions.  The caches
are written in place: the ring caches by `models.cache`, a recurrent
block's state copied into its cache's tensors (the unit caches are
views into the stack).

Not ported (each raises ``NotImplementedError`` naming ROADMAP item 8):
the audio and vision frontends, and training (``train_loss``, the
chunked loss, the flash kernel's gradient).
"""

from __future__ import annotations

import torch

from ..configs.base import Block, ModelConfig
from ..device import resolve_device
from ..kernels import ops
from .cache import (
    kv_cache_append,
    kv_cache_write_prefill,
    make_kv_cache,
    make_mlstm_state,
    make_rglru_state,
    make_slstm_state,
)
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
from .moe import init_moe, moe_forward
from .rglru import init_rglru_block, rglru_block_forward, rglru_block_step
from .xlstm import init_mlstm, init_slstm, mlstm_forward, slstm_forward

KINDS = ("attn", "moe", "mlstm", "slstm", "rglru")
ZERO_AUX = {"lb_loss": 0.0, "z_loss": 0.0, "overflow_frac": 0.0}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1: item 8, "
        "the model stack)")


def _check_block(spec: Block) -> None:
    if spec.kind not in KINDS:
        raise ValueError(f"unknown block kind {spec.kind!r}")


def _check_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend is not None:
        raise _not_ported(f"the {cfg.frontend!r} frontend")


# ------------------------------------------------------------------ init ----


def init_block(generator, spec: Block, cfg: ModelConfig, dtype, device=None):
    _check_block(spec)
    d = cfg.d_model
    if spec.kind == "mlstm":
        return init_mlstm(generator, d, cfg.xlstm_heads, dtype, device)
    if spec.kind == "slstm":
        return init_slstm(generator, d, cfg.xlstm_heads, dtype, device)
    if spec.kind == "rglru":
        return {
            "temporal": init_rglru_block(generator, d, cfg.lru_width, dtype,
                                         device),
            "ln2": init_rms_norm(d, dtype, cfg.norm_plus_one, device),
            "mlp": MLP_INIT[cfg.mlp_kind](generator, d, cfg.d_ff, dtype,
                                          device),
        }
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
    if spec.kind == "attn":
        p["mlp"] = MLP_INIT[cfg.mlp_kind](generator, d, cfg.d_ff, dtype,
                                          device)
    else:
        p["moe"] = init_moe(generator, d, cfg.n_experts, cfg.d_expert,
                            cfg.top_k, cfg.n_shared, cfg.d_shared, dtype,
                            n_experts_pad=cfg.n_experts_pad, device=device)
    return p


def _stack(make, n: int):
    """The trees ``make(0) … make(n−1)`` (equal-shaped dicts), made in
    order, their leaves stacked on a new leading axis: each tree is
    copied into the stack and dropped before the next is made, so the
    peak is the stack plus one tree (not two stacks' worth)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    def put(dst, src, u):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], u)
        else:
            dst[u].copy_(src)

    first = make(0)
    out = alloc(first)
    put(out, first, 0)
    del first
    for u in range(1, n):
        put(out, make(u), u)
    return out


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
        params["units"] = _stack(lambda _: {
            f"b{i}": init_block(generator, spec, cfg, dtype, device)
            for i, spec in enumerate(cfg.unit)}, cfg.num_units)
    for name, blocks in (("prefix", cfg.prefix), ("suffix", cfg.suffix)):
        if blocks:
            params[name] = [init_block(generator, spec, cfg, dtype, device)
                            for spec in blocks]
    return params


# ---------------------------------------------------------------- caches ----


def init_block_cache(spec: Block, cfg: ModelConfig, batch: int,
                     capacity: int, dtype, device=None):
    """A ring KV cache for ``attn`` and ``moe`` blocks, the zero recurrent
    state for the others (the reference's shapes and dtypes)."""
    _check_block(spec)
    if spec.kind == "mlstm":
        d_in = 2 * cfg.d_model
        hd = d_in // cfg.xlstm_heads
        return make_mlstm_state(batch, cfg.xlstm_heads, hd, hd, d_in,
                                device=device)
    if spec.kind == "slstm":
        return make_slstm_state(batch, cfg.xlstm_heads,
                                cfg.d_model // cfg.xlstm_heads, device=device)
    if spec.kind == "rglru":
        return make_rglru_state(batch, cfg.lru_width, device=device)
    cap = min(capacity, spec.window) if spec.window > 0 else capacity
    return make_kv_cache(batch, cap, cfg.n_kv_heads, cfg.hd, dtype, device)


def init_caches(cfg: ModelConfig, batch: int, capacity: int, dtype,
                device=None) -> dict:
    """Empty ring caches for every block; ``device=None`` means the card
    (raises without CUDA)."""
    device = resolve_device(device, "init_caches")
    caches = {}
    if cfg.num_units > 0:
        caches["units"] = _stack(lambda _: {
            f"b{i}": init_block_cache(spec, cfg, batch, capacity, dtype,
                                      device)
            for i, spec in enumerate(cfg.unit)}, cfg.num_units)
    for name, blocks in (("prefix", cfg.prefix), ("suffix", cfg.suffix)):
        if blocks:
            caches[name] = [init_block_cache(s, cfg, batch, capacity, dtype,
                                             device) for s in blocks]
    return caches


# --------------------------------------------------------------- forward ----


def _write_state(cache, new):
    """Copy a recurrent block's new state into its cache's tensors (views
    into the stacked unit state), so the caller's caches advance in
    place as the ring caches do."""
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def _attention(spec: Block, cfg: ModelConfig, p, x, positions, cache,
               mode: str):
    """The attention half of an ``attn`` or ``moe`` block: x plus the
    (sandwich-normed) attention output, the cache written in place."""
    theta = spec.rope_theta or cfg.rope_theta
    xn = rms_norm(x, p["ln1"], plus_one=cfg.norm_plus_one)
    q, k, v = qkv_project(p["attn"], xn, positions, theta)
    if mode == "prefill":
        ctx = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=spec.window)
        kv_cache_write_prefill(cache, k, v, positions)
    else:
        kv_cache_append(cache, k, v, positions)
        ctx = ops.decode_attention(q[:, 0].contiguous(), cache["k"],
                                   cache["v"], cache["pos"],
                                   positions[:, 0].to(torch.int32),
                                   window=spec.window)[:, None]
    attn_out = attn_output(p["attn"], ctx)
    if cfg.sandwich_norms:
        attn_out = rms_norm(attn_out, p["ln1b"], plus_one=cfg.norm_plus_one)
    return x + attn_out


def block_forward(spec: Block, cfg: ModelConfig, p, x, positions, cache,
                  mode: str):
    """One block (residuals inside).  ``mode`` is ``"prefill"`` (the
    whole sequence: attention through the flash kernel, the cache
    overwritten with its K/V; a recurrent block scanned from the state in
    its cache) or ``"decode"`` (one token per row: appended to the ring
    cache, attention through the decode kernel; a recurrent block's single
    step).  The cache is written in place.  Returns ``(x', cache, aux)``,
    ``aux`` the MoE block's (zeros for the others)."""
    _check_block(spec)
    if mode not in ("prefill", "decode"):
        raise _not_ported(f"the {mode!r} mode (training)")
    aux = dict(ZERO_AUX)
    if spec.kind == "mlstm":
        x, st = mlstm_forward(p, x, cfg.xlstm_heads, cache)
        return x, _write_state(cache, st), aux
    if spec.kind == "slstm":
        x, st = slstm_forward(p, x, cfg.xlstm_heads, cache)
        return x, _write_state(cache, st), aux
    if spec.kind == "rglru":
        fwd = rglru_block_step if mode == "decode" else rglru_block_forward
        x, st = fwd(p["temporal"], x, cache)
        xn = rms_norm(x, p["ln2"], plus_one=cfg.norm_plus_one)
        return (x + MLP_FWD[cfg.mlp_kind](p["mlp"], xn),
                _write_state(cache, st), aux)
    x = _attention(spec, cfg, p, x, positions, cache, mode)
    xn2 = rms_norm(x, p["ln2"], plus_one=cfg.norm_plus_one)
    if spec.kind == "attn":
        ff = MLP_FWD[cfg.mlp_kind](p["mlp"], xn2)
    else:
        ff, aux = moe_forward(p["moe"], xn2, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor)
    if cfg.sandwich_norms:
        ff = rms_norm(ff, p["ln2b"], plus_one=cfg.norm_plus_one)
    return x + ff, cache, aux


def _index(tree, u: int):
    """Unit ``u`` of a stacked tree: views, so cache writes land in the
    stack."""
    if isinstance(tree, dict):
        return {k: _index(v, u) for k, v in tree.items()}
    return tree[u]


def forward_hidden(params, cfg: ModelConfig, x, positions, caches, mode):
    """x: (B, S, D) input embeddings → (h, caches, aux): prefix blocks,
    the units in order, suffix blocks, the final norm; ``aux`` sums the
    MoE blocks' ``lb_loss``, ``z_loss`` and ``overflow_frac`` (0-dim
    tensors where a MoE block ran, else 0.0)."""
    aux_total = dict(ZERO_AUX)

    def run(spec, p, c):
        nonlocal x
        x, _, aux = block_forward(spec, cfg, p, x, positions, c, mode)
        for k in aux_total:
            aux_total[k] = aux_total[k] + aux[k]

    for i, spec in enumerate(cfg.prefix):
        run(spec, params["prefix"][i], caches["prefix"][i])
    for u in range(cfg.num_units):
        up = _index(params["units"], u)
        uc = _index(caches["units"], u)
        for i, spec in enumerate(cfg.unit):
            run(spec, up[f"b{i}"], uc[f"b{i}"])
    for i, spec in enumerate(cfg.suffix):
        run(spec, params["suffix"][i], caches["suffix"][i])
    h = rms_norm(x, params["final_ln"], plus_one=cfg.norm_plus_one)
    return h, caches, aux_total


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
    h, caches, _ = forward_hidden(params, cfg, x, positions, caches,
                                  "prefill")
    logits = h[:, -1, :] @ lm_head(params, cfg).to(h.dtype)
    return logits.float(), caches


def decode_step(params, cfg: ModelConfig, tokens, positions, caches):
    """tokens (B, 1) int, positions (B, 1) int32 → (logits (B, V) f32,
    caches), the caches appended in place."""
    _check_frontend(cfg)
    x = params["embed"][tokens.to(torch.int64)]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    h, caches, _ = forward_hidden(params, cfg, x, positions.to(torch.int32),
                                  caches, "decode")
    logits = h[:, -1, :] @ lm_head(params, cfg).to(h.dtype)
    return logits.float(), caches
