"""The decoder stack over heterogeneous blocks — the port of
``repro.models.transformer``: ``init_params``, the caches, ``prefill``,
``decode_step`` and the training objective (``chunked_ce_loss``,
``train_loss``).

A model is ``prefix + unit × num_units + suffix`` of blocks
(`configs.base`) of five kinds: ``attn``, ``moe`` (attention with a
semaphore-admitted mixture of experts, `models.moe`), ``rglru``
(`models.rglru`), ``mlstm`` and ``slstm`` (`models.xlstm`).  Parameters
are a plain dict in the reference's layout, the unit's leaves stacked on
a leading unit axis, so `convert.params_from_jax` carries the JAX pytree
across unchanged; ``forward_hidden`` runs the units as a plain loop over
views of the stack (one ``unbind`` a leaf, so the gradients of all units
land in the stacked leaf in one ``stack``) and returns the MoE aux sums
beside the hidden state.

Modes:
  train    — the full sequence, no caches; attention through the plain
             `kernels.ref.blockwise_attention` under autograd (the
             reference trains through plain ``blockwise_attention`` too;
             the flash kernel has no backward; each KV block
             checkpointed, as there; under a mesh on each rank's local
             shard, `parallel.shard_attention.mesh_train_attention`),
             each unit's activations kept or recomputed as ``remat``
             says;
  prefill  — the full sequence through `kernels.ops.flash_attention`
             (query and key positions are the ``0..S−1`` that
             `embed_inputs` builds, so the kernel takes them by
             construction), the caches overwritten;
  decode   — one token per row through `kernels.ops.decode_attention`
             over the ring cache.
On CPU tensors the kernels take their plain versions.  Under a mesh
(DTensor parameters and caches, `parallel.steps`' serve steps) prefill
and decode run the same kernels on each rank's shard
(`parallel.shard_attention`): prefill on the rank's (batch, heads)
shard, decode on its rows of a sequence-sharded cache with the
log-sum-exp merge across the shards; a split cache
(`models.cache.split_cache`) takes the same decode arithmetic on one
device.  The recurrent blocks take their gate products and time loops on
each rank's local shard in every mode (`parallel.shard_recurrent`).  The
caches are written in place: the ring caches by
`models.cache`, a recurrent block's state copied into its cache's
tensors (the unit caches are views into the stack).  Training writes
nothing in place that autograd saved.

Frontend stubs, as in the reference: ``"audio"`` consumes precomputed
frame embeddings (B, S, D); ``"vision"`` prepends precomputed patch
embeddings (B, P, D) to the token embeddings and masks them out of the
loss.
"""

from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import Block, ModelConfig
from ..device import resolve_device
from ..kernels import ops
from ..parallel.shard_attention import (mesh_decode_attention,
                                        mesh_prefill_attention,
                                        mesh_train_attention,
                                        sharded_decode_attention)
from ..parallel.shard_recurrent import mesh_rglru_coeffs, on_local_rows
from ..parallel.sharding import (constrain, embed_lookup, is_dtensor,
                                  vocab_lse_and_pick)
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
    blockwise_attention,
    init_attention,
    init_embedding,
    init_rms_norm,
    qkv_project,
    residual,
    rms_norm,
)
from .moe import init_moe, moe_forward
from .rglru import init_rglru_block, rglru_block_forward, rglru_block_step
from .xlstm import init_mlstm, init_slstm, mlstm_forward, slstm_forward

KINDS = ("attn", "moe", "mlstm", "slstm", "rglru")
ZERO_AUX = {"lb_loss": 0.0, "z_loss": 0.0, "overflow_frac": 0.0}


MODES = ("train", "prefill", "decode")
REMAT = ("none", "full", "dots", "2level")


def _check_block(spec: Block) -> None:
    if spec.kind not in KINDS:
        raise ValueError(f"unknown block kind {spec.kind!r}")


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


def _settled(x):
    """The residual stream constrained to (batch, seq, embed): under a
    mesh it enters each block, and the final norm, replicated over
    ``model`` — the row-parallel products' partial sums (the embedding
    lookup's, the o- and down-projections') are summed there, as tensor
    parallelism sums them, so no partial sum meets a sharded bias (a
    redistribution from a shard to a partial sum, which DTensor lacks);
    the identity without a mesh."""
    return constrain(x, "batch", "seq", "embed")


def _write_state(cache, new):
    """Copy a recurrent block's new state into its cache's tensors (views
    into the stacked unit state), so the caller's caches advance in
    place as the ring caches do; without a cache (training) the new
    state is returned as it is."""
    if cache is None:
        return new
    for k, v in new.items():
        if is_dtensor(cache[k]):
            v = v.redistribute(cache[k].device_mesh, cache[k].placements)
        cache[k].copy_(v)
    return cache


def _conv_to(caches, dtype):
    """Every causal-conv tail (``conv``, the mLSTM's and the RG-LRU's)
    in ``caches`` retyped to ``dtype``, the activations' dtype: the
    reference's block returns the tail in x's dtype
    (``_causal_conv1d``), so its state tree after a bf16 step holds a
    bf16 ``conv`` beside the f32 cells, whatever ``init_caches`` made.
    The leaf is replaced in the caller's dict once (a no-op after), and
    later steps write into it in place."""
    if isinstance(caches, list):
        for c in caches:
            _conv_to(c, dtype)
    elif isinstance(caches, dict):
        for k, v in caches.items():
            if isinstance(v, (dict, list)):
                _conv_to(v, dtype)
            elif k == "conv" and v.dtype != dtype:
                caches[k] = v.to(dtype)


def _attention(spec: Block, cfg: ModelConfig, p, x, positions, cache,
               mode: str, kv_block: int = 1024, x32=None):
    """The attention half of an ``attn`` or ``moe`` block: x plus the
    (sandwich-normed) attention output as (the stream, rounded to x's
    dtype; the sum's unrounded f32 value, `layers.residual`), settled
    before the rounding (under a mesh the partial sums are summed
    first); the cache written in place; ``ln1`` reads ``x32`` where
    given."""
    theta = spec.rope_theta or cfg.rope_theta
    xn = rms_norm(x if x32 is None else x32, p["ln1"],
                  plus_one=cfg.norm_plus_one, dtype=x.dtype)
    q, k, v = qkv_project(p["attn"], xn, positions, theta)
    q = constrain(q, "batch", "seq", "heads")
    if mode == "train" and is_dtensor(q):  # plain attention on local shards
        ctx = mesh_train_attention(q, k, v, positions, window=spec.window,
                                   kv_block=kv_block)
    elif mode == "train":
        ctx = blockwise_attention(q, k, v, positions, positions,
                                  window=spec.window, kv_block=kv_block)
    elif is_dtensor(q):  # under a mesh: the kernels on each rank's shard
        if mode == "prefill":
            ctx = mesh_prefill_attention(q, k, v, window=spec.window)
            kv_cache_write_prefill(cache, k, v, positions)
        else:
            kv_cache_append(cache, k, v, positions)
            ctx = mesh_decode_attention(q, cache, positions,
                                        window=spec.window)
    elif mode == "prefill":
        ctx = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), window=spec.window)
        kv_cache_write_prefill(cache, k, v, positions)
    else:
        kv_cache_append(cache, k, v, positions)
        attend = (sharded_decode_attention if cache["k"].dim() == 5
                  else ops.decode_attention)  # a split cache: M runs
        ctx = attend(q[:, 0].contiguous(), cache["k"], cache["v"],
                     cache["pos"], positions[:, 0].to(torch.int32),
                     window=spec.window)[:, None]
    attn_out = attn_output(p["attn"], ctx)
    if cfg.sandwich_norms:
        attn_out = rms_norm(attn_out, p["ln1b"], plus_one=cfg.norm_plus_one)
    s = _settled(residual(x, attn_out))
    return s.to(x.dtype), s


def block_forward(spec: Block, cfg: ModelConfig, p, x, positions, cache,
                  mode: str, kv_block: int = 1024):
    """One block (residuals inside).  ``mode`` is ``"train"`` (the whole
    sequence, no cache: plain blockwise attention over ``kv_block``-key
    blocks under autograd, each block checkpointed, a recurrent block scanned from the zero
    state), ``"prefill"`` (the whole sequence: attention through the flash
    kernel, the cache overwritten with its K/V; a recurrent block scanned
    from the state in its cache) or ``"decode"`` (one token per row:
    appended to the ring cache, attention through the decode kernel; a
    recurrent block's single step).  Under a mesh (a DTensor ``x``) a
    recurrent block runs on local shards (`parallel.shard_recurrent`).
    The cache is written in place.  Returns ``(x', cache, aux)``, ``aux``
    the MoE block's (zeros for the others)."""
    x, _, cache, aux = _block(spec, cfg, p, x, None, positions, cache, mode,
                              kv_block)
    return x, cache, aux


def _block(spec: Block, cfg: ModelConfig, p, x, x32, positions, cache,
           mode: str, kv_block: int = 1024):
    """`block_forward` with the unrounded residual sums XLA keeps: a norm
    reads the residual sum before it in f32, unrounded, where the two lie
    in one straight-line region of the reference's program — within a
    block and from one block to the next inside a unit or in the prefix
    or suffix — and the rounded stream where a loop boundary (the
    reference's scan over units) lies between them.  ``x32`` is x's
    unrounded f32 value (None: x as it is); returns ``(x', x32', cache,
    aux)``, ``x32'`` the block's last residual sum unrounded."""
    _check_block(spec)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    aux = dict(ZERO_AUX)
    x = _settled(x)
    if x32 is not None:  # settled as the stream is
        x32 = _settled(x32)
    meshed = is_dtensor(x)  # the products and time loops on local shards
    if spec.kind in ("mlstm", "slstm"):
        fwd = mlstm_forward if spec.kind == "mlstm" else slstm_forward
        s, st = fwd(p, x, cfg.xlstm_heads, cache,
                    run=on_local_rows if meshed else None, x32=x32,
                    unrounded=True)
        return s.to(x.dtype), s, _write_state(cache, st), aux
    if spec.kind == "rglru":
        fwd = rglru_block_step if mode == "decode" else rglru_block_forward
        s, st = fwd(p["temporal"], x, cache,
                    coeffs=mesh_rglru_coeffs if meshed else None, x32=x32,
                    unrounded=True)
        x = s.to(x.dtype)
        xn = rms_norm(s, p["ln2"], plus_one=cfg.norm_plus_one, dtype=x.dtype)
        s = residual(x, MLP_FWD[cfg.mlp_kind](p["mlp"], xn))
        return s.to(x.dtype), s, _write_state(cache, st), aux
    x, s = _attention(spec, cfg, p, x, positions, cache, mode, kv_block,
                      x32=x32)
    xn2 = rms_norm(s, p["ln2"], plus_one=cfg.norm_plus_one, dtype=x.dtype)
    if spec.kind == "attn":
        ff = MLP_FWD[cfg.mlp_kind](p["mlp"], xn2)
    else:
        ff, aux = moe_forward(p["moe"], xn2, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor)
    if cfg.sandwich_norms:
        ff = rms_norm(ff, p["ln2b"], plus_one=cfg.norm_plus_one)
    s = residual(x, ff)  # settled at the next block's entry
    return s.to(x.dtype), s, cache, aux


def _index(tree, u: int):
    """Unit ``u`` of a stacked tree: views, so cache writes land in the
    stack."""
    if isinstance(tree, dict):
        return {k: _index(v, u) for k, v in tree.items()}
    return tree[u]


def _unstack(tree, n: int) -> list:
    """The ``n`` units of a stacked parameter tree as trees of views: one
    ``unbind`` a leaf, whose backward stacks every unit's gradient into
    the stacked leaf in one op (``n`` selects would each build a
    stack-sized gradient)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][u] for k in tree} for u in range(n)]
    return list(torch.unbind(tree, 0))


def _add_aux(a, b):
    return {k: a[k] + b[k] for k in a}


def _apply_unit(cfg, unit_params, x, positions, unit_cache, mode,
                kv_block=1024):
    """One unit's blocks in order: the reference's scan body, so each
    block's norm reads the previous block's residual sum unrounded and
    the unit's first reads the rounded carry (`_block`)."""
    aux_sum = dict(ZERO_AUX)
    x32 = None
    for i, spec in enumerate(cfg.unit):
        cache_i = None if unit_cache is None else unit_cache[f"b{i}"]
        x, x32, _, aux = _block(spec, cfg, unit_params[f"b{i}"], x, x32,
                                positions, cache_i, mode, kv_block)
        aux_sum = _add_aux(aux_sum, aux)
    return x, aux_sum


# the "dots" policy keeps the outputs of the matrix products (the
# reference's dots_with_no_batch_dims_saveable) and recomputes the rest
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """``fn`` with its activations recomputed in backward: ``"full"``
    keeps only its inputs, ``"dots"`` also its matrix products."""
    if policy == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return partial(checkpoint, fn, use_reentrant=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _save_dots))
    return fn


def _group_size(u: int) -> int:
    """Largest divisor of u that is ≤ ceil(sqrt(u)) (√L checkpointing)."""
    target = math.isqrt(u) + (0 if math.isqrt(u) ** 2 == u else 1)
    for g in range(target, 0, -1):
        if u % g == 0:
            return g
    return 1


def forward_hidden(params, cfg: ModelConfig, x, positions, caches=None,
                   mode: str = "train", remat: str = "dots",
                   kv_block: int = 1024):
    """x: (B, S, D) input embeddings → (h, caches, aux): prefix blocks,
    the units in order, suffix blocks, the final norm; ``aux`` sums the
    MoE blocks' ``lb_loss``, ``z_loss`` and ``overflow_frac`` (0-dim
    tensors where a MoE block ran, else 0.0).

    In ``"train"`` mode (no caches) ``remat`` says what each unit keeps
    for backward, as the reference's checkpoint policies do: ``"none"``
    everything, ``"full"`` its input (the unit recomputed), ``"dots"`` its
    input and its matrix products, ``"2level"`` one input per group of
    `_group_size` units, each group recomputed unit by unit.  Every
    policy gives the same loss and gradients."""
    if remat not in REMAT:
        raise ValueError(f"unknown remat policy {remat!r}")
    if caches is not None:
        _conv_to(caches, x.dtype)
    aux_total = dict(ZERO_AUX)
    x32 = None  # the last residual sum unrounded, up to a loop boundary

    def edge(name, i, spec):
        nonlocal x, x32, aux_total
        c = None if caches is None else caches[name][i]
        x, x32, _, aux = _block(spec, cfg, params[name][i], x, x32,
                                positions, c, mode, kv_block)
        aux_total = _add_aux(aux_total, aux)

    def unit_fn(xc, up):
        return _apply_unit(cfg, up, xc, positions, None, mode, kv_block)

    for i, spec in enumerate(cfg.prefix):
        edge("prefix", i, spec)
    U = cfg.num_units
    if U > 0:
        x32 = None  # the scan's carry is the rounded stream
        ups = _unstack(params["units"], U)
        if caches is not None:
            for u in range(U):
                x, aux = _apply_unit(cfg, ups[u], x, positions,
                                     _index(caches["units"], u), mode,
                                     kv_block)
                aux_total = _add_aux(aux_total, aux)
        elif remat == "2level" and mode == "train":
            inner = _remat(unit_fn, "full")

            def group_fn(xc, *gps):
                aux_g = dict(ZERO_AUX)
                for up in gps:
                    xc, aux = inner(xc, up)
                    aux_g = _add_aux(aux_g, aux)
                return xc, aux_g

            g = _group_size(U)
            for j in range(0, U, g):
                x, aux = _remat(group_fn, "full")(x, *ups[j:j + g])
                aux_total = _add_aux(aux_total, aux)
        else:
            fn = _remat(unit_fn, remat if mode == "train" else "none")
            for up in ups:
                x, aux = fn(x, up)
                aux_total = _add_aux(aux_total, aux)
    for i, spec in enumerate(cfg.suffix):
        edge("suffix", i, spec)
    h = rms_norm(_settled(x) if x32 is None else x32, params["final_ln"],
                 plus_one=cfg.norm_plus_one, dtype=x.dtype)
    return h, caches, aux_total


# ------------------------------------------------------------ embeddings ----


def embed_inputs(params, cfg: ModelConfig, batch):
    """Input embeddings, positions ``0..S−1`` per row and the loss mask
    (B, S) f32 from a batch dict of tensors: ``frame_embeds`` for the
    audio frontend; ``patch_embeds`` (B, P, D) before the token
    embeddings for the vision one, its P positions masked out; tokens
    otherwise.  A ``loss_mask`` in the batch multiplies the mask."""
    if cfg.frontend == "audio":
        x = batch["frame_embeds"]
    else:
        x = embed_lookup(params["embed"], batch["tokens"])
        if cfg.frontend == "vision":
            x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    if cfg.frontend == "vision":
        mask[:, :batch["patch_embeds"].shape[1]] = 0.0
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x, positions, mask


def lm_head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


# ----------------------------------------------------------------- loss ----


def _ce_chunk(head, hs, lab, msk):
    logits = torch.einsum("bsd,dv->bsv", hs, head.to(hs.dtype)).float()
    logits = constrain(logits, "batch", "seq", "vocab")
    if is_dtensor(logits):
        lse, ll = vocab_lse_and_pick(logits, lab)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab[..., None].long())[..., 0]
    return torch.sum((lse - ll) * msk), torch.sum(lse * lse * msk)


def chunked_ce_loss(h, head, labels, mask, chunk: int = 512,
                    z_weight: float = 0.0):
    """Cross-entropy without the (B, S, V) logits at once: f32 statistics
    over sequence chunks, each chunk checkpointed so that backward
    recomputes its logits from ``h``.  Returns (loss + z_weight · mean
    lse², token count)."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    loss_sum = z_sum = cnt = torch.zeros((), dtype=torch.float32,
                                         device=h.device)
    for i in range(0, S, chunk):
        msk = mask[:, i:i + chunk]
        lo, z = checkpoint(_ce_chunk, head, h[:, i:i + chunk],
                           labels[:, i:i + chunk], msk, use_reentrant=False)
        loss_sum, z_sum, cnt = loss_sum + lo, z_sum + z, cnt + msk.sum()
    cnt = torch.clamp(cnt, min=1.0)
    return loss_sum / cnt + z_weight * z_sum / cnt, cnt


def train_loss(params, cfg: ModelConfig, batch, remat: str = "dots",
               kv_block: int = 1024, ce_chunk: int = 512):
    """The training objective: chunked CE + 0.01 · MoE load balance +
    router z-loss.  Returns (loss, metrics)."""
    x, positions, mask = embed_inputs(params, cfg, batch)
    h, _, aux = forward_hidden(params, cfg, x, positions, None, "train",
                               remat=remat, kv_block=kv_block)
    ce, cnt = chunked_ce_loss(h, lm_head(params, cfg), batch["labels"], mask,
                              chunk=ce_chunk, z_weight=cfg.z_loss_weight)
    n_moe = max(1, sum(1 for b in cfg.blocks if b.kind == "moe"))
    lb = aux["lb_loss"] / n_moe
    loss = ce + 0.01 * lb + aux["z_loss"] / n_moe
    metrics = {
        "ce": ce,
        "lb_loss": lb,
        "router_z": aux["z_loss"] / n_moe,
        "overflow_frac": aux["overflow_frac"] / n_moe,
        "tokens": cnt,
    }
    return loss, metrics


# ---------------------------------------------------------------- serving ---


def prefill(params, cfg: ModelConfig, batch, caches):
    """Full-context forward that fills the caches (in place); returns
    (last-position logits (B, V) f32, caches)."""
    x, positions, _ = embed_inputs(params, cfg, batch)
    h, caches, _ = forward_hidden(params, cfg, x, positions, caches,
                                  "prefill", remat="none")
    logits = h[:, -1, :] @ lm_head(params, cfg).to(h.dtype)
    return logits.float(), caches


def decode_step(params, cfg: ModelConfig, tokens, positions, caches):
    """tokens (B, 1) int, positions (B, 1) int32 → (logits (B, V) f32,
    caches), the caches appended in place."""
    x = embed_lookup(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    h, caches, _ = forward_hidden(params, cfg, x, positions.to(torch.int32),
                                  caches, "decode", remat="none")
    logits = h[:, -1, :] @ lm_head(params, cfg).to(h.dtype)
    return logits.float(), caches
