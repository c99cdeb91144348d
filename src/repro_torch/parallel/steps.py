"""Step factories — the port of ``repro.parallel.steps``: the step
configuration, the activation estimate that picks the accumulation, the
per-shape mesh rules, the train state and its specs, the train step on
one device or on a mesh, the serve steps (prefill, decode) and the
stand-ins for every model input of an (arch, shape) cell.

    step = make_train_step(cfg, shape, sc, opt_cfg)
    state, metrics = step(state, batch)      # batch: dict of tensors
    logits, caches = make_prefill_step(cfg, shape)(params, batch, caches)
    logits, caches = make_decode_step(cfg, shape)(params, tokens,
                                                  positions, caches)

Gradient accumulation runs the A microbatches one after another and sums
their f32 gradients (divided by A, as the reference's scan does); remat
is the model's (`models.transformer.forward_hidden`).  Gradients come
from ``torch.autograd.grad`` over detached aliases of the parameters, so
nothing accumulates in ``.grad`` and AdamW updates the parameters (their
f32 master) in place.

Under a mesh (`parallel.sharding.use_mesh`, a `DeviceMesh` from
`launch.mesh`) the state is DTensors laid out by `train_state_pspecs` —
FSDP over ``data`` (ZeRO: the optimizer state takes the parameters'
specs), tensor parallelism over ``model`` — and the step is the FSDP
pattern on DTensor: parameters gathered to their tensor-parallel
placements, the loss over a batch sharded over the batch axes, the
gradients reduced back to the parameters' placements, AdamW on the
shards.  With ``compress_pods`` the pods exchange their gradients through
the int8 error-feedback sum (`optim.compression`).

The serve steps run the model's ``prefill`` / ``decode_step`` under the
shape's rules (`_mode_rules`: a long-context batch of one spreads the KV
sequence over data + model).  Under a mesh the parameters are DTensors
(`serve_params`), the caches are laid out by `cache_pspecs` (the step
lays out plain caches itself), the inputs enter sharded over the batch
axes, and the attention kernels run on each rank's shard
(`parallel.shard_attention`): prefill on its (batch, heads) shard,
decode on its rows of the sequence-sharded cache with a log-sum-exp
merge across the shards.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..configs.registry import ShapeSpec
from ..launch.mesh import local_device
from ..models.transformer import decode_step as model_decode_step
from ..models.transformer import init_caches, init_params
from ..models.transformer import prefill as model_prefill
from ..models.transformer import train_loss
from ..optim.adamw import (AdamWConfig, OptState, adamw_update,
                           init_opt_state, leaves, tree_map)
from ..optim.compression import compress_psum, init_residuals
from .sharding import (axis_rules, batch_pspecs, cache_pspecs,
                       constrain_tree, current_mesh, distribute,
                       distribute_tree, is_dtensor, mesh_axes, param_pspecs,
                       placements, use_mesh, zip_tree)

# The reference budgets 6 GB of a 16 GB TPU v5e chip for activations; the
# same share of an H100's 80 GB.
H100_HBM_BYTES = 80e9
ACT_BUDGET_BYTES = H100_HBM_BYTES * 6 / 16

METRIC_KEYS = ("ce", "lb_loss", "router_z", "overflow_frac", "tokens")


class StepConfig(NamedTuple):
    accum_steps: int = 1
    remat: str = "full"  # "full" | "dots" | "2level" | "none"
    param_dtype: Any = torch.bfloat16
    fsdp: bool = True  # under a mesh: shard a replicated dim over "data"
    compress_pods: bool = False  # int8 error-feedback exchange over "pod"
    act_budget_bytes: float = ACT_BUDGET_BYTES
    kv_block: int = 1024  # blockwise-attention KV block
    ce_chunk: int = 512  # chunked-CE sequence chunk
    # The dry-run analysis pass (read by the dry-run tools).  The
    # reference unrolls its static-trip loops so that XLA's cost analysis
    # counts every iteration; eager torch counts every iteration anyway,
    # so here it selects what the reference's lowering computes: one
    # microbatch (A = 1), one KV block and one CE chunk (both 10**9).
    analysis: bool = False


# --------------------------------------------------------------- helpers ----


def dp_size(axes=None) -> int:
    """The data-parallel degree: pod × data of the active mesh (or
    ``axes``)."""
    axes = mesh_axes() if axes is None else axes
    return axes.get("pod", 1) * axes.get("data", 1)


def est_train_act_bytes(cfg: ModelConfig, tokens_micro: float,
                        tp: int = 1) -> float:
    """Rough per-device activation bytes for one microbatch under 'full'
    remat: the unit carries plus the transient working set of one
    recomputed unit (qkv/ffn/moe buffers, f32 attention accumulators) —
    the reference's estimate, ``tp`` its tensor-parallel divisor (1 on
    one device)."""
    div = lambda n: n / tp if (n and n % tp == 0) else n
    D, hd = cfg.d_model, cfg.hd
    heads_eff = div(cfg.n_heads) * hd
    carries = cfg.n_layers * tokens_micro * D * 2
    trans = tokens_micro * 2 * (4 * D + 6 * heads_eff)
    trans += tokens_micro * 4 * 2 * heads_eff  # f32 online-softmax acc+stats
    if cfg.d_ff:
        trans += tokens_micro * 2 * 3 * div(cfg.d_ff)
    if cfg.n_experts:
        ep = max(cfg.n_experts, cfg.n_experts_pad)
        e_div = tp if ep % tp == 0 else 1
        trans += tokens_micro * cfg.top_k * cfg.capacity_factor * 2 * (
            2 * D + 2 * cfg.d_expert
        ) / e_div
        if cfg.d_shared:
            trans += tokens_micro * 2 * 2 * cfg.d_shared
    if cfg.lru_width:
        trans += tokens_micro * 2 * 8 * div(cfg.lru_width)
    return carries + trans


def default_step_config(cfg: ModelConfig, shape: ShapeSpec, dp: int = 1,
                        axes=None, **over) -> StepConfig:
    """The reference's pick of accumulation, remat and FSDP: a train shape
    doubles ``accum_steps`` until one microbatch's estimate (per data
    rank, its products divided by the mesh's ``model`` size) fits the
    activation budget (at most one row a microbatch), with 'full' remat
    and FSDP; other shapes take none of them.  ``axes`` gives the mesh's
    axis sizes (the active mesh's by default); an ``act_budget_bytes`` in
    ``over`` sets the budget the pick uses."""
    sc = StepConfig()
    if "act_budget_bytes" in over:
        sc = sc._replace(act_budget_bytes=over["act_budget_bytes"])
    if shape.kind == "train":
        tp = (mesh_axes() if axes is None else axes).get("model", 1)
        per_dev_tokens = shape.global_batch * shape.seq_len / max(dp, 1)
        max_accum = max(1, shape.global_batch // max(dp, 1))
        accum = 1
        while (accum < max_accum
               and est_train_act_bytes(cfg, per_dev_tokens / accum, tp)
               > sc.act_budget_bytes):
            accum *= 2
        sc = sc._replace(accum_steps=accum, remat="full")
    else:
        sc = sc._replace(fsdp=False, accum_steps=1, remat="none")
    return sc._replace(**over)


def _mode_rules(cfg: ModelConfig, shape: ShapeSpec, axes=None) -> dict:
    """Logical-rule overrides per shape: the batch axes must divide
    global_batch; long-context (batch=1) spreads the KV sequence over
    data+model."""
    axes = mesh_axes() if axes is None else axes
    prod = 1
    picked = []
    for a in ("pod", "data"):
        if a in axes and shape.global_batch % (prod * axes[a]) == 0:
            picked.append(a)
            prod *= axes[a]
    batch_rule = tuple(picked) if picked else None
    seq_kv = (("data", "model") if (shape.kind != "train" and "data" in axes
                                    and prod == 1) else ("model",))
    return dict(batch=batch_rule, seq_kv=seq_kv)


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    residuals: Any  # compression error feedback ({} unless compress_pods)


def train_state_pspecs(state: TrainState, sc: StepConfig, axes=None):
    """The specs of every leaf (`parallel.sharding`): parameters by path
    (FSDP as ``sc`` says), the optimizer's moments and master like them,
    its step replicated; residuals like the parameters, behind a leading
    ``pod`` entry where the mesh has pods (one residual a pod,
    `optim.compression.init_residuals`)."""
    axes = mesh_axes() if axes is None else axes
    pspec = param_pspecs(state.params, fsdp=sc.fsdp, axes=axes)
    res_spec = {}
    if state.residuals:
        res_spec = pspec
        if "pod" in axes and sc.compress_pods:
            res_spec = zip_tree(lambda s, _: ("pod",) + s, pspec, pspec)
    return TrainState(params=pspec,
                      opt=OptState(step=(), mu=pspec, nu=pspec, master=pspec),
                      residuals=res_spec)


def distribute_state(state: TrainState, sc: StepConfig, mesh) -> TrainState:
    """A full train state (every rank holds all of it) laid out on
    ``mesh`` by `train_state_pspecs`: each rank keeps its slices, with no
    communication; the step stays a plain 0-dim tensor (replicated).  As
    on one device, an f32 model's master IS its parameters."""
    specs = train_state_pspecs(state, sc, mesh_axes(mesh))
    params = distribute_tree(state.params, mesh, specs.params)
    d = lambda t, s: distribute_tree(t, mesh, s)
    master = (params if sc.param_dtype == torch.float32
              and all(a.data_ptr() == b.data_ptr() for a, b in
                      zip(leaves(state.params), leaves(state.opt.master)))
              else d(state.opt.master, specs.opt.master))
    opt = OptState(step=state.opt.step, mu=d(state.opt.mu, specs.opt.mu),
                   nu=d(state.opt.nu, specs.opt.nu), master=master)
    res = d(state.residuals, specs.residuals) if state.residuals else {}
    return TrainState(params, opt, res)


def make_train_state(generator: torch.Generator, cfg: ModelConfig,
                     sc: StepConfig, device=None, mesh=None) -> TrainState:
    """Random parameters from ``generator`` (on the card unless
    ``device`` says otherwise), the optimizer state and, with
    ``sc.compress_pods``, zero residuals.  With ``mesh`` every rank
    draws the whole state on its own device (the same generator seed on
    every rank gives the same numbers) and keeps its slices
    (`distribute_state`)."""
    if mesh is not None:
        device = local_device(mesh)
    params = init_params(generator, cfg, sc.param_dtype, device)
    n_pods = mesh_axes(mesh).get("pod", 0) if mesh is not None else 0
    res = init_residuals(params, n_pods) if sc.compress_pods else {}
    state = TrainState(params, init_opt_state(params), res)
    return state if mesh is None else distribute_state(state, sc, mesh)


def abstract_train_state(cfg: ModelConfig, sc: StepConfig) -> TrainState:
    """The train state's shapes and dtypes as meta tensors (the
    reference's ``jax.eval_shape`` of `make_train_state`): nothing is
    allocated."""
    return make_train_state(torch.Generator(), cfg, sc, device="meta")


def _plain(v):
    """A metric as a plain tensor: a DTensor's full value."""
    return v.full_tensor() if is_dtensor(v) else v


def _grads_and_metrics(cfg: ModelConfig, sc: StepConfig, params,
                       microbatches):
    """f32 gradients of the batch's loss (the mean over its microbatches)
    and its metrics.  Gradients come from ``torch.autograd.grad`` over
    detached aliases of ``params``; under a mesh they are DTensors
    placed as autograd leaves them (``Partial`` where ranks saw different
    rows)."""
    A = len(microbatches)
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    wrt = leaves(req)
    gacc, lacc, macc = None, None, None
    for mb in microbatches:
        loss, metrics = train_loss(req, cfg, mb, remat=sc.remat,
                                   kv_block=sc.kv_block, ce_chunk=sc.ce_chunk)
        grads = torch.autograd.grad(loss, wrt, allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: (metrics[k].detach().float()
                       if isinstance(metrics[k], torch.Tensor)
                       else torch.tensor(float(metrics[k]),
                                         device=loss.device))
                   for k in METRIC_KEYS}
        if gacc is None:
            gacc = [g.float() for g in grads]
            lacc, macc = loss.detach(), metrics
        else:
            for a, g in zip(gacc, grads):
                a.add_(g.float())
            lacc = lacc + loss.detach()
            macc = {k: macc[k] + metrics[k] for k in METRIC_KEYS}
        del grads, loss
    if A > 1:
        gacc = [g.div_(A) for g in gacc]
        macc = {k: v if k == "tokens" else v / A for k, v in macc.items()}
        lacc = lacc / A
    by_leaf = {id(w): g for w, g in zip(wrt, gacc)}
    return tree_map(lambda w: by_leaf[id(w)], req), dict(macc, loss=lacc)


def _rows(batch, lo: int, hi: int) -> dict:
    return {k: _plain(v)[lo:hi] for k, v in batch.items()}


def _microbatches(batch, A: int, mesh=None) -> list:
    """The A microbatches of ``batch`` (rows in order); under ``mesh``
    each laid out over the batch axes (every rank holds the whole batch
    and keeps its rows: no communication)."""
    n = next(iter(batch.values())).shape[0] // A
    out = [_rows(batch, i * n, (i + 1) * n) for i in range(A)]
    if mesh is not None:
        out = [distribute_tree(mb, mesh, batch_pspecs(mb)) for mb in out]
    return out


def _placed(tree, specs, mesh):
    return zip_tree(lambda x, s: x.redistribute(mesh, placements(s, mesh)),
                    tree, specs)


def _mesh_grads(cfg, sc, params, batch, mesh):
    """Gradients on ``mesh`` with the FSDP pattern: the parameters
    gathered to their tensor-parallel placements (``fsdp=False`` specs,
    the all-gather over ``data``), the loss's ``Partial`` gradients
    brought back to the parameters' placements (the reduce over
    ``data``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    tp = param_pspecs(params, fsdp=False)
    fs = param_pspecs(params, fsdp=sc.fsdp)
    with implicit_replication():
        work = zip_tree(lambda p, s: p.redistribute(
            mesh, placements(s, mesh)).detach(), params, tp)
        grads, metrics = _grads_and_metrics(
            cfg, sc, work, _microbatches(batch, sc.accum_steps, mesh))
        del work
        return _placed(grads, fs, mesh), metrics


def make_train_step(cfg: ModelConfig, shape: ShapeSpec, sc: StepConfig,
                    opt_cfg: AdamWConfig = AdamWConfig()):
    """Returns ``train_step(state, batch) → (state', metrics)``; ``batch``
    is a dict of tensors on the parameters' device (the whole global
    batch), ``metrics`` 0-dim tensors (``loss``, ``ce``, ``lb_loss``,
    ``router_z``, ``overflow_frac``, ``tokens``, ``grad_norm``, ``lr``).

    Made with no active mesh, the step runs on one device.  Made under
    ``use_mesh(mesh)``, it runs on that mesh, its state laid out by
    `train_state_pspecs` (`make_train_state(..., mesh=mesh)`), every rank
    calling it with the same batch: the batch enters ``Shard(0)`` over
    the batch axes, ``train_loss`` runs on DTensor parameters under the
    shape's rules (`_mode_rules`), the gradients are reduced to the
    parameters' placements, and AdamW updates the DTensor state in place
    — its clip by the global gradient norm.  With ``sc.compress_pods`` on
    a (pod, data, model) mesh each pod takes its slice of the batch on its
    own (data, model) ranks and the pods exchange their gradients through
    `optim.compression.compress_psum`."""
    mesh = current_mesh()
    rules = _mode_rules(cfg, shape)
    if sc.analysis:
        sc = sc._replace(accum_steps=1, kv_block=10**9, ce_chunk=10**9)

    if mesh is None:
        A = sc.accum_steps

        def train_step(state: TrainState, batch):
            grads, metrics = _grads_and_metrics(
                cfg, sc, state.params, _microbatches(batch, A))
            new_params, new_opt, opt_m = adamw_update(opt_cfg, grads,
                                                      state.opt,
                                                      sc.param_dtype)
            metrics.update(opt_m)
            return TrainState(new_params, new_opt, state.residuals), metrics

        return train_step

    def apply_updates(state, grads, metrics, fs):
        from torch.distributed.tensor.experimental import implicit_replication

        with use_mesh(mesh), implicit_replication():
            new_params, new_opt, opt_m = adamw_update(opt_cfg, grads,
                                                      state.opt,
                                                      sc.param_dtype)
            new_params = constrain_tree(new_params, fs)
            metrics.update(opt_m)
            return new_params, new_opt, {k: _plain(v)
                                         for k, v in metrics.items()}

    if not (sc.compress_pods and "pod" in mesh_axes(mesh)):

        def train_step_mesh(state: TrainState, batch):
            with use_mesh(mesh), axis_rules(**rules):
                grads, metrics = _mesh_grads(cfg, sc, state.params, batch,
                                             mesh)
                fs = train_state_pspecs(state, sc).params
            new_params, new_opt, metrics = apply_updates(state, grads,
                                                         metrics, fs)
            return TrainState(new_params, new_opt, state.residuals), metrics

        return train_step_mesh

    # ---- hierarchical compressed variant: each pod on its own ranks ----
    # The reference runs this in a shard_map manual over "pod" whose model
    # code still meets the default batch rule ("pod", "data") and raises
    # on jax 0.9 ("can only refer to Auto axes").  Here each pod works on
    # the (data, model) sub-mesh, which has no "pod" dimension:
    # `sharding._resolve` drops the missing axis, so the batch rule is
    # "data" inside a pod.
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    sub = mesh["data", "model"]
    n_pods = mesh_axes(mesh)["pod"]
    pod = mesh.get_local_rank("pod")
    pod_group = mesh.get_group("pod")

    def to_sub(x, spec):
        return DTensor.from_local(x.to_local(), sub, placements(spec, sub),
                                  run_check=False)

    def train_step_compressed(state: TrainState, batch):
        full = {k: _plain(v) for k, v in batch.items()}
        B = next(iter(full.values())).shape[0]
        pod_batch = _rows(full, pod * B // n_pods, (pod + 1) * B // n_pods)
        with use_mesh(sub), axis_rules(**rules):
            fs_sub = param_pspecs(state.params, fsdp=sc.fsdp)
            params = zip_tree(to_sub, state.params, fs_sub)
            grads, metrics = _mesh_grads(cfg, sc, params, pod_batch, sub)
        with use_mesh(mesh):
            specs = train_state_pspecs(state, sc)
        g_new, r_new = [], []
        for g, r, s, rs in zip(leaves(grads), leaves(state.residuals),
                               _spec_leaves(specs.params),
                               _spec_leaves(specs.residuals)):
            # the exchange works on the whole leaf, as the reference's
            # does: its 256-value blocks (and so its scales) are cut from
            # the flattened logical leaf, not from a rank's shard
            r_pod = DTensor.from_local(r.to_local()[0], sub,
                                       placements(rs[1:], sub),
                                       run_check=False).full_tensor()
            gm, nr = compress_psum(g.full_tensor(), r_pod, pod_group, n_pods)
            g_new.append(distribute(gm, mesh, s))
            r_loc = distribute(nr, sub, rs[1:]).to_local()[None]
            r_new.append(DTensor.from_local(r_loc, mesh, placements(rs, mesh),
                                            run_check=False))
        for k in metrics:
            v = _plain(metrics[k]).clone()
            dist.all_reduce(v, group=pod_group)
            metrics[k] = v / n_pods
        grads = _unflatten_like(state.params, g_new)
        new_res = _unflatten_like(state.residuals, r_new)
        new_params, new_opt, metrics = apply_updates(state, grads, metrics,
                                                     specs.params)
        return TrainState(new_params, new_opt, new_res), metrics

    return train_step_compressed


# ------------------------------------------------------------ serve steps ---


def serve_params(params, mesh):
    """Full parameters (every rank holds them whole) laid out on ``mesh``
    for the serve steps: tensor parallelism over ``model``, no FSDP (the
    reference's serve shapes take none); each rank keeps its slices."""
    return distribute_tree(params, mesh,
                           param_pspecs(params, fsdp=False,
                                        axes=mesh_axes(mesh)))


def _placed_caches(caches, mesh):
    """Caches laid out on ``mesh`` by `cache_pspecs` under the active
    rules: a plain leaf (every rank holds it whole) keeps each rank's
    slice, a DTensor leaf is redistributed."""
    return zip_tree(lambda x, s: x.redistribute(mesh, placements(s, mesh))
                    if is_dtensor(x) else distribute(x, mesh, s),
                    caches, cache_pspecs(caches))


def _serve_call(mesh, rules, fn, inputs: dict, caches):
    """``fn(inputs, caches)`` on one device, or under ``mesh``: the
    inputs sharded over the batch axes, the caches laid out by
    `cache_pspecs` before and after (the reference's constraint)."""
    if mesh is None:
        return fn(inputs, caches)
    from torch.distributed.tensor.experimental import implicit_replication

    with use_mesh(mesh), axis_rules(**rules), implicit_replication():
        inputs = zip_tree(lambda x, s: x if is_dtensor(x)
                          else distribute(x, mesh, s), inputs,
                          batch_pspecs(inputs))
        logits, caches = fn(inputs, _placed_caches(caches, mesh))
        return logits, _placed_caches(caches, mesh)


def make_prefill_step(cfg: ModelConfig, shape: ShapeSpec,
                      sc: StepConfig = StepConfig()):
    """Returns ``prefill_step(params, batch, caches) → (logits (B, V) f32,
    caches)``: `models.transformer.prefill` under the shape's rules.  Made
    with no active mesh it runs on one device, writing ``caches`` in
    place.  Made under ``use_mesh(mesh)``, every rank calls it with the
    same whole batch and with parameters from `serve_params`; the caches
    come back as DTensors laid out by `cache_pspecs` (plain caches are
    laid out first), the logits a DTensor (``full_tensor()`` gives them
    whole).  ``sc`` is taken for the reference's signature: the flash
    kernel has no KV block, and no loop here needs unrolling."""
    mesh = current_mesh()
    rules = _mode_rules(cfg, shape)

    def prefill_step(params, batch, caches):
        return _serve_call(mesh, rules, lambda b, c: model_prefill(
            params, cfg, b, c), dict(batch), caches)

    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: ShapeSpec,
                     sc: StepConfig = StepConfig()):
    """Returns ``decode_step(params, tokens (B, 1), positions (B, 1),
    caches) → (logits (B, V) f32, caches)``: one
    `models.transformer.decode_step` under the shape's rules, on one
    device or on the mesh it was made under, as `make_prefill_step`."""
    mesh = current_mesh()
    rules = _mode_rules(cfg, shape)

    def decode_step(params, tokens, positions, caches):
        return _serve_call(mesh, rules, lambda b, c: model_decode_step(
            params, cfg, b["tokens"], b["positions"], c),
            {"tokens": tokens, "positions": positions}, caches)

    return decode_step


# ------------------------------------------------------------ input specs ---


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                cache_dtype=torch.bfloat16) -> dict:
    """Meta-tensor stand-ins (the reference's ``ShapeDtypeStruct``s) for
    every model input of this (arch, shape) cell; nothing is allocated.

    train   → {"batch": {tokens, labels, [patch/frame embeds]}}
    prefill → {"batch": …, "caches": the cache tree}
    decode  → {"tokens", "positions", "caches"}
    """
    B, S = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")  # noqa
    i32, emb = torch.int32, torch.bfloat16

    def batch_struct(seq_len):
        b = {"tokens": meta((B, seq_len), i32),
             "labels": meta((B, seq_len), i32)}
        if cfg.frontend == "vision":
            b["patch_embeds"] = meta((B, cfg.n_patches, cfg.d_model), emb)
            b["labels"] = meta((B, seq_len + cfg.n_patches), i32)
        elif cfg.frontend == "audio":
            b = {"frame_embeds": meta((B, seq_len, cfg.d_model), emb),
                 "labels": meta((B, seq_len), i32)}
        return b

    if shape.kind == "train":
        return {"batch": batch_struct(S)}
    capacity = S + (cfg.n_patches if cfg.frontend == "vision" else 0)
    caches = init_caches(cfg, B, capacity, cache_dtype, device="meta")
    if shape.kind == "prefill":
        b = batch_struct(S)
        b.pop("labels", None)  # prefill consumes no labels
        return {"batch": b, "caches": caches}
    return {"tokens": meta((B, 1), i32), "positions": meta((B, 1), i32),
            "caches": caches}


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in `leaves` order (dict keys sorted)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def _unflatten_like(tree, flat: list):
    """``tree``'s structure with its leaves, in `leaves` order, taken
    from ``flat``."""
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            out = {k: go(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, list):
            return [go(v) for v in t]
        return next(it)

    return go(tree)
