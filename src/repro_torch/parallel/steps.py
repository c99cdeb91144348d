"""The train step on one device — the port of the single-device part of
``repro.parallel.steps``: the step configuration, the activation estimate
that picks the accumulation, the train state and the step itself.

    step = make_train_step(cfg, shape, sc, opt_cfg)
    state, metrics = step(state, batch)      # batch: dict of tensors

Gradient accumulation runs the A microbatches one after another and sums
their f32 gradients (divided by A, as the reference's scan does); remat
is the model's (`models.transformer.forward_hidden`).  Gradients come
from ``torch.autograd.grad`` over detached aliases of the parameters, so
nothing accumulates in ``.grad`` and AdamW updates the parameters (their
f32 master) in place.

Not ported yet (the multi-device slice): the mesh rules and sharding
constraints (no-ops on one device), FSDP/ZeRO specs, the compressed
multi-pod step, and the prefill and decode step factories.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..configs.registry import ShapeSpec
from ..models.transformer import init_params, train_loss
from ..optim.adamw import (AdamWConfig, OptState, adamw_update,
                           init_opt_state, leaves, tree_map)

# The reference budgets 6 GB of a 16 GB TPU v5e chip for activations; the
# same share of an H100's 80 GB.
H100_HBM_BYTES = 80e9
ACT_BUDGET_BYTES = H100_HBM_BYTES * 6 / 16

METRIC_KEYS = ("ce", "lb_loss", "router_z", "overflow_frac", "tokens")


class StepConfig(NamedTuple):
    accum_steps: int = 1
    remat: str = "full"  # "full" | "dots" | "2level" | "none"
    param_dtype: Any = torch.bfloat16
    act_budget_bytes: float = ACT_BUDGET_BYTES
    kv_block: int = 1024  # blockwise-attention KV block
    ce_chunk: int = 512  # chunked-CE sequence chunk


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
                        **over) -> StepConfig:
    """Accumulation and remat for the activation budget: a train shape
    doubles ``accum_steps`` until one microbatch's estimate fits (at most
    one row a microbatch), with 'full' remat; other shapes take neither."""
    sc = StepConfig()
    if shape.kind == "train":
        per_dev_tokens = shape.global_batch * shape.seq_len / max(dp, 1)
        max_accum = max(1, shape.global_batch // max(dp, 1))
        accum = 1
        while (accum < max_accum
               and est_train_act_bytes(cfg, per_dev_tokens / accum)
               > sc.act_budget_bytes):
            accum *= 2
        sc = sc._replace(accum_steps=accum, remat="full")
    else:
        sc = sc._replace(accum_steps=1, remat="none")
    return sc._replace(**over)


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    residuals: Any  # the reference's compression error feedback: {} here


def make_train_state(generator: torch.Generator, cfg: ModelConfig,
                     sc: StepConfig, device=None) -> TrainState:
    """Random parameters from ``generator`` (on the card unless
    ``device`` says otherwise), the optimizer state, no residuals."""
    params = init_params(generator, cfg, sc.param_dtype, device)
    return TrainState(params, init_opt_state(params), {})


def make_train_step(cfg: ModelConfig, shape: ShapeSpec, sc: StepConfig,
                    opt_cfg: AdamWConfig = AdamWConfig()):
    """Returns ``train_step(state, batch) → (state', metrics)``; ``batch``
    is a dict of tensors on the parameters' device, ``metrics`` 0-dim
    tensors (``loss``, ``ce``, ``lb_loss``, ``router_z``,
    ``overflow_frac``, ``tokens``, ``grad_norm``, ``lr``).  ``shape``
    selects the reference's mesh rules, which one device does not need."""
    del shape
    A = sc.accum_steps

    def grads_and_metrics(params, batch):
        """f32 gradients of the batch's loss (the mean over A
        microbatches) and its metrics."""
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        wrt = leaves(req)
        gacc, lacc, macc = None, None, None
        n = next(iter(batch.values())).shape[0] // A
        for i in range(A):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            loss, metrics = train_loss(req, cfg, mb, remat=sc.remat,
                                       kv_block=sc.kv_block,
                                       ce_chunk=sc.ce_chunk)
            grads = torch.autograd.grad(loss, wrt, allow_unused=True,
                                        materialize_grads=True)
            metrics = {k: torch.as_tensor(metrics[k], dtype=torch.float32,
                                          device=loss.device).detach()
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

    def train_step(state: TrainState, batch):
        grads, metrics = grads_and_metrics(state.params, batch)
        new_params, new_opt, opt_m = adamw_update(opt_cfg, grads, state.opt,
                                                  sc.param_dtype)
        metrics.update(opt_m)
        return TrainState(new_params, new_opt, state.residuals), metrics

    return train_step
