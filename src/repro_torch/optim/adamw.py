"""AdamW — the port of ``repro.optim.adamw`` for one device: f32 master
weights and moments, global-norm clipping in f32, a linear-warmup cosine
schedule, decoupled weight decay skipped for leaves with ndim ≤ 1.

A function on dicts of tensors, not ``torch.optim.AdamW``: the schedule,
the clip by the global norm of every gradient leaf and the ndim rule are
the reference's, which a library optimizer would not reproduce.  The
moments and the master copy are updated in place under
``torch.no_grad()`` (a stacked unit leaf is one tensor, updated as one);
the new working parameters are the master cast to ``param_dtype``.  For
f32 parameters the master IS the parameter storage (`init_opt_state`
casts without a copy, as ``astype`` does in the reference), so the update
writes the caller's parameters in place and a model keeps four f32 copies
(parameters, mu, nu, gradients), not five.  The reference's ZeRO
shardings and int8 compression wait for the multi-device slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..checkpoint.manager import path_leaves


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    mu: dict  # first moment,  f32, like params
    nu: dict  # second moment, f32, like params
    master: dict  # f32 master copy of params


def tree_map(fn, tree):
    """``fn`` over every tensor of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> list:
    """The tensors of a nest in JAX's flatten order (dict keys sorted)."""
    return [leaf for _, leaf in path_leaves(tree)]


def init_opt_state(params) -> OptState:
    dev = leaves(params)[0].device
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(f32, params),
        nu=tree_map(f32, params),
        master=tree_map(lambda p: p.detach().float(), params),
    )


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a 0-dim tensor) as a 0-dim f32
    tensor."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2)
                          for leaf in leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt: OptState,
                 param_dtype=torch.float32):
    """Returns (new_params, new_opt_state, metrics); ``opt``'s moments and
    master are updated in place, so the returned state holds the same
    tensors (its ``step`` is a new one).  Decoupled weight decay on the
    master weights."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = opt.step + 1
    lr = schedule(cfg, opt.step)
    b1, b2 = cfg.beta1, cfg.beta2
    # bias correction
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    for g, m, v, w in zip(leaves(grads), leaves(opt.mu), leaves(opt.nu),
                          leaves(opt.master)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        # decoupled weight decay — skipped for norms/biases (ndim ≤ 1)
        wd = cfg.weight_decay if w.ndim > 1 else 0.0
        w.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + cfg.eps) + wd * w))
    new_params = tree_map(lambda w: w.to(param_dtype), opt.master)
    new_opt = OptState(step=step, mu=opt.mu, nu=opt.nu, master=opt.master)
    return new_params, new_opt, {"grad_norm": gnorm, "lr": lr}
