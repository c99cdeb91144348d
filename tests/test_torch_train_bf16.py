"""The mixed-precision train step — the reference's `StepConfig()` bf16:
bf16 working parameters, an f32 master and f32 moments in `OptState`,
AdamW casting the master back to bf16 — against JAX's `make_train_step`
at bf16 on the CPU, one step from the same converted `TrainState`, at
A = 1 and A = 4, on the qwen2-0.5b, deepseek-moe-16b, recurrentgemma-9b
and xlstm-350m smoke configs (B = 8 × S = 16).

The two sides round to bf16 at their own points (the sums of the bf16
products, XLA's excess precision where a bf16 op meets an f32 cast:
ROADMAP queue 3), so nothing here is bit-equal.  Each tolerance comes
from JAX's own yardstick: the gap JAX's bf16 step opens from JAX's step
on the same parameters cast to f32 (run once a config, at A = 1).  By
the triangle inequality two bf16 runs that each stray that far from f32
stay within twice it of each other, so:

* the metrics (loss, ce, lb_loss, router_z) within `METRIC_TOL`
  relative: a scalar's gap is one sample of the rounding noise (one
  config's loss yardstick came out at 4.5e-5, another's at 1.2e-3), so
  the tolerance is `YARD` × the largest gap JAX's bf16 step opened from
  its f32 one over the four configs' loss, ce, lb_loss and router_z
  (1.2e-3, deepseek-moe-16b's ce), rounded up; ``tokens`` and ``lr``
  equal;
* the moments: every leaf of ``mu`` and ``nu`` within `YARD` × the
  largest gap (relative L2 over the leaf) JAX's bf16 moments open from
  its f32 ones; the gradient norm within the first moments' bound (the
  norm of a difference bounds the difference of the norms);
* the master: Adam's first step moves a weight by lr · g/(|g| + eps),
  ±lr wherever |g| ≫ eps, so a gradient element whose sign the two
  roundings flip moves the two masters 2 · lr apart: every element
  within 2 · lr (the weight decay is the same on both sides), and the
  share of elements more than lr/2 apart within `YARD` × the share JAX's
  bf16 step flips against its f32 one.  A leaf whose gradient is zero in
  exact arithmetic — the key bias, which adds the same amount to every
  score of a query, so the softmax cancels it — takes its sign from
  rounding noise on every side: it is held only to the 2 · lr bound;
* the working parameters bf16 and equal to the master rounded, the
  master and the moments f32.

deepseek-moe-16b runs at capacity factor 16 on both sides, as
`chip_smoke.py`'s prefill checks do: its router picks are held on bf16
inputs in `tests/test_torch_bf16.py`; here the hidden states entering
the router differ by the roundings above, so a near-tie can pick another
expert, and at the config's 1.25 a changed pick reorders the FCFS
admission of every later token.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ShapeSpec as JShape
from repro.configs.registry import get_smoke_config as j_smoke
from repro.optim import adamw as jadam
from repro.parallel import steps as jsteps
from repro_torch import convert
from repro_torch.configs.registry import ShapeSpec as TShape
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.optim import adamw as tadam
from repro_torch.parallel import steps as tsteps

YARD = 2.0                       # × JAX's own bf16-against-f32 gap
LR = 1e-3
B, S = 8, 16
ARCHS = ["qwen2-0.5b", "deepseek-moe-16b", "recurrentgemma-9b",
         "xlstm-350m"]
LOSS_METRICS = ("loss", "ce", "lb_loss", "router_z")
METRIC_TOL = 2.5e-3              # relative; see the module docstring
ZERO_GRAD_LEAVES = ("['bk']",)   # the key bias (see the module docstring)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _configs(name):
    jc, tc = j_smoke(name), t_smoke(name)
    if name == "deepseek-moe-16b":
        jc = dataclasses.replace(jc, capacity_factor=16.0)
        tc = dataclasses.replace(tc, capacity_factor=16.0)
    return jc, tc


def _batch(cfg):
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


_OPT = jadam.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
_SHAPE = ("t", S, B, "train")


def _jax_step(jc, A, param_dtype, state):
    js = jsteps.default_step_config(jc, JShape(*_SHAPE), dp=1,
                                    accum_steps=A, fsdp=False,
                                    param_dtype=param_dtype)
    step = jax.jit(jsteps.make_train_step(jc, JShape(*_SHAPE), js, _OPT))
    return step(state, {k: jnp.asarray(v)
                        for k, v in _batch(jc).items()})


@functools.lru_cache(maxsize=None)
def _reference(name):
    """JAX's bf16 state before the step, and its f32 run's state and
    metrics after one step at A = 1 on the same parameters cast to f32
    (the yardstick)."""
    jc, _ = _configs(name)
    js = jsteps.default_step_config(jc, JShape(*_SHAPE), dp=1, fsdp=False)
    assert js.param_dtype == jnp.bfloat16
    state = jsteps.make_train_state(jax.random.PRNGKey(0), jc, js)
    s32 = state._replace(params=jax.tree.map(
        lambda a: a.astype(jnp.float32), state.params))
    return state, _jax_step(jc, 1, jnp.float32, s32)


def _rel(a, b) -> float:
    return float(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30))


def _leaf_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("A", [1, 4])
@pytest.mark.parametrize("name", ARCHS)
def test_train_step_bf16_matches_jax(name, A):
    jc, tc = _configs(name)
    jstate, (j32, _) = _reference(name)
    ts = tsteps.default_step_config(tc, TShape(*_SHAPE), dp=1,
                                    accum_steps=A)
    assert ts.param_dtype == torch.bfloat16 and ts.remat == "full"
    tstate = convert.train_state_from_jax(jstate, device="cpu")
    jnew, jm = _jax_step(jc, A, jnp.bfloat16, jstate)
    tnew, tm = tsteps.make_train_step(
        tc, TShape(*_SHAPE), ts, tadam.AdamWConfig(*_OPT))(
            tstate, {k: torch.as_tensor(v) for k, v in _batch(jc).items()})

    # the metrics
    for k in LOSS_METRICS:
        assert _rel(tm[k], jm[k]) <= METRIC_TOL, (k, float(tm[k]),
                                                  float(jm[k]))
    for k in ("tokens", "lr"):
        assert float(tm[k]) == float(jm[k]), k
    assert int(tnew.opt.step) == 1

    # dtypes: bf16 working parameters, the f32 master and moments
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jnew.params)]
    for w, m in zip(tadam.leaves(tnew.params),
                    tadam.leaves(tnew.opt.master)):
        assert m.dtype == torch.float32
        if w.is_floating_point() and w.dtype != torch.float32:
            assert w.dtype == torch.bfloat16
            assert torch.equal(w, m.to(torch.bfloat16))
    for t, j in zip(tadam.leaves(tnew.params), jax.tree.leaves(jnew.params)):
        assert convert.tree_to_numpy(t).dtype == np.asarray(j).dtype

    # the moments
    for f in ("mu", "nu"):
        want = jax.tree.leaves(getattr(jnew.opt, f))
        yard = max(_leaf_l2(w, y) for w, y in
                   zip(want, jax.tree.leaves(getattr(j32.opt, f))))
        for path, t, w in zip(paths, tadam.leaves(getattr(tnew.opt, f)),
                              want):
            assert t.dtype == torch.float32
            assert _leaf_l2(t, w) <= YARD * yard, (f, path, yard)
        if f == "mu":
            assert _rel(tm["grad_norm"], jm["grad_norm"]) <= YARD * yard

    # the master: every element within 2 lr, the flips as rare as JAX's
    flips, own, n = 0, 0, 0
    for path, t, w, y in zip(paths, tadam.leaves(tnew.opt.master),
                             jax.tree.leaves(jnew.opt.master),
                             jax.tree.leaves(j32.opt.master)):
        gap = np.abs(_np(t) - _np(w))
        assert gap.max() <= 2 * LR * (1 + 1e-3), (path, gap.max())
        if not path.endswith(ZERO_GRAD_LEAVES):
            flips += int((gap > LR / 2).sum())
            own += int((np.abs(_np(y) - _np(w)) > LR / 2).sum())
            n += gap.size
    assert flips <= YARD * own, (flips / n, own / n)
