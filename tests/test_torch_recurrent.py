"""The port's recurrent blocks (`repro_torch.models.{rglru,xlstm}`) and
their states (`repro_torch.models.cache`) against the JAX package's on the
same parameters (carried across by `convert.params_from_jax`) and seeded
numpy inputs, f32 with TF32 off:

* ``make_{mlstm,slstm,rglru}_state``: the reference's keys, shapes and
  dtypes, zeros, on the device asked for;
* ``_causal_conv1d`` with and without a carried tail: exact;
* ``rglru_block_forward`` (the port's log-depth scan against the
  reference's ``lax.associative_scan``), ``rglru_block_step``,
  ``mlstm_forward`` and ``slstm_forward``, from a zero and from a
  nonzero state: outputs and every state leaf within 1e-5;
* chunking: forward over S, then a step (or a forward over one token),
  equals forward over S + 1 (1e-5), on both sides;
* ``_linear_scan`` against the plain time loop h_t = a_t h_{t−1} + b_t at
  lengths 1 to 33 (1e-6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as jcache
from repro.models import rglru as jr
from repro.models import xlstm as jx
from repro_torch import convert
from repro_torch.models import cache as tcache
from repro_torch.models import rglru as tr
from repro_torch.models import xlstm as tx

torch.backends.cuda.matmul.allow_tf32 = False

B, D, H, S = 2, 32, 2, 12
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _x(seed, s=S, d=D):
    return np.random.default_rng(seed).standard_normal(
        (B, s, d)).astype(np.float32)


def _close(t, j, **tol):
    """Equal nesting; every leaf within tol."""
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _close(t[k], j[k], **tol)
    else:
        assert tuple(t.shape) == tuple(j.shape)
        np.testing.assert_allclose(_np(t), np.asarray(j), **(tol or TOL))


def _noisy(state, seed):
    """A nonzero state of the same shapes (the stabiliser ``m`` kept
    moderate)."""
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in state.items()}


BLOCKS = {
    "rglru": (lambda k: jr.init_rglru_block(k, D, D, jnp.float32),
              lambda p, x, st: jr.rglru_block_forward(p, x, st),
              lambda p, x, st: tr.rglru_block_forward(p, x, st),
              lambda b: jcache.make_rglru_state(b, D)),
    "mlstm": (lambda k: jx.init_mlstm(k, D, H, jnp.float32),
              lambda p, x, st: jx.mlstm_forward(p, x, H, st),
              lambda p, x, st: tx.mlstm_forward(p, x, H, st),
              lambda b: jcache.make_mlstm_state(b, H, D, D, 2 * D)),
    "slstm": (lambda k: jx.init_slstm(k, D, H, jnp.float32),
              lambda p, x, st: jx.slstm_forward(p, x, H, st),
              lambda p, x, st: tx.slstm_forward(p, x, H, st),
              lambda b: jcache.make_slstm_state(b, H, D // H)),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_state_makers_match_jax(kind):
    want = BLOCKS[kind][3](B)
    got = {"rglru": lambda: tcache.make_rglru_state(B, D, device="cpu"),
           "mlstm": lambda: tcache.make_mlstm_state(B, H, D, D, 2 * D,
                                                    device="cpu"),
           "slstm": lambda: tcache.make_slstm_state(B, H, D // H,
                                                    device="cpu")}[kind]()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype) == f"torch.{v.dtype}", k
        assert got[k].device.type == "cpu" and not got[k].any()


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(with_tail):
    x, w = _x(1), _x(2, s=4)[0]
    tail = _x(3, s=3) if with_tail else None
    jo, jt = jx._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                               None if tail is None else jnp.asarray(tail))
    to, tt = tx._causal_conv1d(torch.as_tensor(x), torch.as_tensor(w),
                               None if tail is None else torch.as_tensor(tail))
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kind,start", [(k, s) for k in sorted(BLOCKS)
                                        for s in ("zero", "carried")])
def test_block_forward_matches_jax(kind, start):
    init, jfwd, tfwd, make = BLOCKS[kind]
    p = init(jax.random.PRNGKey(7))
    st = {k: np.asarray(v) for k, v in make(B).items()}
    if start == "carried":
        st = _noisy(st, 11)
    x = _x(5)
    jy, jst = jfwd(p, jnp.asarray(x), {k: jnp.asarray(v)
                                       for k, v in st.items()})
    ty, tst = tfwd(convert.params_from_jax(p, device="cpu"),
                   torch.as_tensor(x), convert.tree_from_jax(st, "cpu"))
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_forward_then_step_equals_longer_forward(kind):
    """Forward over S, then one more token (the RG-LRU's decode step, the
    xLSTM's forward over one token), equals forward over S + 1 from the
    same start — on the port, and the port's step equals JAX's."""
    init, jfwd, tfwd, make = BLOCKS[kind]
    p = init(jax.random.PRNGKey(9))
    tp = convert.params_from_jax(p, device="cpu")
    x = _x(13, s=S + 1)
    zero = {k: np.asarray(v) for k, v in make(B).items()}
    t_full, t_full_st = tfwd(tp, torch.as_tensor(x),
                             convert.tree_from_jax(zero, "cpu"))
    _, t_st = tfwd(tp, torch.as_tensor(x[:, :S]),
                   convert.tree_from_jax(zero, "cpu"))
    _, j_st = jfwd(p, jnp.asarray(x[:, :S]),
                   {k: jnp.asarray(v) for k, v in zero.items()})
    last = x[:, S:]
    if kind == "rglru":
        t_y, t_st2 = tr.rglru_block_step(tp, torch.as_tensor(last), t_st)
        j_y, j_st2 = jr.rglru_block_step(p, jnp.asarray(last), j_st)
    else:
        t_y, t_st2 = tfwd(tp, torch.as_tensor(last), t_st)
        j_y, j_st2 = jfwd(p, jnp.asarray(last), j_st)
    _close(t_y, t_full[:, S:])
    _close(t_st2, {k: _np(v) for k, v in t_full_st.items()})
    _close(t_y, j_y)
    _close(t_st2, j_st2)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 17, 33])
def test_linear_scan_equals_time_loop(n):
    rng = np.random.default_rng(n)
    a = torch.as_tensor(rng.uniform(0.2, 1.0, (B, n, 5)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal((B, n, 5)).astype(np.float32))
    h0 = torch.as_tensor(rng.standard_normal((B, 5)).astype(np.float32))
    got = tr._linear_scan(a, b, h0)
    h, want = h0, []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               atol=1e-6, rtol=1e-6)
