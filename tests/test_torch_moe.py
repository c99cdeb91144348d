"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
(`repro.models.moe`) on the same parameters (carried across by
`convert.params_from_jax`) and the same seeded numpy inputs, f32 with
TF32 off:

* ``moe_forward`` on the granite-moe smoke config (40 → 8 experts padded
  to 48: E_pad > E) and the deepseek-moe smoke config (shared experts),
  each at ``capacity_factor`` 1.25 and 0.5 (assignments overflow):
  output within 1e-5, ``lb_loss``, ``z_loss`` and ``overflow_frac``
  within 1e-6;
* the routing and the semaphore admission alone: the port's ``route``
  picks the experts of ``jax.lax.top_k`` on the same logits, and its
  ``admit`` (the port's ``take_batch_multi``) gives the tickets (buffer
  slots) and the ``admitted`` mask of JAX's ``take_batch_multi`` bit for
  bit, with and without overflow;
* the capacity formula, and the combine's order: a token's k
  assignments summed in rank order, the same result on every call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_smoke
from repro.core import functional as jf
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.core import u32
from repro_torch.models import moe as tmoe

torch.backends.cuda.matmul.allow_tf32 = False

CASES = [(a, cf) for a in ("granite-moe-3b-a800m", "deepseek-moe-16b")
         for cf in (1.25, 0.5)]


def _setup(arch, seed=0, B=3, S=20):
    cfg = j_smoke(arch)
    p = jmoe.init_moe(jax.random.PRNGKey(seed), cfg.d_model, cfg.n_experts,
                      cfg.d_expert, cfg.top_k, cfg.n_shared, cfg.d_shared,
                      jnp.float32, n_experts_pad=cfg.n_experts_pad)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def _jax_admission(p, x, top_k, capacity_factor):
    """The reference's routing and admission on x (G = 1)."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = jnp.einsum("nd,de->ne", xt, p["router"])
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    E = p["router"].shape[-1]
    N = xt.shape[0]
    cap = int(max(top_k, round(N * top_k / E * capacity_factor)))
    sema = jf.make_multi_sema(jnp.full((E,), cap, jnp.uint32))
    flat = gate_idx.reshape(-1)
    _, tickets, admitted = jf.take_batch_multi(
        sema, flat, jnp.ones(flat.shape, bool))
    return (np.asarray(gate_idx), np.asarray(tickets), np.asarray(admitted),
            cap)


@pytest.mark.parametrize("arch,cf", CASES)
def test_moe_forward_matches_jax(arch, cf):
    cfg, p, x = _setup(arch)
    assert p["wi"].shape[0] == max(cfg.n_experts, cfg.n_experts_pad)
    jout, jaux = jmoe.moe_forward(p, jnp.asarray(x), top_k=cfg.top_k,
                                  capacity_factor=cf)
    tp = convert.params_from_jax(p, device="cpu")
    tout, taux = tmoe.moe_forward(tp, torch.as_tensor(x), top_k=cfg.top_k,
                                  capacity_factor=cf)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    if cf < 1:
        assert float(taux["overflow_frac"]) > 0
    if arch.startswith("granite"):
        assert cfg.n_experts_pad > cfg.n_experts
    else:
        assert "shared" in tp


@pytest.mark.parametrize("arch,cf", CASES)
def test_routing_and_admission_bit_equal(arch, cf):
    """Experts, tickets (the buffer slots) and ``admitted`` equal JAX's
    ``top_k`` and ``take_batch_multi`` on the same logits."""
    cfg, p, x = _setup(arch, seed=3, B=4, S=16)
    j_idx, j_tk, j_adm, cap = _jax_admission(p, x, cfg.top_k, cf)
    tp = convert.params_from_jax(p, device="cpu")
    xt = torch.as_tensor(x).reshape(-1, cfg.d_model)
    _, _, _, t_idx = tmoe.route(tp, xt, cfg.top_k)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    assert tmoe.capacity_of(xt.shape[0], cfg.top_k, cfg.n_experts, cf) == cap
    t_tk, t_adm = tmoe.admit(t_idx.reshape(1, -1), cfg.n_experts, cap)
    np.testing.assert_array_equal(u32.to_numpy(t_tk[0]), j_tk)
    np.testing.assert_array_equal(t_adm[0].numpy(), j_adm)
    # FCFS: an expert admits its first `cap` assignments in token order
    flat = j_idx.reshape(-1)
    for e in np.unique(flat):
        rows = np.flatnonzero(flat == e)
        np.testing.assert_array_equal(j_tk[rows], np.arange(len(rows)))
        np.testing.assert_array_equal(j_adm[rows], np.arange(len(rows)) < cap)
    assert j_adm.all() == (cf > 1)


def test_capacity_formula():
    """Python's rounding, the top_k floor, and the decode shapes of the
    full configs: granite (8 slots, top-8 of 40) and deepseek (8 slots,
    top-6 of 64) both take 6–8 slots an expert."""
    assert tmoe.capacity_of(8, 8, 40, 1.25) == 8
    assert tmoe.capacity_of(8, 6, 64, 1.25) == 6
    assert tmoe.capacity_of(1024, 8, 40, 1.25) == 256
    assert tmoe.capacity_of(20, 2, 8, 1.25) == round(6.25) == 6
    assert tmoe.capacity_of(4, 2, 8, 1.25) == 2


def test_combine_is_repeatable():
    """A call twice on the same inputs gives the same bits (the k terms
    sum in rank order, no scatter-add)."""
    cfg, p, x = _setup("granite-moe-3b-a800m", seed=5, B=8, S=1)
    tp = convert.params_from_jax(p, device="cpu")
    a, _ = tmoe.moe_forward(tp, torch.as_tensor(x), top_k=cfg.top_k)
    b, _ = tmoe.moe_forward(tp, torch.as_tensor(x), top_k=cfg.top_k)
    assert torch.equal(a, b)


def test_idle_decode_rows_take_live_rows_capacity_both_sides():
    """A reference fault the port keeps (ROADMAP queue 3): at a decode
    step every one of the B slots' tokens competes for expert capacity
    in row order, idle slots included, so a live row's output depends on
    what the idle rows hold.  Deepseek-moe's smoke config (8 experts, top
    2, capacity factor 1.25: 2 slots an expert at B = 8), the live row
    last: with the idle rows holding other states it is admitted; with
    them holding its own state they fill its two experts first and its
    routed output is dropped (the port's admission, bit-equal to JAX's in
    `test_routing_and_admission_bit_equal`).  JAX's `moe_forward` and
    the port's agree in both cases (1e-5), and both change the live
    row."""
    cfg = j_smoke("deepseek-moe-16b")
    p = jmoe.init_moe(jax.random.PRNGKey(0), cfg.d_model, cfg.n_experts,
                      cfg.d_expert, cfg.top_k, cfg.n_shared, cfg.d_shared,
                      jnp.float32, n_experts_pad=cfg.n_experts_pad)
    tp = convert.params_from_jax(p, device="cpu")
    rng = np.random.default_rng(7)
    B, live = 8, 7
    x_live = rng.standard_normal(cfg.d_model).astype(np.float32)
    others = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    copies = np.broadcast_to(x_live, (B, 1, cfg.d_model)).copy()
    assert tmoe.capacity_of(B, cfg.top_k, cfg.n_experts,
                            cfg.capacity_factor) == 2
    jfwd = jax.jit(lambda p, x: jmoe.moe_forward(
        p, x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)[0])
    outs, dropped = {}, {}
    for name, x in (("others", others), ("copies", copies)):
        x = x.copy()
        x[live, 0] = x_live
        jout = jfwd(p, jnp.asarray(x))
        tout, _ = tmoe.moe_forward(tp, torch.as_tensor(x), top_k=cfg.top_k,
                                   capacity_factor=cfg.capacity_factor)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=1e-5, rtol=1e-5)
        outs[name] = (np.asarray(jout)[live, 0], tout.numpy()[live, 0])
        _, _, _, idx = tmoe.route(tp, torch.as_tensor(x).reshape(B, -1),
                                  cfg.top_k)
        _, adm = tmoe.admit(idx.reshape(1, -1), cfg.n_experts, 2)
        dropped[name] = not bool(adm.reshape(B, cfg.top_k)[live].any())
    assert dropped == {"others": False, "copies": True}
    for side in (0, 1):  # JAX, the port: the live row moved
        assert np.abs(outs["others"][side] - outs["copies"][side]).max() > 1e-3
