"""The port's multi-tenant QoS admission (`repro_torch.admission.
functional_qos`) and its kernel dispatch (`repro_torch.kernels.ops`, plain
path on the CPU) against the JAX package: the functional round and the
interpret-mode Pallas kernel `qos_round_fused` / `qos_round_scan`.
Bit-equal across tenant mixes, all-dead backlogs, zero free units, zero
weights and the 2³² ticket wrap.  An engine past the one-CTA kernel's
limits, its rounds routed as on the card through the kernels' CPU twins,
is served, every round bit-equal to JAX's."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.admission import functional_qos as jq
from repro.kernels.qos_admission import qos_round_fused as j_fused
from repro.kernels.qos_admission import qos_round_scan as j_scan
from repro_torch import convert
from repro_torch.admission import functional_qos as tq
from repro_torch.core import u32
from repro_torch.kernels import ops, qos_admission
from repro_torch.kernels import ref as tref

CASES = {
    # name: (seed, weights, alive density, expire density, free, wrap)
    "mix3": (1, [4.0, 2.0, 1.0], 0.8, 0.4, 9, False),
    "mix5-wrap": (2, [1.0, 3.0, 0.5, 2.0, 1.0], 0.7, 0.3, 14, True),
    "all-dead": (3, [2.0, 1.0], 0.0, 0.0, 7, False),
    "zero-free": (4, [2.0, 1.0, 1.0], 0.9, 0.2, 0, True),
    "zero-weight": (5, [0.0, 0.0, 2.0], 1.0, 0.0, 10, False),
}


def _eq(port, ref, msg=""):
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    b = np.asarray(ref)
    if b.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype ==
                                      np.float32 else a, b.view(np.int32),
                                      err_msg=msg)
    else:
        np.testing.assert_array_equal(a.astype(np.int64),
                                      b.astype(np.int64), err_msg=msg)


def _state_eq(port, ref, tag=""):
    for f in jq.QoSState._fields:
        _eq(getattr(port, f), getattr(ref, f), f"{tag}:{f}")


def _case(name, N=40, T=64):
    seed, weights, dens, exp, free, wrap = CASES[name]
    rng = np.random.default_rng(seed)
    S = len(weights)
    js = jq.make_qos(weights, table_size=T)
    base = np.uint32((1 << 32) - 13) if wrap else np.uint32(0)
    js = js._replace(
        ticket=jnp.full((S,), base, jnp.uint32),
        grant=jnp.full((S,), base, jnp.uint32),
        consumed=jnp.full((S,), base, jnp.uint32),
        dead=jnp.asarray(rng.integers(0, 3, S), jnp.uint32),
        vpass=jnp.asarray(rng.uniform(0, 2, S), jnp.float32))
    ids = rng.integers(0, S, N).astype(np.int32)
    dls = np.where(rng.random(N) < exp, rng.uniform(-1, 1, N),
                   np.inf).astype(np.float32)
    ts = convert.qos_from_jax(js, device="cpu")
    js, jt, jb, je = jq.qos_take(js, jnp.asarray(ids), jnp.ones(N, bool))
    ts, tt, tb, te = tq.qos_take(ts, torch.as_tensor(ids),
                                 torch.ones(N, dtype=torch.bool))
    _state_eq(ts, js, "take")
    for p, r in ((tt, jt), (tb, jb), (te, je)):
        _eq(p, r, "take outputs")
    alive = rng.random(N) < dens
    return js, ts, ids, np.asarray(jt), alive, dls, free


@pytest.mark.parametrize("name", sorted(CASES))
def test_take_stride_replenish_gate_match_jax(name):
    js, ts, ids, tks, alive, dls, free = _case(name)
    S = js.ticket.shape[0]
    rng = np.random.default_rng(7)
    unmet = rng.integers(0, 9, S).astype(np.int32)
    for mu in (4, 16):
        _eq(tq.stride_alloc(ts.vpass, ts.weight, torch.as_tensor(unmet),
                            torch.tensor(free, dtype=torch.int32), mu),
            jq.stride_alloc(js.vpass, js.weight, jnp.asarray(unmet), free,
                            mu), f"stride_alloc mu={mu}")
    depth = rng.integers(0, 12, S).astype(np.int32)
    js2, ja, jl = jq.qos_replenish(js, free, jnp.asarray(depth), 16)
    ts2, ta, tl = tq.qos_replenish(ts, free, torch.as_tensor(depth), 16)
    _state_eq(ts2, js2, "replenish")
    _eq(ta, ja)
    _eq(tl, jl)
    demand = rng.integers(1, 5, len(ids)).astype(np.int32)
    key = rng.permutation(len(ids)).astype(np.int32)
    commit = rng.integers(1, 9, len(ids)).astype(np.int32)
    for fb, head, cfree, boot in ((0, 0, 0, False), (6, 0, 0, False),
                                  (40, 3, 12, False), (40, 0, 0, True)):
        kw = dict(commit_free=cfree, commit_bootstrap=boot) if cfree or boot \
            else {}
        _eq(tq.block_gate(torch.as_tensor(alive), torch.as_tensor(demand),
                          torch.as_tensor(key), fb, head,
                          torch.as_tensor(commit) if kw else None, **kw),
            jq.block_gate(jnp.asarray(alive), jnp.asarray(demand),
                          jnp.asarray(key), fb, head,
                          jnp.asarray(commit) if kw else None, **kw),
            f"block_gate free={fb} headroom={head} commit={kw}")
    rem = rng.integers(0, 9, 6).astype(np.int32)
    held = rng.integers(0, 5, 6).astype(np.int32)
    order = rng.permutation(6).astype(np.int32)
    act = rng.random(6) < 0.7
    _eq(tq.block_headroom(*map(torch.as_tensor, (rem, held, order, act))),
        jq.block_headroom(*map(jnp.asarray, (rem, held, order, act))),
        "block_headroom")


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_functional_and_kernel_dispatch_match_jax(name):
    """functional `qos_round`, `qos_scan_round`, and `ops.qos_round` on the
    CPU (the kernel's plain path) against JAX's functional round and the
    interpret-mode Pallas kernel: every state field, both masks, the
    leftover."""
    js, ts, ids, tks, alive, dls, free = _case(name)
    mu = 16
    jin = (jnp.asarray(ids), jnp.asarray(tks), jnp.asarray(alive),
           jnp.asarray(dls))
    tin = (torch.as_tensor(ids), u32.u32(tks), torch.as_tensor(alive),
           torch.as_tensor(dls))
    ref = jq.qos_round(js, *jin, 0.0, free, mu)
    ker = j_fused(js, *jin, 0.0, free, max_units=mu, block_n=16,
                  interpret=True)
    oracle = tref.qos_round_ref(ts, *tin, 0.0, free, mu)
    ports = {
        "functional": tq.qos_round(ts, *tin, 0.0, free, mu),
        "pairwise": tq.qos_round(ts, *tin, 0.0, free, mu,
                                 pairwise_rank=True),
        "ref": (oracle["state"], oracle["admitted"], oracle["expired"],
                oracle["leftover"]),
        "scan_round": tq.qos_scan_round(ts, *tin, 0.0, free - 2, 2, mu),
        "ops": ops.qos_round(ts, *tin, 0.0, free, max_units=mu, block_n=16),
    }
    for tag, (ps, pa, pe, pl) in ports.items():
        for j, jtag in ((ref, "jax-functional"), (ker, "jax-pallas")):
            _state_eq(ps, j[0], f"{tag} vs {jtag}")
            _eq(pa, j[1], f"{tag} admitted vs {jtag}")
            _eq(pe, j[2], f"{tag} expired vs {jtag}")
            _eq(pl, j[3], f"{tag} leftover vs {jtag}")


@pytest.mark.parametrize("name", ["mix3", "mix5-wrap", "zero-weight"])
def test_round_scan_matches_jax_kernel_scan(name):
    """`ops.qos_round_scan` (plain path) == the interpret-mode Pallas
    `qos_round_scan` over K rounds with released units and moving time."""
    js, ts, ids, tks, alive, dls, free = _case(name)
    K, mu = 5, 8
    nows = np.linspace(-0.5, 1.0, K).astype(np.float32)
    released = np.asarray([0, 1, 0, 2, 1], np.int32)
    jst, jar, jer, jfree = j_scan(
        js, jnp.asarray(ids), jnp.asarray(tks), jnp.asarray(alive),
        jnp.asarray(dls), jnp.asarray(nows), free, jnp.asarray(released),
        max_units=mu, block_n=16, interpret=True)
    tst, tar, ter, tfree = ops.qos_round_scan(
        ts, torch.as_tensor(ids), u32.u32(tks), torch.as_tensor(alive),
        torch.as_tensor(dls), torch.as_tensor(nows), free,
        torch.as_tensor(released), max_units=mu, block_n=16)
    _state_eq(tst, jst, "scan")
    _eq(tar, jar, "admit_round")
    _eq(ter, jer, "expire_round")
    _eq(tfree, jfree, "free")


def _j_state(ts):
    """A port QoS state as the JAX package's (u32 carriers as uint32)."""
    return jq.QoSState(*[jnp.asarray(u32.to_numpy(x)) if x.dtype ==
                         torch.int64 else jnp.asarray(x.numpy()) for x in ts])


def card_route(monkeypatch):
    """Route the port's QoS kernel rounds as on the card: `ops` passes CPU
    tensors to the wrapper, and the wrapper runs as the CPU twin of the
    path it takes — `ref.qos_round_large_ref` past the one-CTA kernel's
    limits (`qos_admission.large_path`), else `ref.qos_round_kernel_ref`.
    Returns the list each round's inputs, outputs and path (True: large)
    are appended to."""
    seen = []

    def card_round(state, ids, tks, alive, dls, now, free, *, max_units):
        large = qos_admission.large_path(ids.shape[0], state.ticket.shape[0])
        twin = (tref.qos_round_large_ref if large
                else tref.qos_round_kernel_ref)
        out = twin(state, ids, tks, alive, dls, now, free, max_units)
        seen.append(((state, ids, tks, alive, dls, now, free, max_units),
                     out, large))
        return out

    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(qos_admission, "qos_round_fused", card_round)
    return seen


def assert_rounds_match_jax(seen):
    """Each round `card_route` recorded (its twin's outputs) is bit-equal
    to JAX's jitted `functional_qos.qos_round` on the same inputs."""
    import jax

    j_round = jax.jit(jq.qos_round, static_argnames=("max_units",))
    for (st, ids, tks, alive, dls, now, free, mu), out, _ in seen:
        want = j_round(_j_state(st), jnp.asarray(ids.numpy()),
                       jnp.asarray(u32.to_numpy(tks)),
                       jnp.asarray(alive.numpy()), jnp.asarray(dls.numpy()),
                       jnp.asarray(np.float32(now)),
                       jnp.asarray(np.int32(free)), max_units=mu)
        _state_eq(out[0], want[0], "card round")
        for g, w, tag in zip(out[1:], want[1:],
                             ("admitted", "expired", "leftover")):
            _eq(g, w, f"card round {tag}")


@pytest.mark.parametrize("limit", ["tenants", "rows"])
def test_card_kernel_limits_refused_at_construction(limit, monkeypatch):
    """Past the one-CTA kernel's limits — more than `MAX_TENANTS` tenants,
    or a megastep backlog (``max(next_pow2(max(n, n_slots)), 8)`` rows
    for ``n`` live rows, at most ``backlog_cap``) of more than `MAX_ROWS`
    rows, by the backlog or by the slots — a QoS engine with
    ``use_kernel`` is no longer refused: on the card such rounds take the
    kernel's large path.  Each engine is built with its kernel rounds
    routed as on the card (`card_route`); a megastep over a burst admits
    through the large path, and every round it served is bit-equal to
    JAX's round on the same inputs."""
    from repro_torch.serving import scheduler

    assert not hasattr(qos_admission, "check_engine_limits")
    M = qos_admission.MAX_ROWS
    # (tenants, backlog_cap, n_slots)
    if limit == "tenants":
        past = [(qos_admission.MAX_TENANTS + 1, 64, 8)]
    else:
        past = [(3, M + 1, 8), (3, 64, M + 1)]
    seen = card_route(monkeypatch)
    for n, cap, slots in past:
        names = [f"t{i}" for i in range(n)]
        eng = scheduler.ContinuousBatchingEngine(
            None, None, slots,
            tenants={t: float(1 + i % 3) for i, t in enumerate(names)},
            use_kernel=True, backlog_cap=cap, device="cpu")
        assert eng.qos.ticket.shape == (n,)
        n_req = max(40, min(cap, M + 1))
        eng.submit_batch([scheduler.Request(
            rid=i, prompt=[1], max_new_tokens=2, tenant_id=names[i % n])
            for i in range(n_req)])
        seen.clear()
        eng.megastep(2)
        assert seen and all(large for *_, large in seen)
        assert eng.stats.admitted >= min(n_req, slots)
        assert_rounds_match_jax(seen)
