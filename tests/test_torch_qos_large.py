"""The large path of the port's QoS kernel — the round past the one-CTA
kernel's `MAX_TENANTS` tenants or `MAX_ROWS` rows — on the CPU, through
its twin `repro_torch.kernels.ref.qos_round_large_ref` (the kernel's
presort, chunked sweeps, carries, binary-search replenish and poke in the
kernel's own order), against the JAX package's jitted
`functional_qos.qos_round` on the same inputs: bit-equal at 300 tenants ×
20000 rows and at 3 tenants × 16385 rows, in the general, 2³²-wrap,
all-dead, zero-free and idle-tenant cases; the K=4 scan against the port's
`ref.qos_round_scan_ref`; and the wrapper's ticket order against
`core.functional.ticket_order` of both packages."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.admission import functional_qos as jq
from repro.core.functional import ticket_order as j_ticket_order
from repro_torch import convert
from repro_torch.core import u32
from repro_torch.core.functional import ticket_order
from repro_torch.kernels import qos_admission
from repro_torch.kernels import ref as tref

SHAPES = [(300, 20000), (3, 16385)]   # (tenants, rows): past each limit
CASES = {
    # name: (alive density, free units, tickets across 2³², idle tenants)
    "general": (0.8, 200, False, False),
    "wrap": (0.8, 200, True, False),
    "all-dead": (0.0, 200, False, False),
    "zero-free": (0.9, 0, True, False),
    "idle-tenants": (0.8, 200, False, True),
}
T, MU = 256, 256


@functools.lru_cache(maxsize=None)
def _j_round():
    return jax.jit(jq.qos_round, static_argnames=("max_units",))


def _case(S, N, name):
    """A round's inputs, built by JAX and copied to the port: per-tenant
    consecutive tickets (`qos_take`), random dead slack and virtual
    passes, a fifth of the rows with deadlines, the rows shuffled."""
    dens, free, wrap, idle = CASES[name]
    rng = np.random.default_rng(S + N + len(name))
    js = jq.make_qos(rng.uniform(0.5, 4.0, S).astype(np.float32),
                     table_size=T)
    base = (1 << 32) - N // (2 * S) if wrap else int(rng.integers(0, 1000))
    js = js._replace(
        ticket=jnp.full((S,), base, jnp.uint32),
        grant=jnp.full((S,), base, jnp.uint32),
        consumed=jnp.full((S,), base, jnp.uint32),
        dead=jnp.asarray(rng.integers(0, 4, S), jnp.uint32),
        vpass=jnp.asarray(rng.uniform(0, 3, S), jnp.float32))
    ids = rng.integers(0, S, N).astype(np.int32)
    if idle:
        ids = np.where(ids % 3 == 1, 0, ids).astype(np.int32)
    js, jt, _, _ = jq.qos_take(js, jnp.asarray(ids), jnp.ones(N, bool))
    perm = rng.permutation(N)
    ids, tks = ids[perm], np.asarray(jt)[perm]
    alive = rng.random(N) < dens
    dls = np.where(rng.random(N) < 0.2, rng.uniform(-1, 1, N),
                   np.inf).astype(np.float32)
    return js, ids, tks, alive, dls, free


def _port(js, ids, tks, alive, dls):
    return (convert.qos_from_jax(js, device="cpu"), torch.as_tensor(ids),
            u32.u32(tks), torch.as_tensor(alive), torch.as_tensor(dls))


def _eq(port, ref, msg):
    a = port.numpy()
    b = np.asarray(ref)
    if b.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=msg)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("S,N", SHAPES)
def test_large_path_twin_matches_jax(S, N, name):
    js, ids, tks, alive, dls, free = _case(S, N, name)
    assert qos_admission.large_path(N, S)
    want = _j_round()(js, jnp.asarray(ids), jnp.asarray(tks),
                      jnp.asarray(alive), jnp.asarray(dls), 0.0, free,
                      max_units=MU)
    ts, *rows = _port(js, ids, tks, alive, dls)
    got = tref.qos_round_large_ref(ts, *rows, 0.0, free, MU)
    for f in jq.QoSState._fields:
        _eq(getattr(got[0], f), getattr(want[0], f), f"state.{f}")
    for g, w, tag in zip(got[1:], want[1:],
                         ("admitted", "expired", "leftover")):
        _eq(g, w, tag)
    if name == "general":   # the round admits and expires something
        assert got[1].any() and got[2].any()


@pytest.mark.parametrize("S,N", SHAPES)
def test_large_path_scan_matches_plain_scan(S, N):
    """K=4 rounds of the twin, sorted once as the card's scan sorts (each
    round's admitted and expired rows leave the alive set, the released
    units join the pool before the replenish, the leftover carries),
    against `ref.qos_round_scan_ref`."""
    js, ids, tks, alive, dls, _ = _case(S, N, "wrap")
    ts, t_ids, t_tks, t_alive, t_dls = _port(js, ids, tks, alive, dls)
    nows = torch.linspace(-0.5, 1.0, 4)
    released = torch.tensor([0, 7, 1, 40], dtype=torch.int32)
    free = torch.tensor(24, dtype=torch.int32)
    want = tref.qos_round_scan_ref(ts, t_ids, t_tks, t_alive, t_dls, nows,
                                   free, released, MU)
    order = qos_admission._order(t_ids, t_tks, S)
    st, live = ts, t_alive
    admit_round = torch.full((N,), -1, dtype=torch.int32)
    expire_round = torch.full((N,), -1, dtype=torch.int32)
    for k in range(4):
        st, adm, exp, free = tref.qos_round_large_ref(
            st, t_ids, t_tks, live, t_dls, nows[k], free + released[k], MU,
            order=order)
        admit_round = torch.where(adm, k, admit_round)
        expire_round = torch.where(exp, k, expire_round)
        live = live & ~adm & ~exp
    for f in jq.QoSState._fields:
        a, b = getattr(st, f), getattr(want["state"], f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert torch.equal(admit_round, want["admit_round"])
    assert torch.equal(expire_round, want["expire_round"])
    assert torch.equal(free, want["free"])
    assert (admit_round >= 0).sum() > 0


@pytest.mark.parametrize("S,N", SHAPES)
def test_large_path_order_is_the_ticket_order(S, N):
    """The wrapper's presort is `core.functional.ticket_order`, the
    permutation of the engine's CPU path and of JAX's wrapper, also with
    tickets across 2³² (ties within a tenant follow its first-seen
    row); a row whose tenant id lies outside [0, S) sorts as a tenant of
    its own and leaves the others' order alone."""
    js, ids, tks, *_ = _case(S, N, "wrap")
    t_ids, t_tks = torch.as_tensor(ids), u32.u32(tks)
    order = qos_admission._order(t_ids, t_tks, S)
    assert torch.equal(order, ticket_order(t_ids, t_tks, S))
    np.testing.assert_array_equal(
        order.numpy(), np.asarray(j_ticket_order(jnp.asarray(ids),
                                                 jnp.asarray(tks), S)))
    bad = t_ids.clone()
    bad[::97] = S + 5

    def per_tenant(o):   # the kept rows, tenant by tenant, in order o
        o = o[(bad < S)[o]]
        return o[torch.argsort(t_ids[o], stable=True)]

    assert torch.equal(per_tenant(qos_admission._order(bad, t_tks, S)),
                       per_tenant(order))
