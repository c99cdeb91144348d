"""The arithmetic of the redesigned QoS and paged-prefill kernels, on the
CPU, against the JAX package's Pallas kernels run in interpret mode (as
`tests/test_qos_kernel.py` and `tests/test_paged_prefill.py` run them).
A CUDA kernel cannot run here, so these hold its plain twins in
`repro_torch.kernels.ref`:

* `qos_live_rank` — ``csrc/qos_admission.cu``'s order-free rank (each
  tenant's first-seen row, the signed ticket distance from it, a sort of
  the packed (tenant, key, row)) — gives `core.functional.live_fifo_rank`'s
  integers, and `qos_round_kernel_ref` (that rank, the closed-form spend)
  gives JAX's ``qos_round_fused`` bit for bit: tickets straddling the 2³²
  wrap, tenants with no rows, all rows dead, N not a power of two, and a
  backlog padded with dead rows or not.  Integers and correctly rounded
  f32 steps: the tolerance is 0.
* `paged_prefill_split_ref` — ``csrc/paged_prefill.cu``'s cut of the
  round's key tiles among one wave of CTAs (`paged_prefill.split_plan`),
  the per-piece partials and the log-sum-exp merge, with both products in
  f32 and as the kernel takes them (3xTF32) — against JAX's
  ``paged_prefill`` and its blockwise oracle within 2e-5 (the port's f32
  tolerance: the sums run in another order), the pools bit for bit (the
  writes are copies); and `split_plan` at the engine's shape and at edge
  shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

from repro.admission import functional_qos as jq
from repro.kernels import ref as jref
from repro.kernels.paged_prefill import paged_prefill as j_prefill
from repro.kernels.qos_admission import qos_round_fused as j_fused
from repro_torch import convert
from repro_torch.core import functional as tf
from repro_torch.core import u32
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_prefill import split_plan, tile_costs

TOL = 2e-5


def _ticketed(rng, S, N, base, idle=()):
    """Per-tenant consecutive tickets from ``base`` (rows shuffled);
    tenants in ``idle`` get no rows."""
    ids = rng.integers(0, S, N)
    for t in idle:
        ids = np.where(ids == t, (t + 1) % S, ids)
    ids = ids.astype(np.int32)
    tks = np.zeros(N, np.int64)
    nxt = np.full(S, base, np.int64)
    for i, t in enumerate(ids):
        tks[i] = nxt[t] & 0xFFFFFFFF
        nxt[t] += 1
    return ids, tks


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_qos_live_rank_matches_live_fifo_rank(seed):
    """Random tenant mixes over a few hundred rows (N rarely a power of
    two), tickets straddling 2³², idle tenants, rows alive or not."""
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 9))
    N = int(rng.integers(1, 400))
    ids, tks = _ticketed(rng, S, N, (1 << 32) - int(rng.integers(0, 200)),
                         idle=(S - 1,) if S > 2 else ())
    perm = rng.permutation(N)
    ids, tks = ids[perm], tks[perm]
    for density in (0.0, 0.7, 1.0):
        live = torch.as_tensor(rng.random(N) < density)
        args = (torch.as_tensor(ids), u32.u32(tks), live, S)
        assert torch.equal(ref.qos_live_rank(*args),
                           tf.live_fifo_rank(*args))


QOS_CASES = {
    # name: (S, N, alive density, wrap, idle tenants, free)
    "wrap": (4, 77, 0.8, True, (), 20),
    "idle-tenants": (6, 50, 0.9, False, (1, 4), 12),
    "all-dead": (3, 40, 0.0, True, (), 9),
    "odd-n": (5, 129, 0.7, True, (2,), 0),
}


def _qos_case(name):
    S, N, dens, wrap, idle, free = QOS_CASES[name]
    rng = np.random.default_rng(len(name))
    js = jq.make_qos(rng.uniform(0.0, 3.0, S).astype(np.float32),
                     table_size=64)
    base = (1 << 32) - N // 3 if wrap else 7
    ids, tks = _ticketed(rng, S, N, base, idle)
    perm = rng.permutation(N)
    ids, tks = ids[perm], tks[perm]
    js = js._replace(
        ticket=jnp.asarray((np.full(S, base) + np.bincount(ids, minlength=S))
                           & 0xFFFFFFFF, jnp.uint32),
        grant=jnp.full((S,), base & 0xFFFFFFFF, jnp.uint32),
        consumed=jnp.full((S,), base & 0xFFFFFFFF, jnp.uint32),
        dead=jnp.asarray(rng.integers(0, 3, S), jnp.uint32),
        vpass=jnp.asarray(rng.uniform(0, 2, S), jnp.float32))
    alive = rng.random(N) < dens
    dls = np.where(rng.random(N) < 0.3, rng.uniform(-1, 1, N),
                   np.inf).astype(np.float32)
    return js, ids, tks, alive, dls, free


def _same(port, want, tag):
    """Every state field, both masks and the leftover, bit for bit."""
    ps, pa, pe, pl = port
    for f in jq.QoSState._fields:
        a = getattr(ps, f).numpy()
        b = np.asarray(getattr(want[0], f))
        if b.dtype == np.float32:
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=f"{tag}: {f}")
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64),
                                          err_msg=f"{tag}: {f}")
    for x, y, what in ((pa, want[1], "admitted"), (pe, want[2], "expired"),
                       (pl, want[3], "leftover")):
        np.testing.assert_array_equal(x.numpy().astype(np.int64),
                                      np.asarray(y).astype(np.int64),
                                      err_msg=f"{tag}: {what}")


@pytest.mark.parametrize("name", sorted(QOS_CASES))
def test_qos_kernel_round_matches_jax_fused(name):
    """`qos_round_kernel_ref` — the kernel's rank and closed-form spend —
    against JAX's functional round and its Pallas ``qos_round_fused`` in
    interpret mode, bit for bit, at N as it comes; and padded with dead
    rows to the next power of two (the CPU path of `ops.qos_round`) it
    gives the same state and the same masks on the real rows."""
    js, ids, tks, alive, dls, free = _qos_case(name)
    mu = 16
    jin = tuple(jnp.asarray(x) for x in (ids, tks.astype(np.uint32), alive,
                                         dls))
    want_f = jq.qos_round(js, *jin, 0.0, free, mu)
    want_k = j_fused(js, *jin, 0.0, free, max_units=mu, block_n=16,
                     interpret=True)
    ts = convert.qos_from_jax(js, device="cpu")
    tin = (torch.as_tensor(ids), u32.u32(tks), torch.as_tensor(alive),
           torch.as_tensor(dls))
    got = ref.qos_round_kernel_ref(ts, *tin, 0.0, free, mu)
    _same(got, want_f, "vs JAX functional")
    _same(got, want_k, "vs JAX Pallas")
    n, pad = len(ids), 256 - len(ids)
    padded = (torch.cat([tin[0], torch.zeros(pad, dtype=torch.int32)]),
              torch.cat([tin[1], torch.zeros(pad, dtype=torch.int64)]),
              torch.cat([tin[2], torch.zeros(pad, dtype=torch.bool)]),
              torch.cat([tin[3], torch.full((pad,), torch.inf)]))
    gp = ref.qos_round_kernel_ref(ts, *padded, 0.0, free, mu)
    _same((gp[0], gp[1][:n], gp[2][:n], gp[3]), want_k, "padded")
    assert not gp[1][n:].any() and not gp[2][n:].any()
    _same(ops.qos_round(ts, *tin, 0.0, free, max_units=mu), want_k,
          "ops (CPU, padded)")


def _prefill_args(seed, S, CT, H, KV, hd, BS, MB, offs, lens, holes=False):
    """Numpy inputs: ragged offsets and lengths, a permuted table, -1
    past each slot's blocks (and, with ``holes``, -1 in the prior range of
    one slot: read as block 0)."""
    rng = np.random.default_rng(seed)
    need = sum(-(-int(o + n) // BS) for o, n in zip(offs, lens))
    NB = need + 4
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    tbl = np.full((S, MB), -1, np.int32)
    perm, p = rng.permutation(NB), 0
    for s in range(S):
        nb = -(-int(offs[s] + lens[s]) // BS)
        tbl[s, :nb] = perm[p:p + nb]
        p += nb
    if holes:
        tbl[S - 1, 0] = -1
    return (f(S, CT, H, hd), f(S, CT, KV, hd), f(S, CT, KV, hd),
            f(NB, BS, KV, hd), f(NB, BS, KV, hd), tbl,
            np.asarray(offs, np.int32), np.asarray(lens, np.int32))


PREFILL_CASES = {
    # name: (H, KV, BS, MB, offs, lens, grid, holes)
    # short slots beside long ones: pieces whose keys a row cannot see
    "masked-pieces": (1, 1, 4, 16, [0, 3, 40, 9], [5, 8, 8, 0], 5, False),
    # an idle slot, chunks across block edges, GQA group 2
    "gqa-block-edges": (4, 2, 4, 12, [6, 13, 0, 22], [0, 7, 8, 3], 4,
                        False),
    # a -1 entry in the prior range (block 0), a group of 3
    "holes-g3": (3, 1, 8, 8, [17, 30, 2, 9], [8, 4, 6, 8], 4, True),
    # more CTAs than key tiles: every tile whole on one CTA
    "wide-grid": (2, 2, 4, 10, [5, 0, 11, 20], [8, 8, 1, 0], 132, False),
}


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
def test_split_prefill_matches_jax_prefill(name):
    """Per-piece partials and the log-sum-exp merge, in f32 and in
    3xTF32, against JAX's Pallas ``paged_prefill`` in interpret mode and
    its blockwise oracle within 2e-5; pools bit-equal; a piece a row does
    not see carries (−inf, 0, 0) for it; idle slots output 0."""
    H, KV, BS, MB, offs, lens, grid, holes = PREFILL_CASES[name]
    S, CT, hd = 4, 8, 8
    args = _prefill_args(len(name), S, CT, H, KV, hd, BS, MB, offs, lens,
                         holes)
    jargs = tuple(jnp.asarray(x) for x in args)
    pallas = [np.asarray(x) for x in j_prefill(*jargs, interpret=True)]
    oracle = [np.asarray(x) for x in jref.paged_prefill_ref(*jargs)]
    targs = tuple(torch.as_tensor(x) for x in args)
    for einsum in (torch.einsum, ref.einsum_3xtf32):
        out, kp, vp, parts = ref.paged_prefill_split_ref(
            *targs, grid, einsum=einsum)
        for want in (pallas, oracle):
            np.testing.assert_allclose(out.numpy(), want[0], atol=TOL,
                                       rtol=TOL)
            np.testing.assert_array_equal(kp.numpy(), want[1])
            np.testing.assert_array_equal(vp.numpy(), want[2])
        cut = [p for p in parts if p[0][4] is not None]
        assert bool(cut) == (grid < 132)
        masked = 0
        for _, m, l, acc in parts:
            empty = torch.isinf(m)
            assert not l[empty].any() and not acc[empty].any()
            assert bool((m[empty] < 0).all())
            masked += int(empty.any())
        assert masked
        for s in range(S):
            if lens[s] == 0:
                assert not out[s].any()
    np.testing.assert_array_equal(targs[3].numpy(), args[3])


def _check_plan(costs, grid):
    """Every key tile on exactly one CTA, the CTAs' loads within one of
    each other, a cut tile's partials in distinct (CTA, slot) places."""
    pieces = split_plan(costs, grid)
    seen, places, load = {}, set(), {}
    for t, k0, k1, b, slot in pieces:
        assert 0 <= k0 < k1 <= costs[t] and 0 <= b < grid
        seen.setdefault(t, []).append((k0, k1))
        load[b] = load.get(b, 0) + k1 - k0
        if slot is not None:
            assert (b, slot) not in places
            places.add((b, slot))
    for t, c in enumerate(costs):
        runs = sorted(seen.get(t, []))
        assert sum(k1 - k0 for k0, k1 in runs) == c
        assert all(x[1] == y[0] for x, y in zip(runs, runs[1:]))
    if load:
        assert max(load.values()) - min(load.values()) <= 1
        assert len(load) == min(sum(costs), grid)
    return pieces


def test_prefill_split_plan_at_the_engine_shape():
    """The chunked engine's round: S=256 slots, 64-row chunk windows,
    H=KV=1 (16-row tiles), a 72 × 16 table, 32 active slots at offsets up
    to 960, one wave of 132 CTAs: 1024 tiles, ~128 of them active, every
    CTA within one key tile of W / 132, the long tiles cut in pieces."""
    rng = np.random.default_rng(0)
    S, CT, BS, MB = 256, 64, 16, 72
    offs = np.zeros(S, np.int64)
    lens = np.zeros(S, np.int64)
    act = rng.choice(S, 32, replace=False)
    offs[act] = rng.integers(0, 961, 32)
    lens[act] = rng.integers(1, CT + 1, 32)
    costs, R = tile_costs(offs, lens, CT, 1, 1, BS, MB)
    assert R == 16 and len(costs) == S * CT // R
    pieces = _check_plan(costs, 132)
    assert any(p[4] is not None for p in pieces)
    assert len(pieces) <= sum(c > 0 for c in costs) + 132


@pytest.mark.parametrize("costs,grid", [
    ([0] * 8, 132),               # all idle: no piece
    ([5], 1),                     # one tile, one CTA
    ([70], 132),                  # one tile over 70 CTAs
    ([3, 0, 1, 0, 2], 132),       # fewer key tiles than CTAs
    ([9, 9, 9, 9], 5),            # cuts at both ends of a CTA's range
    ([1] * 300, 7)])              # many one-key-tile tiles a CTA
def test_prefill_split_plan_edges(costs, grid):
    _check_plan(costs, grid)


@pytest.mark.parametrize("grid", [1, 2, 6])
def test_prefill_split_twin_matches_the_oracle(grid):
    """At a 40-row chunk window over an 80-block table (G = 2, eight-row
    tiles), the split reference cut for 1, 2 and 6 CTAs agrees with the
    unsplit oracle within 2e-5, pools bit-equal."""
    S, CT, H, KV, hd, BS, MB = 3, 40, 2, 1, 8, 8, 80
    offs, lens = [600, 13, 0], [40, 27, 0]
    args = _prefill_args(grid, S, CT, H, KV, hd, BS, MB, offs, lens)
    targs = tuple(torch.as_tensor(x) for x in args)
    out, kp, vp, _ = ref.paged_prefill_split_ref(*targs, grid)
    want_o, want_k, want_v = ref.paged_prefill_ref(*targs)
    torch.testing.assert_close(out, want_o, atol=TOL, rtol=TOL)
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)
