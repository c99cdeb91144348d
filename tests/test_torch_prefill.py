"""The port's chunked-prefill planner and waiting-array park/wake
(`repro_torch.serving.prefill`, `repro_torch.core.functional`) against the
JAX package on the same inputs, bit for bit: `banker_order`, `chunk_plan`
over random busy / parked / woken / copy-on-write / privately-held
inputs, the first-chunk demands, `pool_try_alloc`, `park_state` and
`pool_incref` (including across the 2³² counter wrap), plus the mirrors
of tests/test_chunked_prefill.py::test_pool_try_alloc_park_and_wake and
tests/test_prefix_cache.py::test_pool_incref_is_semaphore_silent."""

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

from repro.core import functional as jf
from repro.serving import prefill as jp
from repro_torch import convert
from repro_torch.core import functional as tf
from repro_torch.core import u32
from repro_torch.serving import prefill as tp


def _eq(port, ref, msg=""):
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    np.testing.assert_array_equal(a.astype(np.int64),
                                  np.asarray(ref).astype(np.int64),
                                  err_msg=msg)


def _slots(rng, S, BS):
    """A random engine-like slot population: busy slots mid-prefill or
    decoding with consistent held counts, some parked, ties in the
    priority keys."""
    busy = rng.random(S) < 0.8
    plen = rng.integers(1, 40, S).astype(np.int32)
    max_new = rng.integers(1, 20, S).astype(np.int32)
    pos = np.minimum(rng.integers(0, 60, S), plen + max_new - 1).astype(
        np.int32)
    held = -(-pos // BS) + rng.integers(0, 2, S) * (pos % BS == 0)
    held = np.where(busy, held, 0).astype(np.int32)
    parked = busy & (rng.random(S) < 0.3)
    woken = rng.random(S) < 0.5
    prio_r = rng.integers(0, 4, S).astype(np.int32)
    prio_k = rng.integers(-5, 5, S).astype(np.int32)
    cow = busy & (pos >= plen) & (pos < held * BS) & (rng.random(S) < 0.3)
    held_free = np.minimum(held, rng.integers(0, 4, S)).astype(np.int32)
    return dict(busy=busy, plen=plen, max_new=max_new, pos=pos, held=held,
                parked=parked, woken=woken, prio_r=prio_r, prio_k=prio_k,
                cow=cow, held_free=held_free)


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_banker_order_and_chunk_plan_match_jax(seed):
    rng = np.random.default_rng(seed)
    S, BS = 12, 4
    x = _slots(rng, S, BS)
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: torch.as_tensor(v) for k, v in x.items()}
    rem = (np.maximum(-(-(x["plen"] + x["max_new"]) // BS), 1) - x["held"])
    rem = np.where(x["busy"], rem, 0).astype(np.int32)
    jo = jp.banker_order(jnp.asarray(rem), J["prio_r"], J["prio_k"],
                         J["busy"])
    to = tp.banker_order(torch.as_tensor(rem), T["prio_r"], T["prio_k"],
                         T["busy"])
    _eq(to, jo, "banker_order")
    for free, chunk, budget in ((int(rng.integers(0, 12)), 5, 9),
                                (int(rng.integers(0, 3)), 3, 4),
                                (30, 8, 64)):
        for sharing in (False, True):
            cow = x["cow"] if sharing else np.zeros(S, bool)
            hf = x["held_free"] if sharing else x["held"]
            jplan = jp.chunk_plan(
                jo, J["busy"], J["parked"], J["woken"], J["pos"], J["plen"],
                J["max_new"], J["held"], free, jnp.asarray(cow),
                jnp.asarray(hf), chunk=chunk, budget=budget, block_size=BS)
            tplan = tp.chunk_plan(
                to, T["busy"], T["parked"], T["woken"], T["pos"], T["plen"],
                T["max_new"], T["held"], free, torch.as_tensor(cow),
                torch.as_tensor(hf), chunk=chunk, budget=budget,
                block_size=BS)
            for f in jp.ChunkPlan._fields:
                _eq(getattr(tplan, f), getattr(jplan, f),
                    f"{f} free={free} chunk={chunk} sharing={sharing}")


def test_first_chunk_demands_match_jax():
    rng = np.random.default_rng(5)
    plen = rng.integers(0, 70, 64).astype(np.int32)
    cov = np.where(rng.random(64) < 0.5, (plen // 4) * 4,
                   np.minimum(plen, rng.integers(0, 70, 64))).astype(np.int32)
    cov[:4] = plen[:4]                      # full covers, aligned or not
    for chunk, BS in ((5, 4), (16, 16), (64, 16)):
        _eq(tp.first_chunk_demand(torch.as_tensor(plen), chunk, BS),
            jp.first_chunk_demand(jnp.asarray(plen), chunk, BS))
        _eq(tp.shared_first_chunk_demand(torch.as_tensor(plen),
                                         torch.as_tensor(cov), chunk, BS),
            jp.shared_first_chunk_demand(jnp.asarray(plen), jnp.asarray(cov),
                                         chunk, BS))
        _eq(tp.shared_first_chunk_demand(torch.as_tensor(plen),
                                         torch.zeros(64, dtype=torch.int32),
                                         chunk, BS),
            jp.first_chunk_demand(jnp.asarray(plen), chunk, BS))


@pytest.mark.parametrize("start", [0, (1 << 32) - 3])
def test_pool_try_alloc_park_state_incref_match_jax(start):
    """Takes, parks (bucket and observed sequence of the wake ticket),
    increfs and releases in turn, the pool compared field by field."""
    rng = np.random.default_rng(start & 0xFF)
    NB = 16
    jpool = jf.make_block_pool(NB, start=start)
    tpool = tf.make_block_pool(NB, start=start, device="cpu")
    held = []
    for i in range(6):
        free = int(jf.pool_free_count(jpool))
        counts = np.minimum(rng.integers(0, 3, 4), free // 4).astype(np.int32)
        park = rng.random(4) < 0.5
        deficit = rng.integers(0, 5, 4).astype(np.int32)
        jpool, jids, jb, js = jf.pool_try_alloc(
            jpool, jnp.asarray(counts), 3, park=jnp.asarray(park),
            deficit=jnp.asarray(deficit))
        tpool, tids, tb, ts = tf.pool_try_alloc(
            tpool, torch.as_tensor(counts), 3, park=torch.as_tensor(park),
            deficit=torch.as_tensor(deficit))
        for p, r, f in ((tids, jids, "ids"), (tb, jb, "bucket"),
                        (ts, js, "seq")):
            _eq(p, r, f"{f} round {i}")
        d = np.maximum(deficit, 1)
        jb2, js2 = jf.park_state(jpool.sema, jnp.asarray(d))
        tb2, ts2 = tf.park_state(tpool.sema, torch.as_tensor(d))
        _eq(tb2, jb2, "park_state bucket")
        _eq(ts2, js2, "park_state seq")
        share = (np.asarray(jids) >= 0) & (rng.random((4, 3)) < 0.5)
        jpool = jf.pool_incref(jpool, jids, jnp.asarray(share))
        tpool = tf.pool_incref(tpool, tids, torch.as_tensor(share))
        held.append((jids, tids))
        if i % 2:
            (jr, tr), mask = held.pop(0), rng.random(4) < 0.7
            jpool = jf.pool_release(jpool, jr, jnp.asarray(mask))
            tpool = tf.pool_release(tpool, tr, torch.as_tensor(mask))
        for f, v in convert.to_numpy(tpool).items():
            ref = jpool
            for part in f.split("."):
                ref = getattr(ref, part)
            _eq(torch.as_tensor(v.astype(np.int64)), ref, f"{f} round {i}")


def test_pool_try_alloc_park_and_wake():
    """A parked row's waiting-array bucket moves exactly when enough
    releases landed to cover its deficit (the mirror of the reference's
    test of the same name)."""
    pool = tf.make_block_pool(8, device="cpu")
    pool, ids, _, _ = tf.pool_try_alloc(
        pool, torch.tensor([6, 0]), 6, park=torch.tensor([False, False]),
        deficit=torch.tensor([0, 0]))
    assert int(tf.pool_free_count(pool)) == 2
    pool2, _, bkt, seq = tf.pool_try_alloc(
        pool, torch.tensor([0, 0]), 6, park=torch.tensor([False, True]),
        deficit=torch.tensor([0, 3]))
    assert int(tf.pool_free_count(pool2)) == 2
    pool3 = tf.pool_release(pool2, ids[:1, :2], torch.tensor([True]))
    assert not bool(tf.woken_mask(pool3.sema, seq[1:], bkt[1:])[0])
    pool4 = tf.pool_release(pool3, ids[:1, 2:3], torch.tensor([True]))
    assert bool(tf.woken_mask(pool4.sema, seq[1:], bkt[1:])[0])


def test_pool_incref_is_semaphore_silent():
    """Attaching a sharer moves no counter and pokes no bucket; a release
    frees only at refcount 0 (the mirror of the reference's test)."""
    pool = tf.make_block_pool(8, device="cpu")
    pool, ids, _, _ = tf.pool_try_alloc(
        pool, torch.tensor([2]), 2, park=torch.tensor([False]),
        deficit=torch.tensor([0]))
    before = (pool.sema.ticket.clone(), pool.sema.grant.clone(),
              pool.sema.bucket_seq.clone())
    pool = tf.pool_incref(pool, ids[0], torch.ones(2, dtype=torch.bool))
    assert torch.equal(pool.sema.ticket, before[0])
    assert torch.equal(pool.sema.grant, before[1])
    assert torch.equal(pool.sema.bucket_seq, before[2])
    assert pool.refcnt[ids[0].long()].tolist() == [2, 2]
    pool = tf.pool_release(pool, ids, torch.tensor([True]))
    assert int(tf.pool_free_count(pool)) == 6
    pool = tf.pool_release(pool, ids, torch.tensor([True]))
    assert int(tf.pool_free_count(pool)) == 8
    assert u32.to_numpy(pool.gen)[ids[0].numpy()].tolist() == [1, 1]
