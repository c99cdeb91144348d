"""The port's u32 helpers and functional semaphore (`repro_torch.core`)
against the JAX package (`repro.core.functional`) on the same inputs:
bit-equal, including across the 2³² counter wrap."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import functional as jf
from repro_torch import convert
from repro_torch.core import functional as tf
from repro_torch.core import u32

WRAP = (1 << 32) - 5


def _eq(port, ref, msg=""):
    """Port tensor (u32 carriers as int64) == JAX array, by value."""
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    b = np.asarray(ref)
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=msg)


def _sema_eq(port, ref):
    for f in jf.SemaState._fields:
        _eq(getattr(port, f), getattr(ref, f), f)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sdist", "bits"])
def test_u32_helpers_across_the_wrap(op):
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.integers(0, 1 << 32, 64, dtype=np.uint64),
                        np.arange(WRAP, WRAP + 10, dtype=np.uint64)
                        & 0xFFFFFFFF]).astype(np.uint32)
    b = np.concatenate([rng.integers(0, 1 << 32, 64, dtype=np.uint64),
                        np.full(10, 7, np.uint64)]).astype(np.uint32)
    ta, tb = u32.u32(a), u32.u32(b)
    with np.errstate(over="ignore"):
        if op == "add":
            got, want = u32.add(ta, tb), a + b
        elif op == "sub":
            got, want = u32.sub(ta, tb), a - b
        elif op == "mul":
            got, want = u32.mul(ta, tb), a * b
        elif op == "sdist":
            got, want = u32.sdist(ta, tb), (a - b).view(np.int32)
        else:
            got, want = u32.to_bits32(ta), a.view(np.int32)
            np.testing.assert_array_equal(u32.to_numpy(u32.from_bits32(got)),
                                          a)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))


@pytest.mark.parametrize("base", [0, WRAP])
def test_take_post_poll_woken_match_jax(base):
    rng = np.random.default_rng(base & 0xFF)
    js = jf.make_sema(3, table_size=64)
    js = js._replace(ticket=js.ticket + jnp.uint32(base),
                     grant=js.grant + jnp.uint32(base))
    ts = convert.sema_from_jax(js, device="cpu")
    req = rng.random(20) < 0.7
    js2, jt, ja, jb = jf.take_batch(js, jnp.asarray(req))
    ts2, tt, ta, tb = tf.take_batch(ts, torch.as_tensor(req))
    _sema_eq(ts2, js2)
    for p, r in ((tt, jt), (ta, ja), (tb, jb)):
        _eq(p, r)
    observed = np.asarray(js2.bucket_seq)[np.asarray(jb)]
    for n in (0, 5, 70):
        js2, ts2 = jf.post_batch(js2, n), tf.post_batch(ts2, n)
        _sema_eq(ts2, js2)
    _eq(tf.woken_mask(ts2, u32.u32(observed), tb),
        jf.woken_mask(js2, jnp.asarray(observed), jb))
    _eq(tf.poll(ts2, tt), jf.poll(js2, jt))


@pytest.mark.parametrize("start", [0, (1 << 32) - 3])
def test_block_pool_alloc_release_match_jax(start):
    rng = np.random.default_rng(start & 0xFF)
    NB = 16
    jp = jf.make_block_pool(NB, start=start)
    tp = tf.make_block_pool(NB, start=start, device="cpu")
    for i in range(6):
        counts = rng.integers(0, 3, 4).astype(np.int32)
        counts = np.minimum(counts, max(int(jf.pool_free_count(jp)), 0) // 4)
        jp, jids = jf.pool_alloc(jp, jnp.asarray(counts), 3)
        tp, tids = tf.pool_alloc(tp, torch.as_tensor(counts), 3)
        _eq(tids, jids, f"ids round {i}")
        mask = rng.random(4) < 0.5
        jp = jf.pool_release(jp, jids, jnp.asarray(mask))
        tp = tf.pool_release(tp, tids, torch.as_tensor(mask))
        _eq(tf.pool_free_count(tp), jf.pool_free_count(jp))
        carried = convert.to_numpy(convert.block_pool_from_jax(jp, device="cpu"))
        for f, v in convert.to_numpy(tp).items():
            ref = jp
            for part in f.split("."):
                ref = getattr(ref, part)
            _eq(torch.as_tensor(v.astype(np.int64)), ref, f)
            np.testing.assert_array_equal(carried[f], v, err_msg=f)


@pytest.mark.parametrize("wrap", [False, True])
def test_ticket_order_live_rank_segment_counts_match_jax(wrap):
    rng = np.random.default_rng(int(wrap))
    S, N = 4, 57
    ids = rng.integers(0, S, N).astype(np.int32)
    base = np.uint32(WRAP if wrap else 100)
    counters = np.full(S, base, np.uint32)
    tickets = np.zeros(N, np.uint32)
    with np.errstate(over="ignore"):
        for r in range(N):
            tickets[r] = counters[ids[r]]
            counters[ids[r]] += np.uint32(1)
    perm = rng.permutation(N)
    ids, tickets = ids[perm], tickets[perm]
    alive = rng.random(N) > 0.3
    ti, tt, ta = (torch.as_tensor(ids), u32.u32(tickets),
                  torch.as_tensor(alive))
    ji, jt, ja = jnp.asarray(ids), jnp.asarray(tickets), jnp.asarray(alive)
    _eq(tf.ticket_order(ti, tt, S), jf.ticket_order(ji, jt, S))
    _eq(tf.live_fifo_rank(ti, tt, ta, S), jf.live_fifo_rank(ji, jt, ja, S))
    _eq(tf.live_fifo_rank_pairwise(ti, tt, ta),
        jf.live_fifo_rank_pairwise(ji, jt, ja))
    _eq(tf.segment_counts(ti, ta, S), jf.segment_counts(ji, ja, S))
    _eq(tf.bucket_histogram(ti, ta, 8), jf.bucket_histogram(ji, ja, 8))


@pytest.mark.parametrize("factory", ["make_sema", "make_block_pool",
                                     "make_multi_sema", "make_qos"])
def test_state_factories_default_to_the_card(factory):
    """The semaphore, block-pool, multi-semaphore and QoS state factories
    resolve ``device=None`` as the port's other factories do: the card,
    raising where CUDA is absent; ``device="cpu"`` builds here."""
    from repro_torch.admission import functional_qos as tq

    make = {"make_sema": lambda **kw: tf.make_sema(4, **kw),
            "make_block_pool": lambda **kw: tf.make_block_pool(8, **kw),
            "make_multi_sema": lambda **kw: tf.make_multi_sema([2, 1], **kw),
            "make_qos": lambda **kw: tq.make_qos([1.0, 2.0], **kw)}[factory]
    def devices(tree):
        if isinstance(tree, torch.Tensor):
            return {tree.device.type}
        return set().union(*(devices(x) for x in tree))

    if torch.cuda.is_available():
        assert devices(make()) == {"cuda"}
        return
    with pytest.raises(RuntimeError, match=f"{factory}.*device='cpu'"):
        make()
    assert devices(make(device="cpu")) == {"cpu"}
