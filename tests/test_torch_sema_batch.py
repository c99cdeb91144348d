"""The batched semaphore pass and the multi-semaphore of the port against
the JAX package on the same inputs:

* `repro_torch.kernels.ops.sema_batch` (on the CPU: its plain version,
  `ref.sema_batch_ref`) against JAX's `ops.sema_batch` (the Pallas kernel
  in interpret mode) and `ref.sema_batch_ref` — bit-equal for
  N ∈ {1, 7, 512, 1000}, T ∈ {64, 256}, post_n ∈ {0, 3, T, T+5}, with the
  tickets straddling 2³²;
* `take_batch_multi` / `post_batch_multi` and `woken_mask` against
  `repro.core.functional` (the cases of `tests/test_functional_sema.py`'s
  multi-semaphore property, at fixed seeds), bit-equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import functional as jf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import functional as tf
from repro_torch.core import u32
from repro_torch.kernels import ops

WRAP = (1 << 32) - 300


def _eq(port, ref, msg=""):
    a = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    np.testing.assert_array_equal(a.astype(np.int64),
                                  np.asarray(ref).astype(np.int64),
                                  err_msg=msg)


@pytest.mark.parametrize("N", [1, 7, 512, 1000])
@pytest.mark.parametrize("T", [64, 256])
def test_sema_batch_matches_jax(N, T):
    """Every post_n case of one (N, T) shape: a ticket base 300 below the
    2³² wrap (a 512- or 1000-row batch crosses it), a grant 40 tickets
    ahead, random waiting-array sequences, ~70% requesting rows."""
    rng = np.random.default_rng(N * 7 + T)
    req = rng.random(N) < 0.7
    req[0] = True
    ticket = np.uint32(WRAP)
    grant = np.uint32(WRAP + 40)
    salt = np.uint32(0x1234ABCD)
    seq = rng.integers(0, 1 << 32, T, dtype=np.uint64).astype(np.uint32)
    for post_n in (0, 3, T, T + 5):
        pn = np.uint32(post_n)
        jout = jops.sema_batch(jnp.uint32(ticket), jnp.uint32(grant),
                               jnp.asarray(seq), jnp.asarray(req),
                               jnp.uint32(pn), jnp.uint32(salt))
        r = jref.sema_batch_ref(jnp.uint32(ticket), jnp.uint32(grant),
                                jnp.asarray(seq), jnp.asarray(req),
                                jnp.uint32(pn), jnp.uint32(salt))
        jref_out = (r["ticket"], r["grant"], r["bucket_seq"], r["tickets"],
                    r["admitted"], r["bucket"], r["woken"])
        tout = ops.sema_batch(u32.u32(int(ticket)), u32.u32(int(grant)),
                              u32.u32(seq), torch.as_tensor(req),
                              u32.u32(int(pn)), u32.u32(int(salt)))
        names = ("ticket", "grant", "bucket_seq", "tickets", "admitted",
                 "bucket", "woken")
        for name, t, j, jr in zip(names, tout, jout, jref_out):
            _eq(t, j, f"{name} vs the Pallas kernel, post_n={post_n}")
            _eq(t, jr, f"{name} vs the JAX oracle, post_n={post_n}")
        if post_n == T and N > T:  # a full orbit pokes every bucket
            assert bool(tout[6].any())


def test_sema_batch_int_scalars():
    """The wrapper takes Python ints as well as u32 carriers."""
    seq = u32.u32(np.arange(64))
    req = torch.ones(5, dtype=torch.bool)
    a = ops.sema_batch(3, 5, seq, req, 2, 7)
    b = ops.sema_batch(u32.u32(3), u32.u32(5), seq, req, u32.u32(2),
                       u32.u32(7))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed", range(4))
def test_multi_sema_matches_jax(seed):
    """`take_batch_multi` then `post_batch_multi` then a second take,
    against JAX at a block size that splits the batch (the carried
    per-block base) and with a masked-out row."""
    rng = np.random.default_rng(seed)
    n_sema = int(rng.integers(1, 6))
    N = int(rng.integers(1, 41))
    ids = rng.integers(0, n_sema, N).astype(np.int32)
    mask = rng.random(N) < 0.85
    counts = rng.integers(0, 7, n_sema).astype(np.uint32)
    js = jf.make_multi_sema(jnp.asarray(counts))
    ts = tf.make_multi_sema(counts, device="cpu")
    js = js._replace(ticket=js.ticket + jnp.uint32(WRAP),
                     grant=js.grant + jnp.uint32(WRAP))
    ts = convert.multi_sema_from_jax(js, device="cpu")
    js2, jt, ja = jf.take_batch_multi(js, jnp.asarray(ids), jnp.asarray(mask),
                                      block=8)
    ts2, tt, ta = tf.take_batch_multi(ts, torch.as_tensor(ids),
                                      torch.as_tensor(mask), block=8)
    for f in ("ticket", "grant"):
        _eq(getattr(ts2, f), getattr(js2, f), f)
    _eq(tt, jt, "tickets")
    _eq(ta, ja, "admitted")
    post = rng.integers(0, 3, n_sema).astype(np.uint32)
    js3 = jf.post_batch_multi(js2, jnp.asarray(post))
    ts3 = tf.post_batch_multi(ts2, post)
    js4, jt4, ja4 = jf.take_batch_multi(js3, jnp.asarray(ids),
                                        jnp.ones(N, bool))
    ts4, tt4, ta4 = tf.take_batch_multi(ts3, torch.as_tensor(ids),
                                        torch.ones(N, dtype=torch.bool))
    for f in ("ticket", "grant"):
        _eq(getattr(ts4, f), getattr(js4, f), f)
    _eq(tt4, jt4, "tickets after post")
    _eq(ta4, ja4, "admitted after post")


def test_multi_sema_fcfs_per_semaphore():
    """Per-semaphore FCFS capacity admission (the reference property)."""
    ids = [0, 1, 0, 2, 0, 1, 0]
    st, tickets, admitted = tf.take_batch_multi(
        tf.make_multi_sema([2, 1, 1], device="cpu"),
        torch.as_tensor(ids, dtype=torch.int32),
        torch.ones(len(ids), dtype=torch.bool))
    assert tickets.tolist() == [0, 0, 1, 0, 2, 1, 3]
    assert admitted.tolist() == [True, True, True, True, False, False, False]
    assert st.ticket.tolist() == [4, 2, 1]


@pytest.mark.parametrize("base", [0, WRAP])
def test_woken_mask_matches_jax(base):
    """Waiters observe their buckets after a take; a post moves some of
    them: the woken mask is bit-equal to JAX's, across the wrap."""
    rng = np.random.default_rng(base & 0xFF)
    js = jf.make_sema(4, table_size=64)
    js = js._replace(ticket=js.ticket + jnp.uint32(base),
                     grant=js.grant + jnp.uint32(base))
    ts = convert.sema_from_jax(js, device="cpu")
    req = np.ones(40, bool)
    js, _, _, jb = jf.take_batch(js, jnp.asarray(req))
    ts, _, _, tb = tf.take_batch(ts, torch.as_tensor(req))
    jobs = js.bucket_seq[jb]
    tobs = ts.bucket_seq[tb.to(torch.int64)]
    n = int(rng.integers(1, 20))
    js, ts = jf.post_batch(js, n), tf.post_batch(ts, n)
    jw = jf.woken_mask(js, jobs, jb)
    tw = tf.woken_mask(ts, tobs, tb)
    _eq(tw, jw, "woken")
    assert bool(tw.any())
