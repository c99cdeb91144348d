"""The port's data pipeline (`repro_torch.data.pipeline`) against the JAX
package's (`repro.data.pipeline`): the loader parts of
`tests/test_substrates.py`, each also holding the port's samples and
batches bit-equal to the reference's for the same seed, start step,
worker count and host sharding."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from repro.data import pipeline as jp
from repro_torch.data import pipeline as tp


def _batches(mod, src_kw, n_workers, start_step, n=3, **kw):
    dl = mod.DataLoader(mod.SyntheticLM(**src_kw), 4, n_workers=n_workers,
                        depth=2, start_step=start_step, **kw)
    it = iter(dl)
    out = [next(it) for _ in range(n)]
    dl.stop()
    return out


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("vocab,seq_len,seed", [(512, 64, 3), (151936, 33, 0)])
def test_synthetic_deterministic(vocab, seq_len, seed):
    src = tp.SyntheticLM(vocab=vocab, seq_len=seq_len, seed=seed)
    a = src.sample(42)
    b = src.sample(42)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # shifted-by-one labels
    np.testing.assert_array_equal(a["tokens"][1:], a["labels"][:-1])
    ref = jp.SyntheticLM(vocab=vocab, seq_len=seq_len, seed=seed)
    for i in (0, 42, 10_007):
        _equal(src.sample(i), ref.sample(i))


def test_bounded_buffer_fifo_and_backpressure():
    buf = tp.BoundedBuffer(depth=4)
    for i in range(4):
        buf.put(i)
    bp = buf.backpressure()
    assert bp["items_ready"] == 4
    got = [buf.get() for _ in range(4)]
    assert got == [0, 1, 2, 3]  # FIFO through the TWA semaphores
    assert buf.backpressure() == jp.BoundedBuffer(depth=4).backpressure()

    # producer blocks at depth, unblocks on get
    buf2 = tp.BoundedBuffer(depth=1)
    buf2.put("a")
    t = threading.Thread(target=buf2.put, args=("b",))
    t.start()
    time.sleep(0.05)
    assert t.is_alive()  # blocked on `free`
    assert buf2.backpressure()["producers_blocked"] == 1
    assert buf2.get() == "a"
    t.join(timeout=10)
    assert buf2.get() == "b"


def test_loader_resume_determinism():
    """Same start_step ⇒ same batches regardless of worker count (FIFO
    buffer + deterministic per-index sampling), and the reference's."""
    kw = dict(vocab=128, seq_len=16, seed=1)
    a = _batches(tp, kw, 1, 5)
    b = _batches(tp, kw, 3, 5)
    want = _batches(jp, kw, 2, 5)
    for x, y, w in zip(a, b, want):
        _equal(x, y)
        _equal(x, w)


def test_loader_host_sharding_disjoint():
    kw = dict(vocab=128, seq_len=16, seed=1)
    b0 = _batches(tp, kw, 1, 0, n=1, host_id=0, n_hosts=2)[0]
    b1 = _batches(tp, kw, 1, 0, n=1, host_id=1, n_hosts=2)[0]
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    for h, got in ((0, b0), (1, b1)):
        _equal(got, _batches(jp, kw, 1, 0, n=1, host_id=h, n_hosts=2)[0])
