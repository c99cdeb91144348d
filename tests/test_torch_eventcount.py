"""The port's EventCount / Sequencer / TicketMutex (`repro_torch.core.
eventcount`; paper §1: the TWA transformation applied to the Reed–Kanodia
constructs) under the reference's tests (the mirror of
``tests/test_eventcount.py``), and held to the reference package on a
scripted single-thread sequence with ``_addr`` pinned: the counts, the
sequencer's tickets and the buckets each advance pokes.  The port's
eventcounts share the port's own process-global waiting array."""

from __future__ import annotations

import threading
import time

import repro.core.eventcount as j_ec
import repro.core.twa_semaphore as j_twa
import repro_torch.core.eventcount as t_ec
import repro_torch.core.twa_semaphore as t_twa
from repro_torch.core.eventcount import EventCount, Sequencer, TicketMutex


def test_sequencer_dense_unique():
    seq = Sequencer()
    out = []
    lock = threading.Lock()

    def worker():
        for _ in range(200):
            t = seq.ticket()
            with lock:
                out.append(t)

    ts = [threading.Thread(target=worker) for _ in range(6)]
    [t.start() for t in ts]
    [t.join(timeout=30) for t in ts]
    assert sorted(out) == list(range(1200))  # dense, no duplicates


def test_eventcount_await_advance():
    ec = EventCount()
    seen = []

    def waiter(v):
        c = ec.await_(v)
        seen.append((v, c))

    ts = [threading.Thread(target=waiter, args=(v,)) for v in (3, 1, 5)]
    [t.start() for t in ts]
    time.sleep(0.05)
    ec.advance(1)  # enables await(1) only
    time.sleep(0.1)
    assert sorted(v for v, _ in seen) == [1]
    ec.advance(4)  # count=5 — enables 3 and 5
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(v for v, _ in seen) == [1, 3, 5]
    for v, c in seen:
        assert c >= v  # awaited condition actually held


def test_eventcount_selective_wakeup_buckets():
    """advance(n) pokes only the buckets of the enabled values — waiters far
    beyond the advance are not woken (their buckets untouched, absent
    collisions in a large private array)."""
    from repro_torch.core.twa_semaphore import WaitingArray

    arr = WaitingArray(table_size=2048)
    ec = EventCount(array=arr)
    far = threading.Thread(target=ec.await_, args=(1000,))
    far.start()
    time.sleep(0.05)
    ec.advance(3)
    time.sleep(0.1)
    assert far.is_alive()  # far waiter undisturbed and unenabled
    ec.advance(997)
    far.join(timeout=30)
    assert not far.is_alive()


def test_ticket_mutex_mutual_exclusion():
    m = TicketMutex()
    shared = {"x": 0, "in": 0, "max": 0}
    guard = threading.Lock()

    def worker():
        for _ in range(150):
            m.lock()
            with guard:
                shared["in"] += 1
                shared["max"] = max(shared["max"], shared["in"])
            shared["x"] += 1
            with guard:
                shared["in"] -= 1
            m.unlock()

    ts = [threading.Thread(target=worker) for _ in range(6)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert shared["x"] == 900
    assert shared["max"] == 1


# ----------------------------------------------- parity with the reference --


def _script(ec_mod, twa_mod):
    """Advances of 1, 3 and 0 with the threshold at 1 and 2, awaits that
    hold at once, a sequencer's tickets from 2⁶⁴ − 2 (its wrap); after
    each step the count, the value returned and the buckets poked."""
    log = []
    for threshold in (1, 2):
        arr = twa_mod.WaitingArray(table_size=64)
        ec = ec_mod.EventCount(5, long_term_threshold=threshold, array=arr)
        ec._addr = 0x5EED1234
        seq0 = [0] * 64
        for op, n in (("advance", 1), ("advance", 3), ("await_", 7),
                      ("advance", 0), ("await_", 9), ("read", 0)):
            r = getattr(ec, op)(*(() if op == "read" else (n,)))
            now = [b.seq.load() for b in arr.buckets]
            log.append((threshold, op, n, r, ec.read(),
                        [i for i in range(64) if now[i] != seq0[i]]))
            seq0 = now
    seq = ec_mod.Sequencer((1 << 64) - 2)
    log.append([seq.ticket() for _ in range(4)] + [seq.read()])
    return log


def test_scripted_sequence_matches_the_reference():
    port = _script(t_ec, t_twa)
    assert port == _script(j_ec, j_twa)
    assert any(step[-1] for step in port[:-1])


def test_the_port_shares_its_own_global_array():
    """`EventCount` defaults to the port's process-global waiting array —
    the one every port `TWASemaphore` shares — not the reference's."""
    assert EventCount().array is t_twa._GLOBAL_ARRAY
    assert t_twa.TWASemaphore().array is t_twa._GLOBAL_ARRAY
    assert t_twa._GLOBAL_ARRAY is not j_twa._GLOBAL_ARRAY
    m = TicketMutex()
    m.lock()
    m.unlock()
    assert m.ec.array is t_twa._GLOBAL_ARRAY and m.ec.read() == 1
