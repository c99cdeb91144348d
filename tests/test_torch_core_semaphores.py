"""The port's L1 (host-thread) semaphores — all listings, from
`repro_torch.core` — under the reference's paper-fidelity tests (the
mirror of ``tests/test_core_semaphores.py``, same kinds, threads and
iteration counts), and held to the reference package on scripted
single-thread sequences with the bucket address ``_addr`` pinned equal on
both sides: tickets, grants, the buckets each post pokes and the
tombstone outcomes, for every kind.

Covered claims:
  * counting-semaphore safety: never more than `count` threads inside;
  * liveness / no lost wakeups under heavy take/post churn (all waiting modes);
  * FIFO (first-come-first-enabled) admission for the ticket-based kinds —
    the paper's central QoI property (pthread-like baseline is *not* FIFO);
  * post(n) enables exactly n waiters;
  * benaphore fast-path in TWA post never skips a needed wake;
  * queue-depth telemetry (grant/ticket distance) monotonicity;
  * 64-bit wrap-around distance arithmetic.
"""

from __future__ import annotations

import threading
import time

import pytest

import repro.admission.cancellable as j_cancellable
import repro.core as j_core
import repro.core.channels as j_channels
import repro.core.location_wait as j_location_wait
import repro.core.twa_semaphore as j_twa
import repro.core.waiting_chains as j_chains
import repro_torch.admission.cancellable as t_cancellable
import repro_torch.core as t_core
import repro_torch.core.channels as t_channels
import repro_torch.core.location_wait as t_location_wait
import repro_torch.core.twa_semaphore as t_twa
import repro_torch.core.waiting_chains as t_chains
from repro_torch.core import SEMAPHORE_KINDS
from repro_torch.core.ticket_semaphore import _dist
from repro_torch.core.twa_semaphore import TWASemaphore, WaitingArray

# Parking/futex-style kinds are safe under the GIL; pure-spin variants also
# terminate (pause() releases the GIL) but are slow, so stress counts differ.
KINDS = {
    "ticket-spin": lambda c=0: SEMAPHORE_KINDS["ticket"](c, waiting="spin"),
    "ticket-broadcast": lambda c=0: SEMAPHORE_KINDS["ticket"](c, waiting="broadcast"),
    "twa-spin": lambda c=0: SEMAPHORE_KINDS["twa"](c, waiting="spin"),
    "twa-futex": lambda c=0: SEMAPHORE_KINDS["twa"](c, waiting="futex"),
    "twa-chains": lambda c=0: SEMAPHORE_KINDS["twa-chains"](c),
    "twa-channels": lambda c=0: SEMAPHORE_KINDS["twa-channels"](c),
    "twa-v3": lambda c=0: SEMAPHORE_KINDS["twa-v3"](c),
    "pthread": lambda c=0: SEMAPHORE_KINDS["pthread"](c),
}
FIFO_KINDS = [k for k in KINDS if k != "pthread"]
SLOW = {"ticket-spin", "twa-spin"}  # GIL-polling: keep iteration counts low


@pytest.mark.parametrize("kind", list(KINDS))
def test_mutual_exclusion_and_liveness(kind):
    """count=1 semaphore used as a lock by N threads: the shared counter
    increments race-free and every thread finishes (no lost wakeups)."""
    sem = KINDS[kind](1)
    n_threads, iters = (4, 50) if kind in SLOW else (8, 200)
    shared = {"x": 0, "max_inside": 0, "inside": 0}
    guard = threading.Lock()

    def worker():
        for _ in range(iters):
            sem.take()
            with guard:
                shared["inside"] += 1
                shared["max_inside"] = max(shared["max_inside"], shared["inside"])
            x = shared["x"]
            shared["x"] = x + 1
            with guard:
                shared["inside"] -= 1
            sem.post()

    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive(), f"{kind}: lost wakeup / deadlock"
    assert shared["x"] == n_threads * iters
    assert shared["max_inside"] == 1


@pytest.mark.parametrize("kind", list(KINDS))
def test_counting_capacity(kind):
    """count=K: at most K concurrently inside the critical region."""
    K = 3
    sem = KINDS[kind](K)
    n_threads, iters = (6, 20) if kind in SLOW else (10, 60)
    inside = {"now": 0, "max": 0}
    guard = threading.Lock()

    def worker():
        for _ in range(iters):
            sem.take()
            with guard:
                inside["now"] += 1
                inside["max"] = max(inside["max"], inside["now"])
            time.sleep(0)
            with guard:
                inside["now"] -= 1
            sem.post()

    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert 1 <= inside["max"] <= K


@pytest.mark.parametrize("kind", FIFO_KINDS)
def test_fifo_admission(kind):
    """Ticket-based semaphores admit in arrival (ticket) order.  We serialize
    arrivals (so ticket order is known), then release one permit at a time
    and observe completion order == arrival order."""
    sem = KINDS[kind](0)
    order = []
    guard = threading.Lock()
    started = threading.Semaphore(0)

    def waiter(i):
        started.release()
        sem.take()
        with guard:
            order.append(i)

    ts = []
    for i in range(8):
        t = threading.Thread(target=waiter, args=(i,))
        ts.append(t)
        t.start()
        started.acquire()
        # Wait until the thread has actually taken its ticket (ticket counter
        # advanced) so arrival order is deterministic.
        deadline = time.time() + 10
        while sem.ticket.load() != i + 1 and time.time() < deadline:
            time.sleep(0.001)
        assert sem.ticket.load() == i + 1

    for i in range(8):
        sem.post()
        deadline = time.time() + 30
        while len(order) != i + 1 and time.time() < deadline:
            time.sleep(0.001)
        assert order == list(range(i + 1)), f"{kind}: admission out of order: {order}"
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()


@pytest.mark.parametrize("kind", ["twa-futex", "twa-chains", "twa-channels", "pthread"])
def test_post_n_enables_n(kind):
    sem = KINDS[kind](0)
    done = threading.Semaphore(0)

    def waiter():
        sem.take()
        done.release()

    ts = [threading.Thread(target=waiter) for _ in range(6)]
    for t in ts:
        t.start()
    time.sleep(0.05)
    sem.post(4)
    for _ in range(4):
        assert done.acquire(timeout=30)
    time.sleep(0.1)
    assert not done.acquire(blocking=False), "post(4) enabled a 5th waiter"
    sem.post(2)
    for _ in range(2):
        assert done.acquire(timeout=30)
    for t in ts:
        t.join(timeout=30)


def test_benaphore_fast_path_equivalence():
    """TWA post with and without the racy fast path admits identically."""
    for fast in (True, False):
        sem = TWASemaphore(0, waiting="futex", post_fast_path=fast)
        results = []
        ts = [threading.Thread(target=lambda: (sem.take(), results.append(1)))
              for _ in range(5)]
        for t in ts:
            t.start()
        time.sleep(0.05)
        sem.post(5)
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive(), f"fast_path={fast} lost a wakeup"
        assert len(results) == 5


def test_private_waiting_array_and_collisions():
    """A 1-bucket array forces every waiter onto one bucket (max collisions):
    correctness must hold (collisions are a performance concern only)."""
    arr = WaitingArray(table_size=1)
    sem = TWASemaphore(0, waiting="futex", array=arr)
    done = threading.Semaphore(0)
    ts = [threading.Thread(target=lambda: (sem.take(), done.release())) for _ in range(6)]
    for t in ts:
        t.start()
    time.sleep(0.05)
    for _ in range(6):
        sem.post()
    for _ in range(6):
        assert done.acquire(timeout=30)
    for t in ts:
        t.join(timeout=10)


def test_queue_depth_telemetry():
    sem = TWASemaphore(2, waiting="futex")
    assert sem.available() == 2 and sem.queue_depth() == 0
    sem.take()
    sem.take()
    assert sem.available() == 0
    t = threading.Thread(target=sem.take)
    t.start()
    deadline = time.time() + 10
    while sem.queue_depth() != 1 and time.time() < deadline:
        time.sleep(0.001)
    assert sem.queue_depth() == 1  # grant/ticket distance = free telemetry
    sem.post()
    t.join(timeout=10)
    assert not t.is_alive()


def test_wraparound_distance():
    """64-bit modular distance: grant just past 2^64 still compares correctly."""
    near = (1 << 64) - 2
    assert _dist(1, near) == 3  # grant wrapped to 1, ticket at 2^64-2
    assert _dist(near, 1) == -3
    sem = TWASemaphore(0, waiting="futex")
    sem.ticket.store(near)
    sem.grant.store(near)
    sem.post(3)
    sem.take()  # ticket 2^64-2 vs grant 1 (wrapped): distance 3 > 0 → pass
    assert sem.available() == 2


# ----------------------------------------------- parity with the reference --


def test_semaphore_kinds_match_the_reference():
    assert list(SEMAPHORE_KINDS) == list(j_core.SEMAPHORE_KINDS)
    assert t_core.__all__ == j_core.__all__
    for name, cls in SEMAPHORE_KINDS.items():
        assert cls.__name__ == j_core.SEMAPHORE_KINDS[name].__name__
        assert cls.__module__.startswith("repro_torch.core.")


ADDR = 0x5EED1234   # the pinned bucket address (both packages)
TABLE = 64


def _script(kind, pkg):
    """One kind's scripted single-thread sequence on one package
    (``pkg``: the package's ``(core, twa, chains, channels,
    location_wait)`` modules), with ``_addr`` pinned and a private
    64-entry table: plain takes, virtual waiters (tickets issued with no
    thread behind them), posts of 1, 2 and 3; after each operation the
    ticket, the grant, ``available``/``queue_depth`` and the buckets the
    operation poked.  Never blocks."""
    core, twa, chains, channels, lw = pkg
    cls = core.SEMAPHORE_KINDS[kind]
    log = []
    if kind == "pthread":
        sem = cls(2)
        for op, n in (("take", 0), ("take", 0), ("post", 1), ("post", 3),
                      ("take", 0), ("post", 2)):
            getattr(sem, op)(*((n,) if op == "post" else ()))
            log.append((op, n, sem.available(), sem._takes, sem._posts))
        return log
    if kind == "ticket":
        sem = cls(2)
        poked = lambda: None  # noqa: E731 — global spinning: no buckets
    elif kind == "twa":
        sem = cls(2, waiting="futex", array=twa.WaitingArray(TABLE))
        seq0 = [0] * TABLE

        def poked():
            now = [b.seq.load() for b in sem.array.buckets]
            out = [i for i in range(TABLE) if now[i] != seq0[i]]
            seq0[:] = now
            return out
    elif kind == "twa-channels":
        sem = cls(2, table=channels.ChannelTable(TABLE))
        seq0 = [0] * TABLE

        def poked():
            now = [c.sequence.load() for c in sem.table.slots]
            out = [i for i in range(TABLE) if now[i] != seq0[i]]
            seq0[:] = now
            return out
    else:   # twa-chains, twa-v3: a parked element on every bucket
        if kind == "twa-chains":
            sem = cls(2, table=chains.ChainTable(TABLE))
            make, chain = chains.WaitElement, lambda i: sem.table.slots[i]
        else:
            sem = cls(2, table=lw.SlotTable(TABLE))
            make, chain = lw.TLSWaitElement, lambda i: sem.table.slots[i]
        parked = []
        for i in range(TABLE):
            parked.append(make())
            chain(i).chain.store(parked[i])

        def poked():
            out = [i for i in range(TABLE) if parked[i].gate.load()]
            for i in out:
                parked[i] = make()
                chain(i).chain.store(parked[i])
            return out
    sem._addr = ADDR

    def obs(op, n):
        log.append((op, n, sem.ticket.load(), sem.grant.load(),
                    sem.available(), sem.queue_depth(), poked()))

    for op, n in (("take", 0), ("take", 0), ("waiters", 5), ("post", 1),
                  ("post", 2), ("waiters", 3), ("post", 3), ("post", 3),
                  ("take", 0), ("post", 1)):
        if op == "take":
            assert sem.available() > 0   # the fast path: never blocks
            sem.take()
        elif op == "waiters":
            sem.ticket.fetch_add(n)
        else:
            sem.post(n)
        obs(op, n)
    if kind == "twa-v3":
        sem.ticket.fetch_add(4)
        sem.post_conservative(2)
        obs("post_conservative", 2)
    return log


PKGS = {"reference": (j_core, j_twa, j_chains, j_channels, j_location_wait),
        "port": (t_core, t_twa, t_chains, t_channels, t_location_wait)}


@pytest.mark.parametrize("kind", list(SEMAPHORE_KINDS))
def test_scripted_sequence_matches_the_reference(kind):
    ref = _script(kind, PKGS["reference"])
    port = _script(kind, PKGS["port"])
    assert port == ref
    if kind not in ("ticket", "pthread"):
        assert any(step[-1] for step in port), "no post poked a bucket"


def _tombstones(twa, cancellable):
    """The tombstone protocol on one package, single-threaded: handles
    cancelled before and after the grant reaches them, skip-aware posts,
    waits that resolve at a past deadline, ``take_until`` /
    ``take_with_deadline`` / ``take_with_timeout``, a cancel that loses
    the race; after each step the outcome, the counters, the tombstone
    books and the buckets poked."""
    sem = twa.TWASemaphore(0, waiting="futex", cancellation=True,
                           array=twa.WaitingArray(TABLE))
    sem._addr = ADDR
    stats = cancellable.CancelStats()
    seq0 = [0] * TABLE
    log = []

    def obs(what, result):
        now = [b.seq.load() for b in sem.array.buckets]
        log.append((what, result, sem.ticket.load(), sem.grant.load(),
                    sem.available(), sem.queue_depth(),
                    sem.live_queue_depth(), sem.tombstones_pending(),
                    sem.tombstones_skipped,
                    [i for i in range(TABLE) if now[i] != seq0[i]],
                    stats.acquired, stats.cancelled, stats.lost_races))
        seq0[:] = now

    past = time.monotonic() - 1.0
    h = [cancellable.CancellableTake(sem, stats) for _ in range(6)]
    obs("handles", [x.ticket for x in h])
    obs("cancel 1", h[1].cancel())
    obs("cancel 3", h[3].cancel())
    sem.post(1)
    obs("post 1", None)
    obs("wait 0", h[0].wait(past))
    sem.post(1)
    obs("post 1 (skips 1)", None)
    obs("wait 2", h[2].wait(past))
    obs("wait 4 (deadline)", h[4].wait(past))
    obs("cancel 3 again", h[3].cancel())
    obs("cancel 2 (granted)", h[2].cancel())
    sem.post(3)
    obs("post 3 (skips 3, 4)", None)
    obs("wait 5", h[5].wait(past))
    obs("take_until", sem.take_until(past))
    obs("take_with_deadline", cancellable.take_with_deadline(sem, past,
                                                              stats))
    obs("take_with_timeout", cancellable.take_with_timeout(sem, 0.0, stats))
    obs("cancel granted", sem.cancel(sem.grant.load() - 1))
    sem.post(2)
    obs("post 2", None)
    sem.poke_ticket(17)
    obs("poke 17", None)
    return log


def test_tombstone_sequence_matches_the_reference():
    ref = _tombstones(j_twa, j_cancellable)
    port = _tombstones(t_twa, t_cancellable)
    assert port == ref
    assert port[-1][8] >= 2   # the posts skipped tombstones
