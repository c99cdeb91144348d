"""The port's host admission stacks (`repro_torch.admission.cancellable`
and `.hierarchical`) under the reference's tombstone and hierarchical-tree
tests (the mirror of ``tests/test_admission.py``'s host-thread tests, with
their threads, timeouts and counts), and held to the reference package on
scripted single-thread sequences with each leaf's ``_addr`` pinned: the
weighted tree's per-tenant grants, passes and virtual time over a
replenish sequence, the handles' outcomes and the buckets each release
pokes."""

from __future__ import annotations

import threading
import time

import repro.admission as j_admission
import repro.core.twa_semaphore as j_twa
import repro_torch.admission as t_admission
import repro_torch.core.twa_semaphore as t_twa
from repro_torch.admission import (
    CancellableTake,
    HierarchicalTWASemaphore,
    take_with_timeout,
)
from repro_torch.core.twa_semaphore import TWASemaphore

# --------------------------------------------------------------- tombstones --


def test_tombstone_skip_preserves_live_fcfs():
    """Waiters A, B, C in FCFS order; B abandons.  Posts must reach A then
    C (skipping B's dead ticket) in ticket order — the skip-aware post."""
    sem = TWASemaphore(0, waiting="futex", cancellation=True)
    order: list[str] = []
    order_lock = threading.Lock()

    def waiter(name):
        sem.take()
        with order_lock:
            order.append(name)

    a = threading.Thread(target=waiter, args=("A",)); a.start()
    time.sleep(0.05)  # ticket order: A=0
    got_b = []
    b = threading.Thread(
        target=lambda: got_b.append(take_with_timeout(sem, 0.15)))
    b.start()  # B=1, will time out
    time.sleep(0.05)
    c = threading.Thread(target=waiter, args=("C",)); c.start()  # C=2
    b.join(3)
    assert got_b == [False]
    sem.post(1)  # → A
    a.join(3)
    sem.post(1)  # lands on B's tombstone → skipped → C
    c.join(3)
    assert order == ["A", "C"]
    assert sem.tombstones_skipped == 1
    assert sem.tombstones_pending() == 0


def test_cancel_lost_race_holds_slot():
    """A cancel that arrives after the grant reports 'acquired' — the slot
    is owned, never leaked, never double-granted."""
    sem = TWASemaphore(1, cancellation=True)
    assert sem.take_until(time.monotonic() - 1.0) is True  # grant pre-arrived
    assert sem.available() == 0
    sem.post()
    assert sem.available() == 1


def test_external_cancel_unblocks_futex_waiter():
    sem = TWASemaphore(0, waiting="futex", cancellation=True)
    handle = CancellableTake(sem)
    res = []
    t = threading.Thread(target=lambda: res.append(handle.wait(None)))
    t.start()
    time.sleep(0.1)
    assert handle.cancel() is True
    t.join(3)
    assert not t.is_alive() and res == [False]
    # the tombstone is transparent to the next waiter
    nxt = CancellableTake(sem)
    sem.post(1)
    assert nxt.wait(time.monotonic() + 3) is True


def test_cancel_exactly_one_outcome_under_race():
    """Hammer cancel-vs-post: for every handle exactly one of
    {acquired, cancelled} holds, and slots are conserved."""
    for trial in range(30):
        sem = TWASemaphore(0, cancellation=True)
        handles = [CancellableTake(sem) for _ in range(4)]
        results = [None] * 4

        def wait(i):
            results[i] = handles[i].wait(time.monotonic() + 0.01 * (i % 3))

        ts = [threading.Thread(target=wait, args=(i,)) for i in range(4)]
        [t.start() for t in ts]
        sem.post(2)
        [t.join(5) for t in ts]
        acquired = sum(bool(r) for r in results)
        # 2 units among 4 deadline-racing waiters: the acquired count plus
        # units still available (skipped past everyone) must equal 2.
        assert acquired + sem.available() == 2, (trial, results)


# --------------------------------------------------------- hierarchical tree --


def test_hierarchical_weighted_shares_under_saturation():
    """Tenant admission counts converge to weights while all tenants stay
    backlogged (stride replenishment)."""
    h = HierarchicalTWASemaphore(4, waiting="futex")
    weights = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
    for t, w in weights.items():
        h.register(t, w)
    stop = threading.Event()

    def worker(tenant):
        while not stop.is_set():
            if h.acquire(tenant, timeout=1.0):
                time.sleep(0.0005)
                h.release(tenant)

    ts = [threading.Thread(target=worker, args=(t,))
          for t in weights for _ in range(4)]
    [t.start() for t in ts]
    time.sleep(1.5)
    stop.set()
    [t.join(5) for t in ts]
    shares = h.shares()
    wsum = sum(weights.values())
    for t, w in weights.items():
        target = w / wsum
        assert abs(shares[t] - target) / target < 0.15, (shares, t)


def test_hierarchical_cancel_does_not_strand_slots():
    """A tenant whose only waiter abandons must not hoard the slot: it is
    reclaimed and flows to the other tenant (work conservation)."""
    h = HierarchicalTWASemaphore(1, waiting="futex")
    h.register("a", 1.0)
    h.register("b", 1.0)
    assert h.acquire("a", timeout=1.0)  # a holds the only slot
    res_b = []
    b = threading.Thread(target=lambda: res_b.append(
        h.acquire("b", timeout=0.15)))
    b.start()
    b.join(3)
    assert res_b == [False]  # b abandoned; its leaf may hold a stranded unit
    res_a2 = []
    a2 = threading.Thread(target=lambda: res_a2.append(
        h.acquire("a", timeout=5.0)))
    a2.start()
    time.sleep(0.05)
    h.release("a")  # must reach a2 despite b's tombstone
    a2.join(5)
    assert res_a2 == [True]
    h.release("a")
    tel = h.telemetry()
    assert tel["free"] == 1  # slot conserved back at the root


# ------------------------------------------------------------ functional QoS --


# ----------------------------------------------- parity with the reference --


def test_exports_match_the_reference():
    assert t_admission.__all__ == j_admission.__all__


def _replenish(adm, twa):
    """A three-tenant tree (weights 4 : 2 : 1, three slots) on one
    package, single-threaded: three fast-path acquires take the slots;
    four waiting handles a tenant (tickets issued with no thread behind
    them); nine releases route the slots by stride, one waiter of
    ``silver`` abandons midway (reclaim), a timed-out acquire tombstones
    its ticket; after each step the telemetry, each leaf's pass, grant
    and ticket, and the buckets poked in the tree's one waiting array."""
    arr = twa.WaitingArray(64)
    h = adm.HierarchicalTWASemaphore(3, array=arr)
    for i, (t, w) in enumerate((("gold", 4.0), ("silver", 2.0),
                                ("bronze", 1.0))):
        h.register(t, w)
        h._leaves[t].sem._addr = 0x5EED0000 + 977 * i
    seq0 = [0] * 64
    log = []

    def obs(what, result=None):
        now = [b.seq.load() for b in arr.buckets]
        log.append((what, result, h.telemetry(), h.shares(),
                    h.queue_depths(),
                    {t: (lf.pass_, lf.sem.ticket.load(), lf.sem.grant.load())
                     for t, lf in h._leaves.items()},
                    [i for i in range(64) if now[i] != seq0[i]]))
        seq0[:] = now

    for t in ("gold", "silver", "bronze"):
        obs(f"acquire {t}", h.acquire(t, timeout=1.0))
    past = time.monotonic() - 1.0
    waiters = {t: [adm.CancellableTake(h._leaves[t].sem,
                                       h._leaves[t].stats) for _ in range(4)]
               for t in ("gold", "silver", "bronze")}
    obs("waiters")
    for k in range(9):
        h.release()
        obs(f"release {k}")
        if k == 3:
            obs("silver abandons", waiters["silver"][1].cancel())
    obs("timed out", h.acquire("bronze", timeout=0.0))
    outcomes = {t: [w.wait(past) for w in ws] for t, ws in waiters.items()}
    obs("outcomes", outcomes)
    return log


def test_hierarchical_replenish_matches_the_reference():
    port = _replenish(t_admission, t_twa)
    assert port == _replenish(j_admission, j_twa)
    granted = port[-1][2]["tenants"]
    assert granted["gold"]["granted"] > granted["bronze"]["granted"]
    assert any(step[-1] for step in port)
