"""The port's coordinator (`repro_torch.runtime.coordinator`) against the
JAX package's copy (`repro.runtime.coordinator`): the coordinator parts of
`tests/test_coordinator.py`, `tests/test_lease_backoff.py`, the
coordinator parts of `tests/test_substrates.py` and
`tests/test_admission.py::test_lease_timeout_does_not_wedge_grant_sequence`.

Each scripted scenario runs on both modules and their outcomes are held
equal: under a virtual clock (failure detection, rejoin, barriers,
stragglers, membership churn) and single-threaded lease sequences
(tickets, grants, tombstones, bucket keys, heartbeats) bit for bit, the
seeded jitter stream included.  The threaded lease scenarios (FCFS under
contention, timeouts, queued heartbeats) assert the reference's
properties of the port and compare the counts both sides can fix.  The
lease reaper (`runtime/reaper.py`) is held against the reference in
`tests/test_torch_reaper.py`.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

from repro.runtime import coordinator as jc
from repro_torch.runtime import coordinator as tc

BOTH = (tc, jc)


def _coord(mod, vc, timeout=2.0):
    return mod.Coordinator(heartbeat_timeout=timeout, kv=mod.KVStore(),
                           clock=lambda: vc[0])


def _same(scenario, *args):
    """``scenario(mod, *args)`` on the port and on the reference: equal
    outcomes; returns the port's."""
    got, want = (scenario(mod, *args) for mod in BOTH)
    assert got == want
    return got


# ---------------------------------------------------- failure detection ----


def _detect_and_rejoin(mod):
    vc = [0.0]
    c = _coord(mod, vc, timeout=2.0)
    for h in (0, 1, 2):
        c.join(h)
    out = {"e0": c.epoch}
    vc[0] = 1.0
    for h in (0, 1):  # host 2 goes silent at t=0
        c.heartbeat(h, step=1, step_time_s=0.1)
    vc[0] = 1.9
    out["at_1.9"] = c.detect_failures()
    vc[0] = 2.5
    out["at_2.5"] = c.detect_failures()
    out["epoch_dead"], out["alive_dead"] = c.epoch, c.alive_hosts()
    try:
        c.heartbeat(2, step=9, step_time_s=0.1)
        out["fenced"] = False
    except RuntimeError:
        out["fenced"] = True
    out["e2"] = c.join(2)
    for h in (0, 1, 2):
        c.heartbeat(h, step=10, step_time_s=0.1)
    vc[0] = 3.5
    out["at_3.5"], out["alive"] = c.detect_failures(), c.alive_hosts()
    return out


def test_detect_failures_and_rejoin_virtual_clock():
    """A host that stops heartbeating is declared dead exactly when the
    virtual clock passes the timeout; a rejoin re-enters it with a bumped
    epoch; a dead host's heartbeat is fenced."""
    out = _same(_detect_and_rejoin)
    assert out["at_1.9"] == [] and out["at_2.5"] == [2]
    assert out["epoch_dead"] == out["e0"] + 1 and out["e2"] == out["e0"] + 2
    assert out["alive_dead"] == [0, 1] and out["fenced"]
    assert out["at_3.5"] == [] and out["alive"] == [0, 1, 2]


def _stragglers(mod, rounds, slow, real_clock):
    c = mod.Coordinator() if real_clock else _coord(mod, [0.0])
    for h in (0, 1, 2, 3):
        c.join(h)
    for _ in range(rounds):  # let the EWMA converge
        for h in (0, 1, 2, 3):
            c.heartbeat(h, 1, slow if h == 3 else 0.1)
    return c.stragglers()


@pytest.mark.parametrize("rounds,slow,real_clock", [(8, 1.0, False),
                                                    (5, 0.5, True)])
def test_stragglers_by_ewma(rounds, slow, real_clock):
    assert _same(_stragglers, rounds, slow, real_clock) == [3]


# ------------------------------------------------------------- barriers ----


def _barrier_shrinks(mod):
    vc = [0.0]
    c = _coord(mod, vc, timeout=2.0)
    for h in (0, 1, 2):
        c.join(h)
    results = {}

    def arrive(h):
        results[h] = c.barrier(h, "gen-1", timeout=60.0)

    ts = [threading.Thread(target=arrive, args=(h,)) for h in (0, 1)]
    for t in ts:
        t.start()
    for _ in range(200):
        if all(not t.is_alive() for t in ts):
            break
        vc[0] += 0.5
        for h in (0, 1):
            if h in c.alive_hosts():
                c.heartbeat(h, step=1, step_time_s=0.1)
        time.sleep(0.01)
    for t in ts:
        t.join(timeout=10.0)
    return results, c.alive_hosts()


def test_barrier_shrinks_when_a_host_dies():
    """Two live hosts arrive; the third died silently: once the advancing
    virtual clock declares it dead the barrier completes."""
    assert _same(_barrier_shrinks) == ({0: True, 1: True}, [0, 1])


def _barrier_times_out(mod):
    vc = [0.0]
    c = _coord(mod, vc, timeout=1e9)  # nobody dies in this test
    c.join(0)
    c.join(1)
    out = {}
    t = threading.Thread(
        target=lambda: out.setdefault(0, c.barrier(0, "gen-2", timeout=5.0)))
    t.start()
    for _ in range(200):
        if not t.is_alive():
            break
        vc[0] += 0.5
        time.sleep(0.01)
    t.join(timeout=10.0)
    return out


def test_barrier_times_out_on_virtual_deadline():
    assert _same(_barrier_times_out) == {0: False}


def test_failure_detection_and_barrier():
    """The real-clock version (`tests/test_substrates.py`): a silent host
    is dead after the timeout and the barrier completes with the
    survivors."""
    c = tc.Coordinator(heartbeat_timeout=0.2)
    for h in (0, 1, 2):
        c.join(h)
    for h in (0, 1, 2):
        c.heartbeat(h, 1, 0.1)
    assert c.detect_failures() == []
    time.sleep(0.3)
    c.heartbeat(0, 2, 0.1)
    c.heartbeat(1, 2, 0.1)  # host 2 silent
    assert c.detect_failures() == [2]
    assert c.alive_hosts() == [0, 1]
    done = []
    t0 = threading.Thread(target=lambda: done.append(c.barrier(0, "g1")))
    t1 = threading.Thread(target=lambda: done.append(c.barrier(1, "g1")))
    t0.start(), t1.start()
    t0.join(timeout=15), t1.join(timeout=15)
    assert done == [True, True]


# ------------------------------------------------------ churn property ----


def _churn(mod, seed):
    rng = np.random.default_rng(seed)
    vc = [0.0]
    c = _coord(mod, vc, timeout=2.0)
    trace = []
    stamps: dict[int, float] = {}
    alive: set[int] = set()
    for _ in range(40):
        op = int(rng.integers(0, 4))
        h = int(rng.integers(0, 5))
        if op == 0:
            c.join(h)
            stamps[h] = vc[0]
            alive.add(h)
        elif op == 1 and h in alive:
            c.leave(h)
            alive.discard(h)
        elif op == 2 and h in alive:
            c.heartbeat(h, step=1, step_time_s=0.1)
            stamps[h] = vc[0]
        else:
            vc[0] += float(rng.uniform(0.0, 1.5))
            dead = sorted(c.detect_failures())
            assert dead == sorted(x for x in alive
                                  if vc[0] - stamps[x] > c.heartbeat_timeout)
            alive -= set(dead)
            trace.append(("dead", dead))
        trace.append((c.epoch, c.alive_hosts()))
    return trace


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10_000))
def test_membership_churn_property(seed):
    """Random join/leave/silence/advance churn: the same epochs, deaths
    and memberships on both sides; ``detect_failures`` flags exactly the
    hosts whose last stamp is stale; the epoch only moves forward."""
    trace = _same(_churn, seed)
    epochs = [e for e, _ in trace if e != "dead"]
    assert epochs == sorted(epochs)


# ---------------------------------------------------- lease sequences ----


def _lease_script(mod, capacity):
    """A single-threaded sequence of every non-blocking lease operation
    under a virtual clock, recording each answer and the KV store."""
    vc = [0.0]
    kv = mod.KVStore()
    lease = mod.DistributedTicketLease(kv, "cap", capacity=capacity,
                                       clock=lambda: vc[0], backoff_seed=3)
    out = []
    held = [lease.try_acquire() for _ in range(capacity + 1)]
    out.append(("try", held, lease.headroom()))
    queued = [lease.take_ticket() for _ in range(4)]
    out.append(("queued", queued, [lease.granted(t) for t in queued],
                [lease.bucket_state(t) for t in queued]))
    vc[0] = 1.5
    lease.renew(held[0])
    out.append(("ages", [lease.heartbeat_age(t) for t in held + queued],
                lease.outstanding()))
    out.append(("cancel", lease.cancel(queued[0]), lease.cancel(queued[1]),
                lease.cancel(held[0])))
    for t in held[:capacity]:
        lease.release(t)
        out.append(("release", lease.dead_skipped, lease.headroom(),
                    lease.queue_depth(), [lease.granted(t) for t in queued],
                    [lease.bucket_state(t) for t in queued]))
    out.append(("end", lease.wait_telemetry(), lease.outstanding(),
                sorted((k, kv.get(k)) for k in kv.keys(""))))
    return out


@pytest.mark.parametrize("capacity", [1, 3])
def test_lease_sequence_matches_reference(capacity):
    """Tickets, grants, tombstone skips, bucket keys and their pokes,
    heartbeat ages and the whole KV store equal the reference's."""
    out = _same(_lease_script, capacity)
    assert out[0][1][-1] is None  # full after `capacity` fast acquires
    assert out[3][1] and out[3][2] and not out[3][3]


def test_backoff_jitter_seed_deterministic():
    a = tc.DistributedTicketLease(tc.KVStore(), "j", backoff_seed=42)
    b = tc.DistributedTicketLease(tc.KVStore(), "j", backoff_seed=42)
    r = jc.DistributedTicketLease(jc.KVStore(), "j", backoff_seed=42)
    draws = [[x._jitter.random() for _ in range(8)] for x in (a, b, r)]
    assert draws[0] == draws[1] == draws[2]


# ---------------------------------------------- threaded lease waiting ----


def test_lease_fifo_and_queue_depth():
    lease = tc.DistributedTicketLease(tc.KVStore(), "ckpt", capacity=1)
    order = []

    def worker(i):
        lease.acquire()
        order.append(i)
        time.sleep(0.01)
        lease.release()

    ts = []
    for i in range(4):
        t = threading.Thread(target=worker, args=(i,))
        t.start()
        time.sleep(0.02)  # serialize ticket issuance
        ts.append(t)
    for t in ts:
        t.join(timeout=30)
    assert order == [0, 1, 2, 3]  # FCFS across "hosts"
    assert lease.queue_depth() == 0


def test_contended_acquires_fcfs_with_backoff():
    lease = tc.DistributedTicketLease(tc.KVStore(), "bk", capacity=2,
                                      backoff_seed=7, backoff_base=0.001,
                                      backoff_cap=0.02)
    order = []
    lock = threading.Lock()

    def worker(i):
        t = lease.acquire(timeout=10.0)
        with lock:
            order.append((t, i))
        time.sleep(0.01)
        lease.release()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
        time.sleep(0.002)  # stagger submissions so tickets are ordered
    for t in threads:
        t.join()
    tickets = [t for t, _ in sorted(order)]
    assert len(tickets) == 6 and len(set(tickets)) == 6
    tel = lease.wait_telemetry()
    assert tel["acquires"] == 6
    assert tel["timeouts"] == 0
    assert tel["queue_depth"] == 0
    assert tel["heartbeats"] >= 6  # at least the holder baseline each


def test_heartbeat_renewal_and_age():
    lease = tc.DistributedTicketLease(tc.KVStore(), "hb", capacity=1,
                                      backoff_seed=1)
    assert lease.heartbeat_age(999) is None  # never breathed
    t = lease.acquire(timeout=5.0)
    age = lease.heartbeat_age(t)
    assert age is not None and age < 1.0
    before = lease.retry_counts["heartbeats"]
    lease.renew(t)
    assert lease.retry_counts["heartbeats"] == before + 1
    lease.release()


def test_waiter_renews_heartbeat_while_queued():
    kv = tc.KVStore()
    lease = tc.DistributedTicketLease(kv, "wq", capacity=1, backoff_seed=3,
                                      heartbeat_interval=0.02,
                                      backoff_base=0.001, backoff_cap=0.01)
    lease.acquire(timeout=5.0)  # hold the only slot
    got = []
    th = threading.Thread(target=lambda: got.append(lease.acquire(
        timeout=5.0)))
    th.start()
    time.sleep(0.15)  # the queued waiter must have renewed by now
    waiting_ticket = kv.get("wq/ticket") - 1  # the newest ticket drawn
    assert lease.heartbeat_age(waiting_ticket) is not None
    assert lease.heartbeat_age(waiting_ticket) < 1.0
    lease.release()
    th.join()
    assert got and got[0] == waiting_ticket
    lease.release()


def _timeout_not_wedged(mod):
    """`tests/test_admission.py`'s cluster scenario: a dying host abandons
    its wait; the release path skips its tombstone so the next live host
    proceeds."""
    lease = mod.DistributedTicketLease(mod.KVStore(), "ckpt", capacity=1,
                                       backoff_seed=5)
    lease.acquire()
    with pytest.raises(TimeoutError):
        lease.acquire(timeout=0.15)  # dying host: tombstoned, not wedged
    got = []
    live = threading.Thread(
        target=lambda: got.append(lease.acquire(timeout=5.0)))
    live.start()
    time.sleep(0.05)
    lease.release()  # skips the dead ticket
    live.join(5)
    timeouts = lease.wait_telemetry()["timeouts"]
    waited = lease.retry_counts["near"] + lease.retry_counts["far"] >= 1
    lease.release()
    return got, lease.dead_skipped, timeouts, waited, lease.queue_depth()


def test_lease_timeout_does_not_wedge_grant_sequence():
    got, skipped, timeouts, waited, depth = _same(_timeout_not_wedged)
    assert got == [2] and skipped == 1 and timeouts == 1 and waited
    assert depth == 0


def test_bucket_keys_depend_on_the_process_hash_seed():
    """A reference fault the port copies bit for bit: a lease salts its
    bucket keys with ``hash(name)``, which Python seeds per process
    (PYTHONHASHSEED), so two processes key the same ticket's bucket
    differently — a releaser in one pokes a bucket a waiter in another
    does not watch (it then wakes by its backoff timeout).  Both sides
    agree within a process and disagree across hash seeds alike."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import json; "
            "from repro_torch.runtime import coordinator as t; "
            "from repro.runtime import coordinator as r; "
            "print(json.dumps([[m.DistributedTicketLease(m.KVStore(), 'ckpt')"
            "._bucket_key(k) for k in range(8)] for m in (t, r)]))")
    src = str(Path(__file__).resolve().parents[1] / "src")
    keys = {}
    for seed in ("1", "2"):
        port, ref = json.loads(subprocess.run(
            [sys.executable, "-c", code], check=True, capture_output=True,
            text=True, env={**os.environ, "PYTHONPATH": src,
                            "PYTHONHASHSEED": seed}).stdout)
        assert port == ref
        keys[seed] = ref
    assert keys["1"] != keys["2"]
