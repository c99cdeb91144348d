"""The port's lease reaper (`repro_torch.runtime.reaper`) against the JAX
package's copy (`repro.runtime.reaper`): the reaper tests of
`tests/test_coordinator.py` and further scripted lease sequences.

Each scenario runs on both packages (each reaper over its own package's
`DistributedTicketLease`, on a virtual clock) and the outcomes are held
equal: the `ReapAction`s of every scan (lease, ticket, action, age), the
reap history, ``telemetry()`` and ``leases_clean``'s report.  The
reference's own assertions are kept on the port.
"""

from __future__ import annotations

import dataclasses
import time

import pytest

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

from repro.runtime import coordinator as jc
from repro.runtime import reaper as jr
from repro_torch import runtime as truntime
from repro_torch.runtime import coordinator as tc
from repro_torch.runtime import reaper as tr

# package: (coordinator module, reaper module)
BOTH = {"port": (tc, tr), "jax": (jc, jr)}


def _acts(actions):
    return [dataclasses.astuple(a) for a in actions]


def _same(scenario, *args):
    """``scenario(coord, reaper, *args)`` on the port and on the
    reference: equal outcomes; returns the port's."""
    got, want = (scenario(*BOTH[k], *args) for k in ("port", "jax"))
    assert got == want
    return got


def _lease(cm, vc, capacity, name="cap"):
    return cm.DistributedTicketLease(cm.KVStore(), name, capacity=capacity,
                                     clock=lambda: vc[0])


def test_exports():
    assert truntime.LeaseReaper is tr.LeaseReaper
    assert truntime.ReapAction is tr.ReapAction
    assert truntime.leases_clean is tr.leases_clean


# ------------------------------------------ tests/test_coordinator.py ----


def _stale_holder_and_waiter(cm, rm):
    vc = [0.0]
    lease = _lease(cm, vc, 1)
    t0 = lease.try_acquire()     # holder
    assert t0 == 0
    t1 = lease.take_ticket()     # queued waiter behind it
    assert lease.granted(t1) is False
    reaper = rm.LeaseReaper([lease], ttl=2.0)
    vc[0] = 1.0
    first = reaper.scan()
    assert first == []           # inside TTL: nothing reaped
    vc[0] = 3.0
    second = reaper.scan()
    acts = {a.ticket: a.action for a in second}
    assert acts == {t0: "released", t1: "released"} or \
        acts == {t0: "released", t1: "cancelled"}
    audit = rm.leases_clean([lease])
    assert audit["ok"], audit["violations"]
    assert lease.outstanding() == []
    third = reaper.scan()
    assert third == []           # reaped exactly once
    return (_acts(second), _acts(reaper.actions), reaper.telemetry(), audit,
            lease.headroom(), lease.queue_depth(), lease.dead_skipped)


def test_reaper_frees_stale_holder_and_waiter():
    """One leaked holder and one leaked waiter on a capacity-1 lease: the
    stale waiter is cancelled (tombstone) or released, the stale holder
    force-released, the grant sequence clean — the same actions, ages and
    telemetry on both sides."""
    _same(_stale_holder_and_waiter)


def _spares_renewing_holder(cm, rm):
    vc = [0.0]
    lease = _lease(cm, vc, 2)
    live = lease.try_acquire()
    leak = lease.take_ticket()
    reaper = rm.LeaseReaper([lease], ttl=2.0)
    per_scan = []
    for step in range(1, 5):
        vc[0] = float(step)
        lease.renew(live)        # the live holder keeps its heartbeat
        per_scan.append(_acts(reaper.scan()))
    assert [a.ticket for a in reaper.actions] == [leak]
    assert lease.headroom() == 1  # live holder still holds its unit
    lease.release(live)
    audit = rm.leases_clean([lease])
    assert audit["ok"], audit["violations"]
    return per_scan, reaper.telemetry(), audit


def test_reaper_spares_renewing_holder():
    _same(_spares_renewing_holder)


# ------------------------------------------------- further sequences ----


def _many_leases(cm, rm, seed):
    """Random takes, acquires, renewals, releases and clock advances over
    three leases sharing one store, with ``add`` and ``on_reap``; the
    reaper scans after every step."""
    import random

    rng = random.Random(seed)
    vc = [0.0]
    kv = cm.KVStore()
    leases = [cm.DistributedTicketLease(kv, f"replica/{i}", capacity=2,
                                        clock=lambda: vc[0])
              for i in range(3)]
    seen = []
    reaper = rm.LeaseReaper(leases[:2], ttl=1.5,
                            on_reap=lambda a: seen.append((a.lease, a.ticket)))
    held: list[tuple[int, int]] = []  # live holders (renew, then release)
    scans = []
    for step in range(40):
        # a holder the reaper freed is gone: it neither renews nor releases
        held = [(i, t) for i, t in held if (f"replica/{i}", t) not in seen]
        op = rng.randrange(6)
        li = rng.randrange(3)
        lease = leases[li]
        if op == 0:
            lease.take_ticket()
        elif op == 1:
            t = lease.try_acquire()
            if t is not None:
                held.append((li, t))
        elif op == 2 and held:
            i, t = held[rng.randrange(len(held))]
            leases[i].renew(t)
        elif op == 3 and held:
            i, t = held.pop(rng.randrange(len(held)))
            leases[i].release(t)
        else:
            vc[0] += rng.uniform(0.0, 1.0)
        if step == 20:
            reaper.add(leases[2])
        scans.append(_acts(reaper.scan()))
    vc[0] += 10.0
    scans.append(_acts(reaper.scan()))
    assert seen == [(a.lease, a.ticket) for a in reaper.actions]
    audit = rm.leases_clean(leases)
    assert audit["ok"], audit["violations"]
    return (scans, reaper.telemetry(), audit,
            [(x.headroom(), x.queue_depth(), x.dead_skipped)
             for x in leases])


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10_000))
def test_reaper_scripted_sequences_match_reference(seed):
    """Leases that leak tickets at random points: every scan's actions,
    the telemetry and the final audit equal the reference's, the
    ``on_reap`` stream is the reap history, and after the last TTL every
    lease is clean."""
    _same(_many_leases, seed)


def _dirty_audit(cm, rm):
    vc = [0.0]
    kv = cm.KVStore()
    a = cm.DistributedTicketLease(kv, "a", capacity=2, clock=lambda: vc[0])
    b = cm.DistributedTicketLease(kv, "b", capacity=1, clock=lambda: vc[0])
    a.try_acquire()              # a holder never released
    b.try_acquire()
    b.take_ticket()              # a waiter still queued behind it
    return rm.leases_clean([a, b])


def test_leases_clean_reports_leaks():
    audit = _same(_dirty_audit)
    assert not audit["ok"] and len(audit["violations"]) >= 3


def _wall_clock_loop(cm, rm):
    vc = [0.0]
    lease = _lease(cm, vc, 1)
    leak = lease.take_ticket()
    reaper = rm.LeaseReaper([lease], ttl=1.0)
    vc[0] = 5.0
    reaper.run(interval=0.01)
    deadline = time.monotonic() + 10.0
    while not reaper.actions and time.monotonic() < deadline:
        time.sleep(0.01)
    reaper.stop()
    assert reaper._thread is None
    return _acts(reaper.actions), leak, reaper.telemetry()


def test_reaper_daemon_loop():
    """``run()`` scans on its own thread until ``stop()``: the leak is
    reaped once, as a scan would."""
    acts, leak, tel = _same(_wall_clock_loop)
    assert [a[1] for a in acts] == [leak] and tel["reaped"] == 1


@pytest.mark.parametrize("ttl", [0.5, 2.0])
def test_reaper_ttl_boundary(ttl):
    """An age equal to the TTL is spared; just past it is reaped."""

    def run(cm, rm):
        vc = [0.0]
        lease = _lease(cm, vc, 1)
        lease.take_ticket()
        lease.take_ticket()
        reaper = rm.LeaseReaper([lease], ttl=ttl)
        vc[0] = ttl
        at = _acts(reaper.scan())
        vc[0] = ttl + 0.01
        past = _acts(reaper.scan())
        return at, past, reaper.telemetry()

    at, past, _ = _same(run)
    assert at == [] and len(past) == 2
