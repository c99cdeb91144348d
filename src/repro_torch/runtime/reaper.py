"""Lease-heartbeat reaper — frees what dead holders leaked; the port of
``repro.runtime.reaper``, copied whole (it holds no JAX and runs on the
host; the leases are the port's `runtime.coordinator` copies).

`DistributedTicketLease` gives every outstanding ticket a heartbeat key
(waiters renew it from their wait loop, holders via ``renew()``).  A
process that vanishes — crash, partition, live-lock — stops renewing but
its ticket still occupies the grant sequence: a leaked *waiter* ticket
will wedge FCFS hand-off when grant reaches it, a leaked *holder* ticket
is a capacity unit lost forever.  The reaper closes both leaks with the
tombstone protocol the lease already implements:

* stale **waiter** (grant has not reached the ticket) → ``cancel()``:
  the ticket is tombstoned and release()'s skip-aware advance hops it,
  so the unit flows to the next live ticket;
* stale **holder** (grant covers the ticket) → cancel() returns False,
  meaning the lease is held — the reaper force-``release()``\\ s it on
  the dead holder's behalf, returning the unit to the pool and poking
  the successor's waiting-array bucket.

Either way the heartbeat key is deleted, so one leak is reaped exactly
once.  TTL tuning is a detection-latency / false-positive trade: the TTL
must exceed the longest renewal gap a *live* client can have (a slow
megastep, a GC pause, a tolerable KV blip), and every TTL second is a
second of capacity held by a corpse.

The reaper is deliberately dumb: it frees tickets and reports what it
did.  *Policy* — declaring a replica dead because its tickets went
stale, migrating its in-flight work — belongs to the caller
(`serving.router.ReplicaRouter` consumes the report); a reaper that
made policy decisions would need the membership view, and then two
components would own it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class ReapAction:
    lease: str     # lease name
    ticket: int
    action: str    # "cancelled" (waiter tombstoned) | "released" (holder freed)
    age: float     # heartbeat age at reap time (seconds past TTL implied)


class LeaseReaper:
    """TTL scanner over a set of leases (one per replica, typically).

    ``scan()`` is the deterministic single-shot pass a control loop calls
    once per round (virtual-clock friendly); ``run()`` wraps it in a
    daemon thread for wall-clock deployments.  ``on_reap`` (if given) is
    called with each :class:`ReapAction` as it happens.
    """

    def __init__(self, leases, *, ttl: float, on_reap=None):
        self.leases = list(leases)
        self.ttl = float(ttl)
        self.on_reap = on_reap
        self.actions: list[ReapAction] = []  # full reap history
        self._stop = threading.Event()
        self._thread = None

    def add(self, lease) -> None:
        """Track another lease (e.g. a warm-takeover successor replica)."""
        self.leases.append(lease)

    # ------------------------------------------------------------- scan ----

    def scan(self) -> list[ReapAction]:
        """One pass: reap every outstanding ticket whose heartbeat age
        exceeds the TTL.  Returns this pass's actions (also appended to
        :attr:`actions`)."""
        out: list[ReapAction] = []
        for lease in self.leases:
            for t in lease.outstanding():
                age = lease.heartbeat_age(t)
                if age is None or age <= self.ttl:
                    continue
                if lease.cancel(t):
                    act = ReapAction(lease.name, t, "cancelled", age)
                else:
                    # grant already covers it: a leaked HOLDER — free the
                    # unit on the corpse's behalf (deletes the hb key)
                    lease.release(t)
                    act = ReapAction(lease.name, t, "released", age)
                out.append(act)
                if self.on_reap is not None:
                    self.on_reap(act)
        self.actions.extend(out)
        return out

    # -------------------------------------------------- wall-clock loop ----

    def run(self, interval: float = 0.25) -> "LeaseReaper":
        """Start the daemon scan loop (wall-clock deployments)."""
        def loop():
            while not self._stop.wait(interval):
                self.scan()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -------------------------------------------------------- telemetry ----

    def telemetry(self) -> dict:
        cancelled = sum(1 for a in self.actions if a.action == "cancelled")
        released = sum(1 for a in self.actions if a.action == "released")
        return {"reaped": len(self.actions), "cancelled": cancelled,
                "released": released, "leases": len(self.leases)}


def leases_clean(leases) -> dict:
    """Exit-time lease audit: after a drained run + reaper passes, every
    lease's grant sequence must be CLEAN — no queued tickets, full
    headroom (grant − ticket == capacity), no outstanding heartbeat keys.
    Any leaked ticket the reaper missed shows up here."""
    violations = []
    for lease in leases:
        hr = lease.headroom()
        if hr != lease.capacity:
            violations.append(
                f"{lease.name}: headroom {hr} != capacity {lease.capacity} "
                "(leaked or double-released ticket)")
        if lease.queue_depth() > 0:
            violations.append(
                f"{lease.name}: {lease.queue_depth()} tickets still queued")
        stale = lease.outstanding()
        if stale:
            violations.append(f"{lease.name}: heartbeat keys left for "
                              f"tickets {stale}")
    return {"ok": not violations, "violations": violations}


__all__ = ["LeaseReaper", "ReapAction", "leases_clean"]
