"""Two-level weighted TWA-semaphore tree: global slots → per-tenant QoS.

The paper's flat TWA semaphore gives scalable FCFS over ONE queue; a
multi-tenant engine needs isolation: tenant A's burst must not starve
tenant B, and a paying tier should get a larger admission share.  The tree:

  root   — a conserved pool of S global slots (a counter guarded by the
           tree lock; slots only move, never duplicate);
  leaves — one TWA semaphore per tenant (``cancellation=True``), all
           sharing one process-global waiting array, so a release pokes
           O(freed-slots) buckets no matter how many thousands of tenants
           exist — the paper's dispersal argument applied across the tree.

Weighted replenishment is **stride scheduling**: every leaf carries a
virtual ``pass_``; granting a slot to a leaf advances its pass by
``1/weight``; a freed slot goes to the *waiting* leaf with the minimum
pass.  Under saturation the admission shares converge to the weights;
idle tenants are caught up to the global virtual time when they re-enter
so they cannot hoard credit (work-conserving: if nobody waits, the slot
parks in the root free pool and the next arrival, any tenant, takes it).

FCFS holds *within* a tenant (leaf ticket order, tombstone-skip for
abandoned waiters); *across* tenants the order is weighted-fair by
construction: weighted grant replenishment.

Cancellation interplay: a tombstoned waiter whose slot was already posted
to its leaf leaves the unit parked at an idle leaf; ``_reclaim_idle``
pulls such stranded units back into the root pool (a take against one's
own idle leaf is non-blocking by the fast-path invariant) and re-runs the
weighted grant so the slot reaches whoever is actually waiting.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..core.twa_semaphore import TWASemaphore, WaitingArray
from .cancellable import CancelStats, CancellableTake


@dataclass
class _Leaf:
    tenant_id: str
    weight: float
    sem: TWASemaphore
    pass_: float = 0.0  # stride virtual time; +1/weight per granted slot
    granted: int = 0  # slots ever granted to this tenant (share telemetry)
    admitted: int = 0  # acquires that succeeded
    cancelled: int = 0  # acquires abandoned (timeout/deadline/explicit)
    stats: CancelStats = field(default_factory=CancelStats)


class HierarchicalTWASemaphore:
    """Root slot pool + per-tenant cancellable TWA leaves."""

    def __init__(self, total_slots: int, *, waiting: str = "futex",
                 array: WaitingArray | None = None,
                 long_term_threshold: int = 1):
        assert total_slots >= 0
        self.total_slots = total_slots
        self._free = total_slots  # unassigned slots at the root
        self._waiting = waiting
        self._threshold = long_term_threshold
        # One waiting array for the WHOLE tree (paper: process-global).
        self._array = array if array is not None else WaitingArray()
        self._leaves: dict[str, _Leaf] = {}
        self._lock = threading.Lock()
        self._vtime = 0.0

    # -- tenants -----------------------------------------------------------

    def register(self, tenant_id: str, weight: float = 1.0) -> None:
        assert weight > 0
        with self._lock:
            if tenant_id in self._leaves:
                self._leaves[tenant_id].weight = weight
                return
            sem = TWASemaphore(0, waiting=self._waiting,
                               long_term_threshold=self._threshold,
                               array=self._array, cancellation=True)
            self._leaves[tenant_id] = _Leaf(tenant_id, weight, sem,
                                            pass_=self._vtime)

    def _leaf(self, tenant_id: str) -> _Leaf:
        leaf = self._leaves.get(tenant_id)
        if leaf is None:
            raise KeyError(f"unregistered tenant {tenant_id!r}")
        return leaf

    # -- weighted grant (root → leaf) --------------------------------------

    def _charge_locked(self, leaf: _Leaf) -> None:
        # Idle catch-up then stride advance; _vtime tracks the granted pass
        # so re-entering tenants cannot replay banked idle time.
        leaf.pass_ = max(leaf.pass_, self._vtime)
        self._vtime = leaf.pass_
        leaf.pass_ += 1.0 / leaf.weight
        leaf.granted += 1

    def _grant_one_locked(self) -> None:
        """Route one free slot: min-pass waiting leaf, else the root pool."""
        waiting = [l for l in self._leaves.values()
                   if l.sem.live_queue_depth() > 0]
        if not waiting:
            self._free += 1
            return
        leaf = min(waiting, key=lambda l: (max(l.pass_, self._vtime),
                                           l.tenant_id))
        self._charge_locked(leaf)
        leaf.sem.post(1)

    def _reclaim_idle_locked(self) -> int:
        """Pull stranded units (tombstone-skipped past every live waiter of
        their leaf) back to the root and re-grant them."""
        reclaimed = 0
        for leaf in self._leaves.values():
            while leaf.sem.available() > 0 and leaf.sem.live_queue_depth() == 0:
                leaf.sem.take()  # non-blocking: available() > 0 fast path
                leaf.granted -= 1
                leaf.pass_ -= 1.0 / leaf.weight  # refund the stride charge
                reclaimed += 1
        for _ in range(reclaimed):
            self._grant_one_locked()
        return reclaimed

    # -- the semaphore surface ---------------------------------------------

    def acquire(self, tenant_id: str, *, timeout: float | None = None,
                deadline: float | None = None) -> bool:
        """Take one slot for ``tenant_id``.  Blocks FCFS within the tenant,
        weighted-fair across tenants.  Returns False iff abandoned at the
        timeout/deadline (the ticket is tombstoned, later live waiters are
        unaffected)."""
        if deadline is None and timeout is not None:
            deadline = time.monotonic() + timeout
        with self._lock:
            leaf = self._leaf(tenant_id)
            leaf.pass_ = max(leaf.pass_, self._vtime)  # idle catch-up
            if self._free > 0:
                # Work-conserving fast path: free slots mean nobody is
                # waiting anywhere — grant immediately, charged as usual.
                self._free -= 1
                self._charge_locked(leaf)
                leaf.sem.post(1)
            handle = CancellableTake(leaf.sem, leaf.stats)
        got = handle.wait(deadline)
        with self._lock:
            if got:
                leaf.admitted += 1
            else:
                leaf.cancelled += 1
                self._reclaim_idle_locked()
        return got

    def release(self, tenant_id: str | None = None) -> None:
        """Return one slot to the root; it flows to the min-pass waiting
        tenant (stride) or back to the free pool."""
        with self._lock:
            self._reclaim_idle_locked()
            self._grant_one_locked()

    # -- telemetry ----------------------------------------------------------

    def queue_depths(self) -> dict[str, int]:
        with self._lock:
            return {t: l.sem.live_queue_depth() for t, l in self._leaves.items()}

    def shares(self) -> dict[str, float]:
        """Fraction of all granted slots per tenant (→ weights under
        saturation)."""
        with self._lock:
            total = sum(l.granted for l in self._leaves.values())
            return {t: (l.granted / total if total else 0.0)
                    for t, l in self._leaves.items()}

    def telemetry(self) -> dict:
        with self._lock:
            return {
                "free": self._free,
                "vtime": self._vtime,
                "tenants": {
                    t: {"weight": l.weight, "granted": l.granted,
                        "admitted": l.admitted, "cancelled": l.cancelled,
                        "queue_depth": l.sem.live_queue_depth(),
                        "tombstones_skipped": l.sem.tombstones_skipped}
                    for t, l in self._leaves.items()
                },
            }
