"""Cancellable takes on a TWA semaphore — the tombstone protocol's host API.

Ticket semaphores are famously awkward to extend with timeout/cancellation:
an issued ticket holds a fixed position in the grant sequence and cannot
simply vanish (the same revocation problem Scalable Range Locks and the TWA
ticket-lock paper wrestle with).  `core.twa_semaphore` solves it with
tombstones + a skip-aware post; this module packages that into the two
shapes a production admission stack needs:

  * ``take_with_deadline`` / ``take_with_timeout`` — self-cancelling takes:
    the waiter itself abandons at its deadline, tombstoning its own ticket.
    A lost race (grant arrived exactly at expiry) reports *acquired* — the
    slot is never double-counted and never leaks.

  * ``CancellableTake`` — a handle whose ``cancel()`` may be called from a
    *different* thread (a reaper noticing a dead host, a client
    disconnect).  All resolution — waiter observing its grant, waiter
    timing out, external cancel — funnels through one handle lock, so
    exactly one outcome is decided even when a concurrent skip-aware post
    advances Grant past the ticket mid-cancel.

Stats (`CancelStats`) feed the serving telemetry: how many takes were
abandoned, and how many cancellations lost the race (a proxy for deadline
pressure sitting right at the admission latency).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..core.parking import pause
from ..core.ticket_semaphore import _dist
from ..core.twa_semaphore import TWASemaphore


@dataclass
class CancelStats:
    acquired: int = 0
    cancelled: int = 0
    lost_races: int = 0  # cancel attempts that found the slot already granted
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def bump(self, attr: str) -> None:
        with self._lock:
            setattr(self, attr, getattr(self, attr) + 1)


class CancellableTake:
    """One in-flight take whose cancellation may come from any thread.

    The waiter calls :meth:`wait`; anyone may call :meth:`cancel`.  The
    final outcome (acquired vs cancelled) is decided exactly once under
    ``_lock``; whichever side resolves first wins and the other observes.
    """

    def __init__(self, sema: TWASemaphore, stats: CancelStats | None = None):
        assert sema._cancellation, "semaphore must be built with cancellation=True"
        self.sema = sema
        self.stats = stats
        self.ticket = sema.ticket.fetch_add(1)
        self._lock = threading.Lock()
        self._outcome: bool | None = None  # True=acquired, False=cancelled
        self._resolved = threading.Event()

    # -- resolution (exactly-once) ----------------------------------------

    def _resolve_granted(self) -> bool:
        with self._lock:
            if self._outcome is None:
                self._outcome = True
                self._resolved.set()
            return self._outcome

    def _resolve_via_cancel(self) -> bool:
        """Tombstone the ticket unless the grant sequence already covered
        it.  Returns the final outcome (True means the cancel lost the race
        and the slot is held)."""
        with self._lock:
            if self._outcome is None:
                acquired = not self.sema.cancel(self.ticket)
                self._outcome = acquired
                self._resolved.set()
                # Wake a futex-parked waiter so it observes the outcome.
                self.sema.poke_ticket(self.ticket)
                if self.stats is not None:
                    if acquired:
                        self.stats.bump("lost_races")
                    else:
                        self.stats.bump("cancelled")
            return self._outcome

    def cancel(self) -> bool:
        """Abandon the take.  True: the ticket is tombstoned and will be
        skipped.  False: too late — the slot was already granted; the owner
        of the handle holds it and must release it normally."""
        return not self._resolve_via_cancel()

    # -- waiting -----------------------------------------------------------

    def wait(self, deadline: float | None = None) -> bool:
        """Block until granted, externally cancelled, or ``deadline``
        (absolute ``time.monotonic``).  Returns True iff the slot is held."""
        s = self.sema
        tx = self.ticket
        bucket = s.array.bucket_for(s._hash(s._addr, tx))
        mx = bucket.seq.load()
        while True:
            if self._resolved.is_set():
                return self._outcome
            dx = _dist(s.grant.load(), tx)
            if dx > 0:
                # Grant covers the ticket — but a concurrent cancel may have
                # tombstoned it first (the skip that advanced Grant past us
                # was *because* we were dead).  The handle lock arbitrates.
                got = self._resolve_granted()
                if got and self.stats is not None:
                    self.stats.bump("acquired")
                return got
            if deadline is not None and time.monotonic() >= deadline:
                return self._resolve_via_cancel()
            if (dx + s.threshold) > 0:
                pause()  # short-term: spin near Grant
                continue
            vx = mx
            bucket.wait_for_change(vx, s._spin_buckets, deadline)
            mx = bucket.seq.load()


def take_with_deadline(sema: TWASemaphore, deadline: float | None,
                       stats: CancelStats | None = None) -> bool:
    """Deadline-aware take (absolute ``time.monotonic`` deadline).  Only
    the waiter itself can abandon, so this rides the core ``take_until``
    directly — no handle machinery; use :class:`CancellableTake` when a
    *different* thread must be able to cancel."""
    got = sema.take_until(deadline)
    if stats is not None:
        stats.bump("acquired" if got else "cancelled")
    return got


def take_with_timeout(sema: TWASemaphore, timeout: float | None,
                      stats: CancelStats | None = None) -> bool:
    """Relative-timeout flavour of :func:`take_with_deadline`."""
    deadline = None if timeout is None else time.monotonic() + timeout
    return take_with_deadline(sema, deadline, stats)
