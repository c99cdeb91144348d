"""Listing 1 — Ticket-Semaphore.

A semaphore built from the ticket-lock idea: 64-bit unsigned ``Ticket`` and
``Grant`` counters; ``take`` performs an atomic fetch_add on Ticket and waits
until ``Grant - ticket > 0`` (magnitude comparison — multiple posters may
increment Grant concurrently, so equality checks are insufficient); ``post``
atomically increments Grant.  64-bit counters make roll-over a non-issue
(<200 years at 1 increment/ns).

Strict first-come-first-served admission, assuming fetch_add is wait-free.
Simple, compact, extremely low latency uncontended — but *global spinning*
on Grant causes coherence storms as thread counts grow (the problem TWA
solves).

Waiting modes:
  - "spin":      the paper's Listing 1 verbatim (Pause() decorated polling).
  - "broadcast": parking variant — every waiter blocks on one shared event
                 and *every* post wakes *all* waiters (thundering herd).
                 This is the natural futex-on-Grant port and is the honest
                 parking counterpart for comparing against TWA's selective
                 wakeup in semabench.
"""

from __future__ import annotations

import threading

from .atomics import AtomicU64
from .parking import pause

_U64_HALF = 1 << 63


def _dist(grant: int, ticket: int) -> int:
    """Signed 64-bit distance grant - ticket (wrap-safe)."""
    d = (grant - ticket) & ((1 << 64) - 1)
    return d - (1 << 64) if d >= _U64_HALF else d


class TicketSemaphore:
    def __init__(self, count: int = 0, waiting: str = "spin"):
        assert count >= 0
        assert waiting in ("spin", "broadcast")
        self.ticket = AtomicU64(0)
        self.grant = AtomicU64(count)
        self._waiting = waiting
        # broadcast mode: single condition shared by all waiters (herd).
        self._cond = threading.Condition()

    # -- the semaphore interface ------------------------------------------
    def take(self) -> None:
        tx = self.ticket.fetch_add(1)
        dx = _dist(self.grant.load(), tx)
        if dx > 0:  # fast-path uncontended return
            return
        if self._waiting == "spin":
            while True:
                dx = _dist(self.grant.load(), tx)
                if dx > 0:
                    return
                pause()
        else:  # broadcast parking: wait on the shared condition
            with self._cond:
                while _dist(self.grant.load(), tx) <= 0:
                    self._cond.wait()

    def post(self, n: int = 1) -> None:
        self.grant.fetch_add(n)
        if self._waiting == "broadcast":
            with self._cond:
                self._cond.notify_all()  # thundering herd — the point.

    # -- introspection ------------------------------------------------------
    def queue_depth(self) -> int:
        """Waiters in line = max(0, ticket - grant). The ticket/grant pair is
        free telemetry — the runtime uses this for backpressure/stragglers."""
        return max(0, -_dist(self.grant.load(), self.ticket.load()))

    def available(self) -> int:
        return max(0, _dist(self.grant.load(), self.ticket.load()))
