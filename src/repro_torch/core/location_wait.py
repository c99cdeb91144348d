"""Listing 5 — TWA-Semaphore implemented with a LocationWait() primitive.

Differences from Listing 3's chains, per the paper:
  * the WaitElement lives in **TLS** (one per thread), not on-stack, because
    an element may be *abandoned* on a chain when the caller's condition
    becomes true while emplaced ("deferred lazy removal") — it is recovered
    on the next waiting episode (or at thread destruction);
  * therefore orphaned elements cannot propagate wakeups, so ``Poke`` must
    **walk** the chain via explicit ``Succ`` links (LD-CAS push publishes
    them) instead of relying on systolic waiter-to-waiter propagation;
  * ``LocationWait`` is an unrolled state machine alternating *emplace* and
    *wait* phases — the emplace call returns immediately (a deliberate
    "spurious" return) so the caller re-evaluates its condition between
    phases, closing the Dekker race:
        WakeAll : ST Cond ; SWAP Chain(None)
        Wait    : SWAP Chain(E) ; LD Cond
"""

from __future__ import annotations

import threading

from .atomics import AtomicInt, AtomicRef, AtomicU64
from .hashfn import index_for, mix32a, twa_hash
from .parking import pause
from .ticket_semaphore import _dist

DEFAULT_TABLE_SIZE = 4096
DEFAULT_LONG_TERM_THRESHOLD = 1


class WaitSlot:
    __slots__ = ("chain",)

    def __init__(self):
        self.chain: AtomicRef["TLSWaitElement"] = AtomicRef(None)


class TLSWaitElement:
    """Thread-local wait element. ``where`` is owner-private (which slot this
    element currently resides on, None if free-floating); ``succ`` is the
    published stack link."""

    __slots__ = ("gate", "where", "succ")

    def __init__(self):
        self.gate = AtomicInt(0)
        self.where: WaitSlot | None = None
        self.succ: AtomicRef[TLSWaitElement] = AtomicRef(None)

    def cleanup(self) -> None:
        """The C++ thread-exit DTOR: if we died while emplaced and not yet
        poked, flush that chain so our element cannot occlude successors."""
        if self.where is not None and self.gate.load() == 0:
            poke_walk(self.where.chain.exchange(None))
            while self.gate.load() == 0:
                pause()
        self.where = None
        self.succ.store(None)


_tls = threading.local()


def _tls_element() -> TLSWaitElement:
    e = getattr(_tls, "element", None)
    if e is None:
        e = TLSWaitElement()
        _tls.element = e
    return e


def tls_cleanup() -> None:
    """Explicit analogue of the TLS destructor registration
    (_cxa_thread_atexit); worker threads call this before exiting."""
    e = getattr(_tls, "element", None)
    if e is not None:
        e.cleanup()


def poke_walk(e: TLSWaitElement | None) -> None:
    """Poke that WALKS the chain: orphaned (abandoned) elements cannot be
    relied on to propagate, so the waker visits every element."""
    while e is not None:
        k = e
        e = k.succ.load()
        assert e is not k
        k.gate.store(1)


class SlotTable:
    def __init__(self, table_size: int = DEFAULT_TABLE_SIZE):
        assert table_size > 0 and (table_size & (table_size - 1)) == 0
        self.table_size = table_size
        self.slots = [WaitSlot() for _ in range(table_size)]

    def index_to_bucket(self, key: int) -> WaitSlot:
        return self.slots[index_for(key, self.table_size)]


_GLOBAL_SLOTS = SlotTable()


def location_wait(s: WaitSlot) -> None:
    """Advance the thread-local state machine (emplace phase / wait phase)."""
    assert s is not None
    e = _tls_element()
    where = e.where
    if where is s:
        # Previously emplaced on the correct chain — actually wait.
        while e.gate.load() == 0:
            pause()
        e.succ.store(None)  # hygiene
        e.where = None
        return
    if where is not None:
        # Residual residency on the WRONG chain (abandoned orphan) —
        # deferred recovery: extricate E before reusing it.
        if e.gate.load() == 0:
            poke_walk(where.chain.exchange(None))
            while e.gate.load() == 0:
                pause()
        e.where = None
        e.succ.store(None)
    # E is free-floating and privatized. Emplace on chain s.
    e.where = s
    e.gate.store(0)
    e.succ.store(None)
    succ = s.chain.cas(None, e)  # optimistic: slots are mostly empty
    if succ is None:
        return
    while True:
        assert succ is not e
        e.succ.store(succ)  # tentative, in anticipation of a successful CAS
        v = s.chain.cas(succ, e)
        if v is succ:
            break
        succ = v  # raced and lost; some other thread progressed — retry
    # Intentional immediate return: caller re-evaluates its condition, the
    # NEXT call actually waits.


def location_wake_all(s: WaitSlot) -> None:
    assert s is not None
    poke_walk(s.chain.exchange(None))


class TWASemaphoreV3:
    """Listing 5's semaphore over LocationWait/LocationWakeAll."""

    def __init__(
        self,
        count: int = 0,
        table: SlotTable | None = None,
        long_term_threshold: int = DEFAULT_LONG_TERM_THRESHOLD,
    ):
        assert count >= 0
        self.ticket = AtomicU64(0)
        self.grant = AtomicU64(count)
        self.table = table if table is not None else _GLOBAL_SLOTS
        self.threshold = long_term_threshold
        self._addr = mix32a(id(self) & 0xFFFFFFFF)

    def _twa_hash(self, ticket: int) -> int:
        return twa_hash(self._addr, ticket)

    def take(self) -> None:
        tx = self.ticket.fetch_add(1)
        if _dist(self.grant.load(), tx) > 0:
            return  # fast-path uncontended
        s = self.table.index_to_bucket(self._twa_hash(tx))
        while True:
            if _dist(self.grant.load(), tx) > 0:
                return
            location_wait(s)

    def post(self, n: int = 1) -> None:
        for _ in range(n):
            g = self.grant.fetch_add(1)
            # Benaphore-style racy-but-conservative fast path.
            dx = _dist(g, self.ticket.load())
            if dx >= 0:
                continue
            location_wake_all(self.table.index_to_bucket(self._twa_hash(g)))

    def post_conservative(self, n: int = 1) -> None:
        """SemaPostConservative — no fast path, wakes successor's successor
        (grant + threshold)."""
        for _ in range(n):
            g = self.grant.fetch_add(1)
            g += self.threshold
            location_wake_all(self.table.index_to_bucket(self._twa_hash(g)))

    def queue_depth(self) -> int:
        return max(0, -_dist(self.grant.load(), self.ticket.load()))

    def available(self) -> int:
        return max(0, _dist(self.grant.load(), self.ticket.load()))
