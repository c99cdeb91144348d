"""Listing 3 — TWA-Semaphore with address-based waiting chains.

The waiting-array elements become pointers to *chains* — lock-free concurrent
pop-stacks (push-one / detach-all) of on-stack ``WaitElement``s.  This converts
global spinning into local 1:1 waiting (at most one thread per Gate), which
makes waiting amenable to blocking primitives (park/unpark, futex).

Key properties transcribed from the paper:
  * arriving threads push themselves with an atomic exchange (SWAP);
  * linkage is implicit — each thread remembers ``prv`` (what it displaced),
    like CLH locks; no intrusive next pointers;
  * notification detaches the ENTIRE chain with exchange(None) and pokes the
    first element; each woken waiter pokes its ``prv`` — systolic propagation;
  * wake-one/wake-all policy ⇒ spurious wakeups are benign; callers must
    re-evaluate their condition (AddressWaitUntil is "strict and persistent");
  * hash collisions merely co-locate independent waiters on one chain;
  * the mis-queue recovery path (condition became true between push and
    ratify) attempts, in order: CAS-undo of the push; detecting an already-
    completed flush; detecting own Gate already set; full flush-and-wait.

Dekker duality pivot (the lost-wakeup proof obligation):
    Wait : ST Chain ; LD Condition
    Post : ST Condition ; LD Chain
"""

from __future__ import annotations

from .atomics import AtomicInt, AtomicRef, AtomicU64
from .hashfn import index_for, mix32a, twa_hash
from .parking import ParkToken, self_token, unpark
from .ticket_semaphore import _dist

DEFAULT_TABLE_SIZE = 4096

# Defensive bound on a single park() so that a *bug-induced* lost wakeup
# degrades to slow polling instead of a hang; the algorithm treats any early
# return as a spurious wakeup (allowed by design) and re-checks Gate.
_PARK_QUANTUM = 0.05


class WaitElement:
    """Per-waiting-episode element (``alignas(128)`` in C++ — here a plain
    object, naturally unshared). ``gate``: made-ready flag. ``who``: park
    identity."""

    __slots__ = ("gate", "who")

    def __init__(self):
        self.gate = AtomicInt(0)
        self.who: ParkToken | None = None


class WaitChain:
    __slots__ = ("chain",)

    def __init__(self):
        self.chain: AtomicRef[WaitElement] = AtomicRef(None)


class ChainTable:
    """Flat hashtable of WaitChain buckets (process-wide)."""

    def __init__(self, table_size: int = DEFAULT_TABLE_SIZE):
        assert table_size > 0 and (table_size & (table_size - 1)) == 0
        self.table_size = table_size
        self.slots = [WaitChain() for _ in range(table_size)]

    def key_to_chain(self, key: int) -> WaitChain:
        return self.slots[index_for(key, self.table_size)]


_GLOBAL_CHAINS = ChainTable()


def poke(e: WaitElement | None) -> None:
    if e is None:
        return
    who = e.who
    e.gate.store(1)
    # After gate=1 `e` may fall out of scope; unparking a stale token is safe.
    unpark(who)


def address_signal(key: int, table: ChainTable = _GLOBAL_CHAINS) -> None:
    slot = table.key_to_chain(key)
    poke(slot.chain.exchange(None))


def address_signal_polite(key: int, table: ChainTable = _GLOBAL_CHAINS) -> None:
    """Avoids mutating an already-empty chain pointer (less coherence traffic)."""
    slot = table.key_to_chain(key)
    if slot.chain.load() is not None:
        poke(slot.chain.exchange(None))


def _park_until_gate(e: WaitElement) -> None:
    tok = e.who
    while e.gate.load() == 0:
        tok.park(_PARK_QUANTUM)


def address_wait_until(key: int, satisfied, table: ChainTable = _GLOBAL_CHAINS):
    """Wait (parking) until ``satisfied()`` returns truthy; returns its value.

    Strict/persistent: re-pushes and resumes waiting after spurious wakeups
    (flushes, hash collisions) until the condition holds.
    """
    v = satisfied()
    if v:
        return v
    s = table.key_to_chain(key)
    while True:
        # Cheap re-check before becoming a visible waiter.
        v = satisfied()
        if v:
            return v
        e = WaitElement()
        e.who = self_token()
        prv = s.chain.exchange(e)
        assert prv is not e
        # Ratify: close the race against a concurrent address_signal.
        v = satisfied()
        if v:
            # Mis-queued — recover. We cannot return until E is off-chain
            # (privatized) and successors have been notified.
            k = s.chain.cas(e, prv)  # try to simply undo the push
            if k is e:
                assert e.gate.load() == 0
                return v
            if k is None:
                # A signaller flushed the chain (detaching E) in the window.
                poke(prv)
                _park_until_gate(e)
                return v
            if e.gate.load() != 0:
                # Already flushed & poked — skip the full flush.
                poke(prv)
                return v
            # Full chain flush: eject and wake everyone (suffix first — see
            # paper QoI note), then wait until our own Gate confirms that E
            # is detached and privatized.
            prefix = s.chain.exchange(None)
            assert (prv is not prefix) or (prv is None and prefix is None)
            poke(prv)
            poke(prefix)
            _park_until_gate(e)
            return v
        # Properly enqueued — wait politely (dominant case).
        _park_until_gate(e)
        # Systolic wakeup propagation through the rest of the stack.
        poke(prv)
        # We may have been woken by a flush or a hash collision — loop and
        # re-evaluate; if needed we re-push and resume waiting.


class TWASemaphoreChains:
    """Listing 3's SemaTake/SemaPost on waiting chains (threshold elided, as
    in the paper's listing)."""

    def __init__(self, count: int = 0, table: ChainTable | None = None):
        assert count >= 0
        self.ticket = AtomicU64(0)
        self.grant = AtomicU64(count)
        self.table = table if table is not None else _GLOBAL_CHAINS
        self._addr = mix32a(id(self) & 0xFFFFFFFF)

    def take(self) -> None:
        tx = self.ticket.fetch_add(1)
        if _dist(self.grant.load(), tx) > 0:
            return  # fast-path uncontended
        key = twa_hash(self._addr, tx)
        address_wait_until(
            key, lambda: 1 if _dist(self.grant.load(), tx) > 0 else 0, self.table
        )
        assert _dist(self.grant.load(), tx) > 0

    def post(self, n: int = 1) -> None:
        for _ in range(n):
            g = self.grant.fetch_add(1)
            address_signal(twa_hash(self._addr, g), self.table)

    def queue_depth(self) -> int:
        return max(0, -_dist(self.grant.load(), self.ticket.load()))

    def available(self) -> int:
        return max(0, _dist(self.grant.load(), self.ticket.load()))
