"""Listing 4 — TWA-Semaphore with MONITOR-MWAIT inspired waiting channels.

Each channel augments the waiting chain with an ``UpdateSequence`` counter:
``KeyMonitor`` samples the sequence ("arm the monitor"), ``KeyWait`` blocks
until the sequence moves — the sequence is a conservative *proxy* for the
condition of interest, exactly like MESI-state proxies under hardware
MONITOR-MWAIT / WFET.

    Indirection:  Location value → WaitChannel.Sequence → WaitElement.Gate
    Dekker pivot: Signal : ST Cond ; ST Sequence ; LD Chain
                  Wait   : LD Sequence ; LD Cond ; ST Chain ; LD Sequence

KeyMonitor is passive (no store, nothing emplaced) so no abort operator is
needed — the cost is one more level of indirection on the wait path.
"""

from __future__ import annotations

from .atomics import AtomicRef, AtomicU64
from .hashfn import index_for, mix32a, twa_hash
from .parking import self_token
from .ticket_semaphore import _dist
from .waiting_chains import WaitElement, _park_until_gate, poke

DEFAULT_TABLE_SIZE = 4096


class WaitChannel:
    __slots__ = ("chain", "sequence")

    def __init__(self):
        self.chain: AtomicRef[WaitElement] = AtomicRef(None)
        self.sequence = AtomicU64(0)


class ChannelTable:
    def __init__(self, table_size: int = DEFAULT_TABLE_SIZE):
        assert table_size > 0 and (table_size & (table_size - 1)) == 0
        self.table_size = table_size
        self.slots = [WaitChannel() for _ in range(table_size)]

    def key_to_channel(self, key: int) -> WaitChannel:
        return self.slots[index_for(key, self.table_size)]


_GLOBAL_CHANNELS = ChannelTable()


def key_monitor(ch: WaitChannel) -> int:
    return ch.sequence.load()


def key_signal(ch: WaitChannel) -> None:
    ch.sequence.fetch_add(1)
    poke(ch.chain.exchange(None))


def key_signal_polite(ch: WaitChannel) -> None:
    ch.sequence.fetch_add(1)
    if ch.chain.load() is not None:
        poke(ch.chain.exchange(None))


def key_wait(ch: WaitChannel, sequence: int) -> int:
    """Block until ch.sequence != sequence (proxy wait). Strict/persistent."""
    while True:
        # Optional optimization: reduces mis-queue rate / futile flushing.
        if ch.sequence.load() != sequence:
            return 0
        e = WaitElement()
        e.who = self_token()
        prv = ch.chain.exchange(e)
        assert prv is not e
        # Ratify — close the race against a concurrent key_signal.
        if ch.sequence.load() != sequence:
            # Mis-queued; recover. (The CAS-undo of Listing 3 is intentionally
            # omitted — the paper argues it saves nothing here because a
            # displaced prv must re-check its sequence anyway.)
            if e.gate.load() != 0:
                poke(prv)  # already flushed off-chain
                return 0
            prefix = ch.chain.exchange(None)
            assert (prv is not prefix) or (prv is None and prefix is None)
            poke(prv)
            poke(prefix)
            _park_until_gate(e)
            return 0
        # Properly enqueued — dominant case.
        _park_until_gate(e)
        poke(prv)  # systolic propagation
        # Loop: we may have been purged by a flush or hash collision.


def key_wait_lazy(ch: WaitChannel, sequence: int) -> tuple[int, int]:
    """Listing 4's KeyWaitLazy — passes the observed sequence back (Python:
    returned). First call with a stale guess returns immediately, arming the
    caller's loop; usage avoids explicit KeyMonitor calls entirely."""
    us = sequence
    sequence = ch.sequence.load()
    if us != sequence:
        return 0, sequence
    e = WaitElement()
    e.who = self_token()
    prv = ch.chain.exchange(e)
    assert prv is not e
    new_seq = ch.sequence.load()
    if us != new_seq:
        sequence = new_seq
        if e.gate.load() != 0:
            poke(prv)
            return 0, sequence
        prefix = ch.chain.exchange(None)
        poke(prv)
        poke(prefix)
        _park_until_gate(e)
        return 0, sequence
    _park_until_gate(e)
    poke(prv)
    return 0, ch.sequence.load()  # lazy & relaxed — caller re-evaluates


class TWASemaphoreChannels:
    """Listing 4's SemaTake/SemaPost over monitor/wait channels."""

    def __init__(self, count: int = 0, table: ChannelTable | None = None):
        assert count >= 0
        self.ticket = AtomicU64(0)
        self.grant = AtomicU64(count)
        self.table = table if table is not None else _GLOBAL_CHANNELS
        self._addr = mix32a(id(self) & 0xFFFFFFFF)

    def take(self) -> None:
        tx = self.ticket.fetch_add(1)
        if _dist(self.grant.load(), tx) > 0:
            return
        ch = self.table.key_to_channel(twa_hash(self._addr, tx))
        while True:
            seq = key_monitor(ch)
            if _dist(self.grant.load(), tx) > 0:
                break
            key_wait(ch, seq)

    def post(self, n: int = 1) -> None:
        for _ in range(n):
            g = self.grant.fetch_add(1)
            key_signal(self.table.key_to_channel(twa_hash(self._addr, g)))

    def queue_depth(self) -> int:
        return max(0, -_dist(self.grant.load(), self.ticket.load()))

    def available(self) -> int:
        return max(0, _dist(self.grant.load(), self.ticket.load()))
