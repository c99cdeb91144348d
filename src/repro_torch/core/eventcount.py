"""EventCount & Sequencer (Reed & Kanodia 1979) via the TWA transformation.

The paper (§1) notes the ticket→TWA transformation "is readily applicable to
other synchronization constructs, such as EventCount and Sequencers".  This
module carries that out:

  Sequencer  — `ticket()`: a wait-free fetch-add dispenser (the paper's
               Ticket word stand-alone).
  EventCount — `advance()` / `read()` / `await_(v)`: await blocks until the
               count reaches v.  The classic implementation has every waiter
               sleep on ONE location (broadcast herd on every advance);
               TWA-EventCount disperses waiters over the hashed waiting
               array by their *awaited value* — advance(n) pokes exactly the
               buckets of values (count, count+n], so only the waiters whose
               condition may now hold are woken.

Together they reconstruct the classic eventcount/sequencer mutual-exclusion
and producer/consumer patterns with the paper's scalability shape, and they
share the process-global waiting array with TWASemaphore (collisions benign).
"""

from __future__ import annotations

from .atomics import AtomicU64
from .hashfn import twa_hash
from .ticket_semaphore import _dist
from .twa_semaphore import DEFAULT_LONG_TERM_THRESHOLD, WaitingArray, _GLOBAL_ARRAY
from .parking import pause


class Sequencer:
    """Wait-free monotone ticket dispenser."""

    __slots__ = ("_ticket",)

    def __init__(self, start: int = 0):
        self._ticket = AtomicU64(start)

    def ticket(self) -> int:
        return self._ticket.fetch_add(1)

    def read(self) -> int:
        return self._ticket.load()


class EventCount:
    """TWA-augmented eventcount: value-hashed semi-local waiting."""

    def __init__(self, count: int = 0, waiting: str = "futex",
                 long_term_threshold: int = DEFAULT_LONG_TERM_THRESHOLD,
                 array: WaitingArray | None = None):
        assert waiting in ("spin", "futex")
        self.count = AtomicU64(count)
        self.array = array if array is not None else _GLOBAL_ARRAY
        self.threshold = long_term_threshold
        self._spin = waiting == "spin"
        self._addr = id(self)

    def read(self) -> int:
        return self.count.load()

    def await_(self, value: int) -> int:
        """Block until count ≥ value; returns the count seen."""
        c = self.count.load()
        if _dist(c, value) >= 0:
            return c
        bucket = self.array.bucket_for(twa_hash(self._addr, value))
        mx = bucket.seq.load()
        while True:
            c = self.count.load()
            if _dist(c, value) >= 0:
                return c
            if _dist(c, value) + self.threshold >= 0:
                pause()  # near: short-term wait on the count itself
                continue
            vx = mx
            bucket.wait_for_change(vx, self._spin)
            mx = bucket.seq.load()

    def advance(self, n: int = 1) -> int:
        """count += n; poke the buckets of every value the advance enabled
        (plus the staging threshold — successor-of-successor, as in the
        paper's SemaPost)."""
        old = self.count.fetch_add(n)
        for i in range(1, n + 1 + self.threshold):
            self.array.bucket_for(twa_hash(self._addr, old + i)).poke()
        return old + n


class TicketMutex:
    """The classic eventcount+sequencer mutual-exclusion construction —
    functionally a ticket lock whose waiters use the TWA waiting array."""

    def __init__(self):
        self.seq = Sequencer()
        self.ec = EventCount()

    def lock(self) -> None:
        my = self.seq.ticket()
        self.ec.await_(my)

    def unlock(self) -> None:
        self.ec.advance(1)
