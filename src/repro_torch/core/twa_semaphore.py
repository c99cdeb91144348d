"""Listing 2 — TWA-Semaphore: Ticket-Semaphore augmented with a waiting array.

Arriving threads whose distance to Grant exceeds ``LongTermThreshold`` leave
the hot Grant location and wait *semi-locally* on a hashed bucket of a shared
fixed-size waiting array (proxy ``UpdateSequence`` modification indicators).
``post`` increments Grant, then pokes the bucket for ticket value
``grant + LongTermThreshold`` — the *successor's successor* — shifting it
from long-term (bucket) to short-term (Grant) waiting while the immediate
successor is already entering the critical section: wakeup staging overlaps
useful work.

Global spinning is reduced to ≤ LongTermThreshold threads per semaphore at a
time; all other waiting is dispersed over the array by the ticket-aware hash.

The waiting array is **process-global and shared by all semaphores** (as in
the paper); collisions across unrelated semaphores are benign (spurious
re-checks), only a performance concern.

Bucket waiting modes:
  - "spin":  Listing 2 verbatim — poll the bucket's UpdateSequence.
  - "futex": block on the bucket (futex/WaitOnAddress analogue): waiters
             sleep on a per-bucket condition keyed by UpdateSequence value;
             the poke is a notify_all on that bucket only.  Because buckets
             are dispersed by TWAHash, futex-style waiting also disperses
             kernel hashtable traffic — the paper's noted side benefit.

``post`` implements the benaphore-style fast path: after the Grant
fetch_add, if ``grant + threshold - Ticket >= 0`` there can be no long-term
waiter needing notification and the bucket poke is skipped (racy but
conservative — never skips a *needed* poke, may rarely do a futile one).

Cancellation (the extension the admission subsystem builds on): ticket
designs are awkward to revoke because an issued ticket occupies a fixed
position in the grant sequence — it cannot simply vanish.  With
``cancellation=True`` the semaphore runs a **tombstone protocol**:

  * an abandoning waiter marks its ticket dead (``cancel``); the ticket
    keeps its place in the FCFS order but will never consume a slot;
  * ``post`` becomes *skip-aware*: after advancing Grant, if the ticket
    just enabled is tombstoned the unit is re-posted — Grant advances
    again — so the slot flows to the next *live* ticket.  FCFS among live
    waiters is preserved exactly (dead tickets are transparent);
  * the cancel/post race is resolved under one lock: ``cancel`` loses
    (returns False) iff Grant already covered the ticket, in which case
    the caller owns the slot after all and must release it normally.

``take_until`` is the deadline-aware take built on this: on expiry it
tombstones its own ticket; a lost race means the slot arrived concurrently
and the take reports success instead.
"""

from __future__ import annotations

import threading
import time

from .atomics import AtomicU64
from .hashfn import index_for, twa_hash
from .parking import pause
from .ticket_semaphore import _dist

DEFAULT_TABLE_SIZE = 2048
DEFAULT_LONG_TERM_THRESHOLD = 1


class WaitBucket:
    """One slot of the waiting array.

    ``seq`` is the paper's UpdateSequence. The condition variable exists only
    for "futex" mode; spin mode never touches it. (In C++ the bucket is a
    single aligned cache line; object-per-bucket is the Python analogue of
    the 128-byte sector alignment.)
    """

    __slots__ = ("seq", "_cond")

    def __init__(self):
        self.seq = AtomicU64(0)
        self._cond = threading.Condition()

    def wait_for_change(self, observed: int, spin: bool,
                        deadline: float | None = None) -> None:
        """Block until ``seq`` moves past ``observed`` or ``deadline`` (an
        absolute ``time.monotonic`` instant) passes.  Spurious returns are
        fine — callers re-check Grant in their outer loop."""
        if spin:
            checks = 0
            while self.seq.load() == observed:
                pause()
                checks += 1
                if deadline is not None and (checks & 0x3F) == 0 \
                        and time.monotonic() >= deadline:
                    return
        else:
            with self._cond:
                while self.seq.load() == observed:
                    if deadline is None:
                        self._cond.wait()
                    else:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            return
                        self._cond.wait(left)

    def poke(self) -> None:
        self.seq.fetch_add(1)
        with self._cond:
            self._cond.notify_all()


class WaitingArray:
    """Process-wide waiting array (flat table of WaitBucket)."""

    def __init__(self, table_size: int = DEFAULT_TABLE_SIZE):
        assert table_size > 0 and (table_size & (table_size - 1)) == 0
        self.table_size = table_size
        self.buckets = [WaitBucket() for _ in range(table_size)]

    def bucket_for(self, key: int) -> WaitBucket:
        return self.buckets[index_for(key, self.table_size)]


# The process-global default array, shared by every TWASemaphore (paper §1:
# "The waiting array is shared by all threads in the process and is of fixed
# size.").
_GLOBAL_ARRAY = WaitingArray()


class TWASemaphore:
    def __init__(
        self,
        count: int = 0,
        waiting: str = "spin",
        long_term_threshold: int = DEFAULT_LONG_TERM_THRESHOLD,
        array: WaitingArray | None = None,
        post_fast_path: bool = True,
        hash_fn=twa_hash,
        cancellation: bool = False,
    ):
        assert count >= 0
        assert waiting in ("spin", "futex")
        self.ticket = AtomicU64(0)
        self.grant = AtomicU64(count)
        self.threshold = long_term_threshold
        self.array = array if array is not None else _GLOBAL_ARRAY
        self._spin_buckets = waiting == "spin"
        self._post_fast_path = post_fast_path
        self._hash = hash_fn
        self._addr = id(self)  # uintptr_t(L) component of TWAHash
        # Tombstone protocol state (cancellation=True only).  The lock orders
        # cancel's (grant check, mark-dead) against post's (advance,
        # dead-check) so a slot is never granted to a dead ticket NOR a
        # cancelled waiter left believing both outcomes at once.
        self._cancellation = cancellation
        self._tombstones: set[int] = set()
        self._tomb_lock = threading.Lock()
        self.tombstones_skipped = 0  # posts re-issued past dead tickets

    # -- take ----------------------------------------------------------------
    def take(self) -> None:
        tx = self.ticket.fetch_add(1)
        dx = _dist(self.grant.load(), tx)
        if dx > 0:  # fast-path uncontended return
            return
        # slow path: contended — need to wait.
        bucket = self.array.bucket_for(self._hash(self._addr, tx))
        mx = bucket.seq.load()
        while True:
            dx = _dist(self.grant.load(), tx)
            if dx > 0:
                return
            if (dx + self.threshold) > 0:
                # Short-term: near the head of the logical queue — global
                # polling directly on Grant for minimal handover latency.
                pause()
                continue
            # Long-term distal waiting — semi-local via the waiting array;
            # the bucket's UpdateSequence is a proxy change indicator.
            vx = mx
            bucket.wait_for_change(vx, self._spin_buckets)
            mx = bucket.seq.load()

    def take_until(self, deadline: float | None) -> bool:
        """Deadline-aware take (requires ``cancellation=True`` when a deadline
        is given).  ``deadline`` is an absolute ``time.monotonic`` instant;
        None degrades to a plain blocking ``take``.  Returns True iff the
        slot was acquired; on False the ticket has been tombstoned and will
        be skipped by future posts."""
        if deadline is None:
            self.take()
            return True
        assert self._cancellation, "take_until(deadline) needs cancellation=True"
        tx = self.ticket.fetch_add(1)
        if _dist(self.grant.load(), tx) > 0:
            return True
        bucket = self.array.bucket_for(self._hash(self._addr, tx))
        mx = bucket.seq.load()
        while True:
            dx = _dist(self.grant.load(), tx)
            if dx > 0:
                return True
            if time.monotonic() >= deadline:
                # Lost-race semantics: cancel fails iff grant already covered
                # the ticket — then the slot is ours despite the timeout.
                return not self.cancel(tx)
            if (dx + self.threshold) > 0:
                pause()
                continue
            vx = mx
            bucket.wait_for_change(vx, self._spin_buckets, deadline)
            mx = bucket.seq.load()

    # -- cancellation ---------------------------------------------------------
    def cancel(self, ticket: int) -> bool:
        """Tombstone ``ticket``.  True: the ticket is dead, it will never
        consume a slot and later live tickets keep FCFS order.  False: the
        grant sequence already reached the ticket — the caller holds the
        slot and must ``post`` it back when done."""
        assert self._cancellation, "constructed without cancellation support"
        with self._tomb_lock:
            if _dist(self.grant.load(), ticket) > 0:
                return False  # too late — already granted
            self._tombstones.add(ticket)
            return True

    # -- post ----------------------------------------------------------------
    def post(self, n: int = 1) -> None:
        pending = n
        while pending > 0:  # each unit may enable a distinct long-term waiter
            g = self.grant.fetch_add(1)
            enabled = g  # grant g→g+1 enables exactly ticket g
            if self._cancellation:
                # Skip-aware path: a unit landing on a tombstoned ticket is
                # re-posted so the slot flows to the next live waiter.  The
                # dead-check must happen under the lock AFTER the fetch_add
                # (see cancel) — the set is usually empty, and membership
                # costs O(1).
                with self._tomb_lock:
                    dead = enabled in self._tombstones
                    if dead:
                        self._tombstones.discard(enabled)
                if dead:
                    self.tombstones_skipped += 1
                else:
                    pending -= 1
            else:
                pending -= 1
            g += self.threshold
            if self._post_fast_path:
                # Benaphore-style conservative fast path: if no thread can be
                # long-term waiting past g, skip the array access entirely —
                # avoids "marching" through the array on uncontended posts.
                dx = _dist(g, self.ticket.load())
                if dx >= 0:
                    continue
            # Poke successor-of-successor from long-term into short-term mode.
            self.array.bucket_for(self._hash(self._addr, g)).poke()

    def poke_ticket(self, ticket: int) -> None:
        """Wake whatever is parked on ``ticket``'s bucket.  Used by external
        cancellers (admission.cancellable) so a futex-parked waiter observes
        its cancellation instead of sleeping on a bucket nobody will poke."""
        self.array.bucket_for(self._hash(self._addr, ticket)).poke()

    # -- introspection ---------------------------------------------------------
    def queue_depth(self) -> int:
        return max(0, -_dist(self.grant.load(), self.ticket.load()))

    def available(self) -> int:
        return max(0, _dist(self.grant.load(), self.ticket.load()))

    def tombstones_pending(self) -> int:
        with self._tomb_lock:
            return len(self._tombstones)

    def live_queue_depth(self) -> int:
        """Waiters in line excluding tombstoned (abandoned) tickets."""
        return max(0, self.queue_depth() - self.tombstones_pending())
