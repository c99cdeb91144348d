"""Cluster control plane (L3 of the paper's adaptation) — the port of
``repro.runtime.coordinator``, copied whole: it holds no JAX, and its
behaviour is the reference's bit for bit (its semaphore, hash and atomics
are the port's copies in `core`).

At thousands of hosts, the coordination hot-spots are the distributed
analogue of the paper's contended `Grant` word: a checkpoint-write token, a
barrier generation counter, an elastic membership epoch.  We structure every
one of them as a (ticket, grant) pair on the coordinator KV store and have
hosts wait on *hashed bucket keys* instead of the grant key:

  * polling hosts disperse across buckets (no thundering-herd reads of one
    key — the KV-store equivalent of coherence storms);
  * the releaser pokes exactly the successor's bucket (plus the benaphore
    fast-path skip when nobody can be waiting);
  * `ticket − grant` per resource is the built-in queue-depth telemetry that
    feeds straggler detection.

The KV store here is in-process (this box is single-host); the interface is
the same one an etcd/redis deployment would implement — tests simulate many
hosts as threads against it, which exercises every code path except network
latency.

Fault-tolerance machinery:
  * heartbeats with configurable timeout → failure detection;
  * barrier with failure awareness (dead hosts are excluded from the count
    rather than hanging the barrier);
  * straggler detection from per-step duration EWMA + semaphore queue depth;
  * elastic epochs: join/leave bumps the membership epoch; the training
    driver re-builds its mesh and re-shards from the last checkpoint
    (`runtime.elastic`).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from ..core.atomics import AtomicU64
from ..core.hashfn import index_for, twa_hash
from ..core.twa_semaphore import TWASemaphore


class KVStore:
    """In-process stand-in for the coordinator store (etcd-like watch API)."""

    def __init__(self):
        self._data: dict[str, int] = {}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)

    def incr(self, key: str, by: int = 1) -> int:
        with self._cond:
            old = self._data.get(key, 0)
            self._data[key] = old + by
            self._cond.notify_all()
            return old

    def get(self, key: str) -> int:
        with self._lock:
            return self._data.get(key, 0)

    def keys(self, prefix: str = "") -> list[str]:
        """Range read (etcd prefix get) — the reaper's scan primitive."""
        with self._lock:
            return sorted(k for k in self._data if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._cond:
            self._data.pop(key, None)
            self._cond.notify_all()

    def wait_change(self, key: str, observed: int, timeout: float = 5.0) -> int:
        with self._cond:
            deadline = time.time() + timeout
            while self._data.get(key, 0) == observed:
                left = deadline - time.time()
                if left <= 0:
                    break
                self._cond.wait(left)
            return self._data.get(key, 0)

    def txn(self, fn):
        """Atomic read-modify-write over the store — the etcd ``Txn``
        analogue.  The tombstone protocol needs it: cancel's (grant check,
        mark-dead) and release's (advance, dead-check) must not interleave,
        or a slot could be granted to a dead ticket AND reported cancelled."""
        with self._cond:
            out = fn(self._data)
            self._cond.notify_all()
            return out


class DistributedTicketLease:
    """Ticket/grant resource on the KV store with TWA bucket waiting.

    acquire(): take a ticket; wait until grant reaches it — polling ONLY our
    hashed bucket key (kv:`bucket/<i>`), which the releaser pokes.
    release(): advance grant, poke the successor's bucket (benaphore skip
    when the distance shows no waiters).

    Cancellable waits (the tombstone protocol, distributed): a waiter that
    gives up marks its ticket dead (`<name>/dead/<ticket>`); release()
    skips dead tickets when advancing grant, so a dying host that leaked a
    ticket can never wedge the cluster grant sequence — the slot flows to
    the next *live* ticket and FCFS among live hosts is preserved.  On
    timeout, acquire() tombstones its own ticket; if the tombstone loses
    the race (grant arrived first) the lease is held and returned instead
    of raising.

    Wait discipline: re-checks use **jittered exponential backoff**
    (``backoff_base·2^attempt``, capped at ``backoff_cap``, scaled by a
    seeded uniform jitter in [0.5, 1.5)) instead of a fixed poll period —
    an observed grant advance resets the backoff, so near-head waiters
    stay snappy while a stalled far queue decays to the cap and the store
    sees O(hosts / cap) re-reads per second instead of a synchronized
    herd.  While waiting (and on acquisition) the ticket renews a
    **lease heartbeat** key (``<name>/hb/<ticket>``, epoch-ms) every
    ``heartbeat_interval`` seconds; holders keep renewing via
    :meth:`renew`, and :meth:`heartbeat_age` lets a reaper decide a
    holder is dead and :meth:`cancel` its ticket.  Per-lease retry
    counters are surfaced by :meth:`wait_telemetry`.
    """

    BUCKETS = 64

    def __init__(self, kv: KVStore, name: str, capacity: int = 1,
                 long_term_threshold: int = 1, backoff_base: float = 0.005,
                 backoff_cap: float = 0.25, backoff_seed: int | None = None,
                 heartbeat_interval: float = 0.5, clock=time.time):
        self.kv = kv
        self.name = name
        self.capacity = int(capacity)
        self.threshold = long_term_threshold
        # heartbeat TIME SOURCE only (stamps + ages): injectable so reaper
        # TTL logic is testable under a virtual clock.  The blocking waits
        # in acquire() stay on wall time — they gate real threads.
        self._clock = clock
        self._salt = index_for(hash(name), 1 << 31)
        self.dead_skipped = 0  # grant advances that bypassed a tombstone
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.heartbeat_interval = float(heartbeat_interval)
        # seeded jitter: deterministic tests, decorrelated hosts (the
        # default seed differs per lease name / process)
        self._jitter = random.Random(
            backoff_seed if backoff_seed is not None else hash((name, id(self))))
        self.retry_counts = {
            "acquires": 0,    # acquire() calls
            "near": 0,        # short waits on the grant key (head of queue)
            "far": 0,         # backoff waits on the hashed bucket key
            "timeouts": 0,    # acquires that gave up (tombstoned)
            "heartbeats": 0,  # lease-heartbeat renewals written
        }
        if kv.incr(f"{name}/init", 0) == 0 and kv.incr(f"{name}/init") == 0:
            kv.incr(f"{name}/grant", capacity)

    def _bucket_key(self, ticket: int) -> str:
        return f"{self.name}/bucket/{index_for(twa_hash(self._salt, ticket), self.BUCKETS)}"

    def cancel(self, ticket: int) -> bool:
        """Tombstone ``ticket``.  True: dead, will be skipped by release().
        False: grant already covers it — the caller holds the lease and
        must release() it.  Runs as one KV transaction (etcd Txn)."""
        gk, dk = f"{self.name}/grant", f"{self.name}/dead/{ticket}"

        def do(d):
            if d.get(gk, 0) - ticket > 0:
                return False
            d[dk] = 1
            d.pop(f"{self.name}/hb/{ticket}", None)  # tombstoned ≠ leaked
            return True

        return self.kv.txn(do)

    def _renew_heartbeat(self, ticket: int) -> None:
        key = f"{self.name}/hb/{ticket}"
        # +1 so a stamp at virtual t=0 is distinguishable from "never"
        now_ms = int(self._clock() * 1000) + 1
        self.kv.txn(lambda d: d.__setitem__(key, now_ms))
        self.retry_counts["heartbeats"] += 1

    def renew(self, ticket: int) -> None:
        """Holder-side lease-heartbeat renewal — call periodically while
        holding the lease so reapers can tell held from leaked."""
        self._renew_heartbeat(ticket)

    def heartbeat_age(self, ticket: int) -> float | None:
        """Seconds since ``ticket`` last renewed its heartbeat (None if it
        never has).  A reaper that sees an age past its TTL can
        :meth:`cancel` the ticket to unwedge the grant sequence."""
        ms = self.kv.get(f"{self.name}/hb/{ticket}")
        return None if ms == 0 else max(0.0, self._clock() - (ms - 1) / 1000.0)

    def outstanding(self) -> list[int]:
        """Tickets with a live heartbeat key — the reaper's scan set
        (release/reap delete the key; a vanished holder leaves it stale)."""
        pre = f"{self.name}/hb/"
        return sorted(int(k[len(pre):]) for k in self.kv.keys(pre))

    def wait_telemetry(self) -> dict:
        """Retry/heartbeat counters (cumulative, this process's view)."""
        return dict(self.retry_counts, queue_depth=self.queue_depth())

    # ---- non-blocking admission (router path) ---------------------------
    #
    # A request router cannot park an OS thread per queued request; it
    # takes the ticket up front (FCFS position now) and polls `granted`
    # from its control loop — the queued requests ARE the lease's TWA
    # waiting array, and `headroom()` (grant − ticket) is the routing
    # signal.

    def try_acquire(self) -> int | None:
        """Benaphore fast path as one KV txn: take a ticket only when the
        grant already covers it (immediate admission).  None = full."""
        tk, gk = f"{self.name}/ticket", f"{self.name}/grant"

        def do(d):
            nxt = d.get(tk, 0)
            if d.get(gk, 0) - nxt > 0:
                d[tk] = nxt + 1
                return nxt
            return None

        t = self.kv.txn(do)
        if t is not None:
            self.retry_counts["acquires"] += 1
            self._renew_heartbeat(t)
        return t

    def take_ticket(self) -> int:
        """Unconditional ticket take — queue admission without blocking.
        The caller polls :meth:`granted` (ideally gated on its TWA bucket
        key) and MUST keep renewing the heartbeat while queued, or a
        reaper will tombstone the position."""
        t = self.kv.incr(f"{self.name}/ticket")
        self.retry_counts["acquires"] += 1
        self._renew_heartbeat(t)
        return t

    def granted(self, ticket: int) -> bool:
        return self.kv.get(f"{self.name}/grant") - ticket > 0

    def headroom(self) -> int:
        """grant − ticket: free units when positive, waiters when negative
        — the per-replica routing signal (capacity − in-flight − queued)."""
        return (self.kv.get(f"{self.name}/grant")
                - self.kv.get(f"{self.name}/ticket"))

    def bucket_state(self, ticket: int) -> tuple[str, int]:
        """(bucket key, current sequence) for a queued ticket — lets a
        polling router re-check `granted` only when the bucket was poked
        (the waiting-array read-dispersal discipline, clusterized)."""
        k = self._bucket_key(ticket)
        return k, self.kv.get(k)

    def acquire(self, timeout: float = 30.0) -> int:
        ticket = self.kv.incr(f"{self.name}/ticket")
        deadline = time.time() + timeout
        bucket = self._bucket_key(ticket)
        observed = self.kv.get(bucket)
        self.retry_counts["acquires"] += 1
        attempt = 0
        last_grant = None
        next_hb = 0.0  # first loop pass writes the heartbeat immediately
        while True:
            grant = self.kv.get(f"{self.name}/grant")
            if grant - ticket > 0:
                self._renew_heartbeat(ticket)  # holder baseline
                return ticket
            now = time.time()
            if now > deadline:
                if self.cancel(ticket):
                    self.retry_counts["timeouts"] += 1
                    raise TimeoutError(
                        f"lease {self.name}: ticket {ticket} vs grant {grant} "
                        "(ticket tombstoned — grant sequence not wedged)")
                return ticket  # lost race: the lease arrived at expiry
            if now >= next_hb:
                # waiting is also alive: renew the lease heartbeat so a
                # reaper never tombstones a slow-but-live waiter
                self._renew_heartbeat(ticket)
                next_hb = now + self.heartbeat_interval
            if grant != last_grant:
                attempt = 0  # observed progress → re-arm fast polling
            last_grant = grant
            # jittered exponential backoff, clipped to the deadline and
            # the next heartbeat due time
            wait = min(self.backoff_cap,
                       self.backoff_base * (1 << min(attempt, 16)))
            wait *= 0.5 + self._jitter.random()
            wait = max(1e-4, min(wait, deadline - now, next_hb - now + 1e-3))
            attempt += 1
            if grant + self.threshold - ticket > 0:
                # near the head: short-term wait directly on grant
                self.retry_counts["near"] += 1
                self.kv.wait_change(f"{self.name}/grant", grant, timeout=wait)
            else:
                # far: semi-local wait on our hashed bucket
                self.retry_counts["far"] += 1
                observed = self.kv.wait_change(bucket, observed, timeout=wait)

    def release(self, ticket: int | None = None) -> None:
        """Advance grant by one unit (skip-aware over tombstones) and poke
        the successor buckets.  When the releasing ``ticket`` is known its
        heartbeat key is deleted — a released ticket must never look like
        a leak to the reaper."""
        if ticket is not None:
            self.kv.delete(f"{self.name}/hb/{ticket}")
        gk = f"{self.name}/grant"

        def advance(d):
            """Skip-aware grant: keep advancing while the enabled ticket is
            tombstoned (one unit may hop several dead tickets)."""
            skipped = 0
            while True:
                enabled = d.get(gk, 0)
                d[gk] = enabled + 1
                if d.pop(f"{self.name}/dead/{enabled}", None) is None:
                    return enabled + 1, skipped
                skipped += 1

        grant, skipped = self.kv.txn(advance)
        self.dead_skipped += skipped
        ticket = self.kv.get(f"{self.name}/ticket")
        # Poke every bucket staged by this advance (the skip may have moved
        # grant several steps; each step has its own successor's successor).
        for v in range(grant - skipped, grant + 1):
            g = v + self.threshold
            if g - ticket >= 0:
                break  # benaphore fast path: nobody long-term waiting past g
            self.kv.incr(self._bucket_key(g))

    def queue_depth(self) -> int:
        return max(0, self.kv.get(f"{self.name}/ticket") - self.kv.get(f"{self.name}/grant"))


# ------------------------------------------------------------ coordinator ---


@dataclass
class HostState:
    host_id: int
    last_heartbeat: float
    step: int = 0
    step_ewma_s: float = 0.0
    alive: bool = True


@dataclass
class Coordinator:
    """Failure detection + barriers + straggler accounting + elastic epochs.

    ``clock`` is the failure-detection time source (heartbeat stamps, the
    heartbeat-timeout comparison, the barrier deadline) — injectable so
    dead/rejoining-host scenarios run deterministically under a virtual
    clock while worker threads still block on the KV store's real
    condition variables."""

    heartbeat_timeout: float = 2.0
    straggler_factor: float = 2.0
    kv: KVStore = field(default_factory=KVStore)
    clock: object = time.time

    def __post_init__(self):
        self.hosts: dict[int, HostState] = {}
        self._lock = threading.Lock()
        self.epoch = 0  # membership epoch — bumped on join/leave/failure
        self.ckpt_lease = DistributedTicketLease(self.kv, "ckpt-writers",
                                                 capacity=2, clock=self.clock)

    # ---- membership -------------------------------------------------------
    def join(self, host_id: int) -> int:
        """Join or REJOIN: a host that was declared dead re-enters with a
        fresh heartbeat and a bumped epoch (the elastic-epoch contract —
        the driver rebuilds its mesh; stale state from the old
        incarnation is fenced by the epoch it carries)."""
        with self._lock:
            self.hosts[host_id] = HostState(host_id, self.clock())
            self.epoch += 1
            return self.epoch

    def leave(self, host_id: int) -> int:
        with self._lock:
            if host_id in self.hosts:
                self.hosts[host_id].alive = False
                self.epoch += 1
            return self.epoch

    def alive_hosts(self) -> list[int]:
        with self._lock:
            return sorted(h.host_id for h in self.hosts.values() if h.alive)

    # ---- heartbeats / failure detection -----------------------------------
    def heartbeat(self, host_id: int, step: int, step_time_s: float) -> dict:
        now = self.clock()
        with self._lock:
            h = self.hosts.get(host_id)
            if h is None or not h.alive:
                raise RuntimeError(f"host {host_id} not a member (epoch {self.epoch})")
            h.last_heartbeat = now
            h.step = step
            h.step_ewma_s = (0.7 * h.step_ewma_s + 0.3 * step_time_s
                             if h.step_ewma_s else step_time_s)
            return {"epoch": self.epoch}

    def detect_failures(self) -> list[int]:
        now = self.clock()
        dead = []
        with self._lock:
            for h in self.hosts.values():
                if h.alive and now - h.last_heartbeat > self.heartbeat_timeout:
                    h.alive = False
                    dead.append(h.host_id)
            if dead:
                self.epoch += 1
        return dead

    # ---- stragglers --------------------------------------------------------
    def stragglers(self) -> list[int]:
        """Hosts whose EWMA step time exceeds straggler_factor × median."""
        with self._lock:
            alive = [h for h in self.hosts.values() if h.alive and h.step_ewma_s > 0]
            if len(alive) < 3:
                return []
            times = sorted(h.step_ewma_s for h in alive)
            med = times[len(times) // 2]
            return [h.host_id for h in alive if h.step_ewma_s > self.straggler_factor * med]

    # ---- failure-aware barrier ---------------------------------------------
    def barrier(self, host_id: int, gen: str, timeout: float = 10.0) -> bool:
        """Generation barrier: waits until every *alive* host arrived.  A
        host dying mid-barrier shrinks the required count instead of hanging
        everyone (the arrived-count is compared against the live membership
        each poll)."""
        key = f"barrier/{gen}"
        self.kv.incr(key)
        deadline = self.clock() + timeout
        observed = -1
        while self.clock() < deadline:
            arrived = self.kv.get(key)
            if arrived >= len(self.alive_hosts()):
                return True
            self.detect_failures()
            observed = self.kv.wait_change(key, arrived, timeout=0.05)
        return False
