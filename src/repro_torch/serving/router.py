"""Fault-tolerant replica router — the paper's semaphore at its fourth
granularity: **cluster admission**; the port of ``repro.serving.router``.

The engine puts the TWA (ticket, grant) pair under slots, tenant credit
and KV blocks inside ONE engine.  This module spreads requests across N
`ContinuousBatchingEngine` replicas and reuses the same construct one
level up: every replica's in-flight capacity is a
`runtime.coordinator.DistributedTicketLease` —

* **grant − ticket = replica headroom** is the routing signal (the
  router binds each request to the max-headroom live replica);
* a bound-but-unadmitted request IS a lease waiter: it holds a ticket,
  renews a heartbeat, and is admitted FCFS when completions advance the
  grant — the lease's hashed buckets gate the router's re-polls (one
  grant read only when the request's bucket was poked or it is near the
  head), so a thousand queued requests don't herd one KV key;
* a replica that dies leaks its tickets; the `runtime.reaper.LeaseReaper`
  tombstones stale waiters and force-releases stale holders, so the
  grant sequence is ALWAYS clean at exit.

Failure handling (the robustness contract):

* **detection** — missed coordinator heartbeats past the TTL, reaped
  lease tickets, or (for dispatch avoidance) a sick sentinel health
  bitmask feeding the per-replica circuit breaker;
* **exactly-once migration** — a dead replica's in-flight requests are
  re-cloned onto healthy replicas under the router's request-id dedupe:
  the first attempt to complete wins, later duplicates (e.g. a zombie
  replica on the far side of a KV partition) are suppressed, and a
  request is never delivered twice nor lost.  Requests the dead
  replica's last checkpoint snapshot captured can instead be adopted by
  a **warm-takeover successor** (`standby_factory`) that restores the
  snapshot and resumes them without a from-scratch replay;
* **retry discipline** — migrations consume a per-request retry budget
  with jittered exponential backoff (the same discipline the lease's
  acquire path and the engine-level quarantine requeue use); budget
  exhaustion, or a deadline that can no longer be met, sheds the request
  *explicitly* with a recorded reason instead of letting queues collapse;
* **circuit breaker** — consecutive sentinel-sick rounds trip a
  per-replica breaker (no new bindings); after a cool-off it half-opens
  for one probe binding and closes again only on a healthy round.

Determinism: the router runs on a virtual clock (``clk`` box shared with
every replica engine), cluster faults come from a seeded
`resilience.faults.FaultPlan` (kinds in ``CLUSTER_KINDS``), and request
token streams are functions of the request alone — so the chaos
acceptance property can assert *bit-identical* surviving streams against
a fault-free run.

The router itself is host code, the reference's line for line: its
control plane (leases, reaper, breaker, retry queue, dedupe) touches no
tensor.  The device work is each replica's ``megastep``: on the card that
launches the QoS admission kernel every round and, with a paged token
function, the paged decode and prefill kernels.  Known fault, kept as the
reference has it: a warm-takeover successor adopts the dead replica's
*same* `Request` attempt objects, and a dead replica whose process still
runs (a KV partition) is driven until it is fenced, so both engines can
append to one ``out_tokens`` (a stream one token past its limit).
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..resilience.faults import (
    CLUSTER_KINDS,
    KV_PARTITION,
    LEASE_LEAK,
    REPLICA_KILL,
    STRAGGLER,
    FaultPlan,
)
from ..obs.hist import LogHistogram
from ..obs.trace import TraceBuffer, build_spans
from ..runtime.coordinator import Coordinator, DistributedTicketLease, KVStore
from ..runtime.reaper import LeaseReaper, leases_clean
from .events import EV_MIGRATE, EV_ROUTE, EV_SHED, EV_SUBMIT
from .scheduler import Request

# ---------------------------------------------------------------------------


@dataclass
class ClusterRequest:
    """Client-facing record: ONE logical request, possibly many engine
    attempts.  ``done_event`` fires exactly once — on first delivery or
    on an explicit shed (``shed_reason`` records why)."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    tenant_id: str = "default"
    deadline: Optional[float] = None
    state: str = "queued"  # queued | inflight | done | shed
    tokens: list[int] = field(default_factory=list)
    shed_reason: Optional[str] = None
    retries: int = 0  # router-path migrations consumed
    attempts: int = 0  # engine clones created (≥1 duplicates ⇒ dedupe hit)
    completed_by: Optional[int] = None  # replica idx that won
    submit_clock: float = 0.0
    finish_clock: Optional[float] = None
    ttft: Optional[float] = None
    done_event: threading.Event = field(default_factory=threading.Event)


class CircuitBreaker:
    """Per-replica breaker over the sentinel health stream: ``trip_after``
    consecutive sick rounds open it (no new bindings); after ``cooloff``
    router rounds it half-opens for ONE probe binding; the next healthy
    round closes it, a sick one re-opens."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, trip_after: int = 3, cooloff: int = 6):
        self.trip_after = int(trip_after)
        self.cooloff = int(cooloff)
        self.state = self.CLOSED
        self.faults = 0  # consecutive sick rounds
        self.opened_at = -1
        self.trips = 0
        self._probe_used = False

    def record(self, healthy: bool, rnd: int) -> Optional[str]:
        """Feed one driven round's health; returns a transition name or
        None."""
        if healthy:
            self.faults = 0
            if self.state == self.HALF_OPEN:
                self.state = self.CLOSED
                return "close"
            return None
        self.faults += 1
        if self.state == self.HALF_OPEN:
            self.state = self.OPEN
            self.opened_at = rnd
            return "reopen"
        if self.state == self.CLOSED and self.faults >= self.trip_after:
            self.state = self.OPEN
            self.opened_at = rnd
            self.trips += 1
            return "open"
        return None

    def allow(self, rnd: int) -> bool:
        """May the router bind NEW work to this replica this round?
        (Peek only — a half-open probe is consumed by :meth:`bound`.)"""
        if self.state == self.OPEN:
            if rnd - self.opened_at < self.cooloff:
                return False
            self.state = self.HALF_OPEN
            self._probe_used = False
        if self.state == self.HALF_OPEN:
            return not self._probe_used
        return True

    def bound(self) -> None:
        """A binding was actually routed here — in half-open, that was
        the one probe."""
        if self.state == self.HALF_OPEN:
            self._probe_used = True


class Replica:
    """Router-side handle: engine (wrapped in a ResilientEngine), its
    capacity lease, and the liveness/dispatch state machine."""

    def __init__(self, idx: int, rz, lease: DistributedTicketLease,
                 breaker: CircuitBreaker):
        self.idx = idx
        self.rz = rz
        self.eng = rz.engine
        self.lease = lease
        self.breaker = breaker
        self.alive = True           # router's view (membership)
        self.process_alive = True   # simulation: is the process running
        self.dead_round: Optional[int] = None
        self.dead_reason: Optional[str] = None
        self.pending: dict[int, int] = {}    # rid → lease ticket (queued)
        self.inflight: dict[int, tuple[int, Request]] = {}  # rid → (t, att)
        self.zombie: dict[int, Request] = {}  # attempts a fenced corpse runs
        self.bucket_obs: dict[int, tuple[str, int]] = {}  # rid → (key, seq)
        self.grant_cache = lease.kv.get(f"{lease.name}/grant")
        self.straggle = 1
        self.straggle_from = 0
        self.partition_until = -1  # rnd < this ⇒ heartbeat writes lost
        self.kill_at: Optional[tuple[int, int]] = None  # (rnd, offset)
        self.driven_rounds = 0

    def partitioned(self, rnd: int) -> bool:
        return rnd < self.partition_until

    def tickets(self):
        for t in self.pending.values():
            yield t
        for t, _ in self.inflight.values():
            yield t


@dataclass
class RouterStats:
    accepted: int = 0
    completed: int = 0
    duplicates_suppressed: int = 0  # exactly-once dedupe hits
    migrated: int = 0      # in-flight requests requeued off a dead replica
    rebound: int = 0       # queued (never-admitted) bindings moved
    adopted: int = 0       # warm-takeover resumptions from a snapshot
    replicas_dead: int = 0
    successors: int = 0
    orphans_reaped: int = 0  # leaked tickets freed that mapped to no request
    grant_poll_skips: int = 0  # admission re-polls saved by bucket gating
    zombie_deliveries: int = 0  # completions delivered by a fenced replica


class ReplicaRouter:
    """Spread requests over N replicas; survive the replicas dying.

    ``replicas``: list of `resilience.recovery.ResilientEngine` (their
    engines must share ``clk`` as clock).  ``capacity``: per-replica
    in-flight cap (lease units).  ``ttl``: heartbeat TTL in clock
    seconds — both the reaper's and the coordinator's detection horizon.
    ``plan``: a seeded cluster `FaultPlan` (``CLUSTER_KINDS`` events,
    rounds = ROUTER rounds).  ``standby_factory``: zero-arg callable
    returning a fresh ResilientEngine for warm takeover.  ``inner_k``:
    engine rounds per router round (each replica drives one
    ``megastep(inner_k)``); a REPLICA_KILL's ``delta`` lands the death
    ``delta`` engine rounds INTO that window — mid-megastep."""

    def __init__(self, replicas, *, kv: KVStore, clk, token_fn,
                 capacity: int, ttl: float, dt: float = 0.25,
                 inner_k: int = 4, plan: Optional[FaultPlan] = None,
                 retry_budget: int = 3, backoff_base: int = 1,
                 backoff_jitter: int = 2, seed: int = 0,
                 shed_slack: float = 0.0, breaker_trip: int = 3,
                 breaker_cooloff: int = 6, max_queue_per_replica: int = 0,
                 standby_factory=None, obs=None):
        self.kv = kv
        self._clk = clk
        self.token_fn = token_fn
        self.capacity = int(capacity)
        self.ttl = float(ttl)
        self.dt = float(dt)
        self.inner_k = int(inner_k)
        self.plan = plan if plan is not None else FaultPlan(seed=0)
        self.retry_budget = int(retry_budget)
        self.backoff_base = max(1, int(backoff_base))
        self.backoff_jitter = max(0, int(backoff_jitter))
        self.shed_slack = float(shed_slack)
        self.max_queue = (int(max_queue_per_replica)
                          if max_queue_per_replica else self.capacity)
        self.standby_factory = standby_factory
        self.obs = obs
        self._rng = np.random.default_rng(seed)
        self._breaker_cfg = (int(breaker_trip), int(breaker_cooloff))
        clock = lambda: self._clk[0]  # noqa: E731
        self.coord = Coordinator(heartbeat_timeout=self.ttl, kv=kv,
                                 clock=clock)
        self.replicas: list[Replica] = []
        for i, rz in enumerate(replicas):
            lease = DistributedTicketLease(
                kv, f"replica/{i}", capacity=self.capacity, clock=clock)
            self.replicas.append(Replica(
                i, rz, lease, CircuitBreaker(*self._breaker_cfg)))
            self.coord.join(i)
        self.reaper = LeaseReaper([r.lease for r in self.replicas],
                                  ttl=self.ttl)
        self.queue: deque[ClusterRequest] = deque()  # unbound requests
        self.requests: dict[int, ClusterRequest] = {}  # rid → record
        self._retryq: list[tuple[int, int]] = []  # (due round, rid)
        self._reaped: set[tuple[str, int]] = set()  # freed (lease, ticket)
        self._leaks: list[tuple[int, int]] = []  # (replica idx, ticket)
        self._consumed: set[int] = set()  # plan event indices applied
        self.stats = RouterStats()
        self.shed: dict[int, str] = {}  # rid → recorded reason
        self.completed: dict[int, list[int]] = {}  # rid → delivered tokens
        self.events: list[dict] = []
        self.round_no = 0
        # fabric-side trace events (SUBMIT/ROUTE/MIGRATE/SHED) — merged
        # with every replica engine's buffer by cluster_spans(); tagging
        # each engine's buffer with its replica idx is what lets a span
        # that migrated show WHICH replica ran which segment
        self.trace = TraceBuffer()
        for rep in self.replicas:
            rep.eng._trace.replica = rep.idx
        self._migrate_at: dict[int, float] = {}  # rid → MIGRATE clock
        self.migration_hist = LogHistogram(resolution=0.05, min_value=1e-3)

    # ----------------------------------------------------------- client ----

    def submit(self, cr: ClusterRequest) -> ClusterRequest:
        """Idempotent admission: a rid seen before returns the EXISTING
        record (the exactly-once contract starts at the front door — a
        client retrying a timed-out submit must not enqueue a double)."""
        prev = self.requests.get(cr.rid)
        if prev is not None:
            return prev
        cr.submit_clock = self._clk[0]
        self.requests[cr.rid] = cr
        self.queue.append(cr)
        self.stats.accepted += 1
        self.trace.add(EV_SUBMIT, cr.rid, -1, 0, cr.submit_clock,
                       self.round_no)
        return cr

    def submit_batch(self, crs) -> None:
        for cr in crs:
            self.submit(cr)

    # -------------------------------------------------------------- log ----

    def _log(self, action: str, **kw) -> None:
        self.events.append({"round": self.round_no, "action": action, **kw})

    # ----------------------------------------------------- fault applies ----

    def _apply_cluster_faults(self, rnd: int) -> None:
        for i, ev in enumerate(self.plan.events):
            if ev.round != rnd or i in self._consumed:
                continue
            if ev.kind not in CLUSTER_KINDS:
                continue  # engine-level events belong to replica plans
            self._consumed.add(i)
            rep = self.replicas[ev.arg % len(self.replicas)]
            if ev.kind == REPLICA_KILL:
                off = max(1, min(int(ev.delta) or 1, self.inner_k))
                rep.kill_at = (rnd, off)
            elif ev.kind == KV_PARTITION:
                rep.partition_until = rnd + max(1, int(ev.delta))
            elif ev.kind == STRAGGLER:
                rep.straggle = max(2, int(ev.delta))
                rep.straggle_from = rnd
            elif ev.kind == LEASE_LEAK:
                # a client took a ticket on this replica's lease and then
                # vanished: one stale heartbeat stamp, never renewed —
                # exactly what the reaper exists to free
                t = rep.lease.take_ticket()
                self._leaks.append((rep.idx, t))
            self._log("inject", kind=ev.kind, replica=rep.idx,
                      delta=ev.delta)

    # -------------------------------------------------------- detection ----

    def _detect(self, rnd: int) -> None:
        for idx in self.coord.detect_failures():
            if idx < len(self.replicas):
                self._mark_dead(self.replicas[idx], rnd,
                                "heartbeat_timeout")
        for act in self.reaper.scan():
            self._reaped.add((act.lease, act.ticket))
            owner = None
            for rep in self.replicas:
                if rep.lease.name != act.lease:
                    continue
                if (act.ticket in rep.pending.values()
                        or any(t == act.ticket
                               for t, _ in rep.inflight.values())):
                    owner = rep
                break
            self._log("reap", lease=act.lease, ticket=act.ticket,
                      how=act.action, age=round(act.age, 3))
            if owner is not None:
                # a request's ticket went stale ⇒ its replica stopped
                # renewing ⇒ the replica is dead, not just one ticket
                self._mark_dead(owner, rnd, "lease_reaped")
            else:
                self.stats.orphans_reaped += 1

    # ---------------------------------------------------- death handling ----

    def _mark_dead(self, rep: Replica, rnd: int, reason: str) -> None:
        if not rep.alive:
            return
        rep.alive = False
        rep.dead_round = rnd
        rep.dead_reason = reason
        self.stats.replicas_dead += 1
        self.coord.leave(rep.idx)
        self._log("replica_dead", replica=rep.idx, reason=reason)
        # flight recorder: cut the dead replica's post-mortem bundle NOW,
        # while its last samples/events are still in the window
        fl = getattr(getattr(rep.eng, "_obs", None), "flight", None)
        if fl is not None:
            fl.dump("replica_reaped",
                    extra={"replica": rep.idx, "cause": reason,
                           "round": rnd})
        # free every lease ticket the corpse still owns: tombstone the
        # waiters FIRST (so the holder releases skip them in one walk),
        # then force-release the holders
        for rid, t in sorted(rep.pending.items()):
            if (rep.lease.name, t) not in self._reaped:
                rep.lease.cancel(t)
                self._reaped.add((rep.lease.name, t))
        for rid, (t, _) in sorted(rep.inflight.items()):
            if (rep.lease.name, t) not in self._reaped:
                if not rep.lease.cancel(t):
                    rep.lease.release(t)
                self._reaped.add((rep.lease.name, t))
        # queued bindings never started work: rebind at no retry cost
        for rid in sorted(rep.pending):
            cr = self.requests[rid]
            if cr.state == "queued":
                self.queue.append(cr)
                self.stats.rebound += 1
        rep.pending.clear()
        rep.bucket_obs.clear()
        # warm takeover: requests the last snapshot captured resume on a
        # successor replica instead of replaying from scratch
        adopted: set[int] = set()
        if (self.standby_factory is not None and rep.inflight
                and rep.rz._snap is not None):
            adopted = self._spawn_successor(rep, rnd)
        # everything else migrates: re-clone onto healthy replicas under
        # the retry budget (the dedupe registry guards the zombie race)
        for rid, (t, att) in sorted(rep.inflight.items()):
            if rid in adopted:
                continue
            if rep.process_alive:
                rep.zombie[rid] = att  # partition corpse keeps running
            cr = self.requests[rid]
            if cr.state == "inflight":
                self.stats.migrated += 1
                self._requeue(cr, rnd)
        rep.inflight.clear()

    def _requeue(self, cr: ClusterRequest, rnd: int) -> None:
        cr.retries += 1
        if cr.retries > self.retry_budget:
            self._shed(cr, "retry_budget")
            return
        delay = (self.backoff_base * (1 << (cr.retries - 1))
                 + int(self._rng.integers(0, self.backoff_jitter + 1)))
        cr.state = "queued"
        heapq.heappush(self._retryq, (rnd + delay, cr.rid))
        self._log("requeue", rid=cr.rid, attempt=cr.retries,
                  due=rnd + delay)
        self.trace.add(EV_MIGRATE, cr.rid, -1, cr.retries, self._clk[0],
                       rnd)
        # migration latency clock starts at the FIRST requeue; stops when
        # the request is re-admitted into a healthy engine (_admit)
        self._migrate_at.setdefault(cr.rid, self._clk[0])

    def _spawn_successor(self, dead: Replica, rnd: int) -> set[int]:
        """Warm takeover: a fresh replica adopts the dead one's last
        checkpoint snapshot (device tree from the shared FS, host capture
        standing in for its host-state shard) and resumes the captured
        requests mid-flight."""
        rz2 = self.standby_factory()
        eng2 = rz2.engine
        # one empty round materializes the device-state protos (block
        # pool, model) so the checkpoint restore has matching shapes
        eng2.megastep(1, token_fn=self.token_fn,
                      nows=np.asarray([self._clk[0]], np.float32))
        rz2.ckpt = dead.rz.ckpt
        rz2._snap = dead.rz._snap
        rz2._snaps = list(dead.rz._snaps)
        rz2._restore(rnd)
        if not any(e["action"] == "restore" for e in rz2.events):
            self._log("takeover_failed", replica=dead.idx)
            return set()
        idx2 = len(self.replicas)
        clock = lambda: self._clk[0]  # noqa: E731
        lease2 = DistributedTicketLease(
            self.kv, f"replica/{idx2}", capacity=self.capacity, clock=clock)
        rep2 = Replica(idx2, rz2, lease2, CircuitBreaker(*self._breaker_cfg))
        eng2._trace.replica = idx2
        self.replicas.append(rep2)
        self.coord.join(idx2)
        self.reaper.add(lease2)
        self.stats.successors += 1
        # adopt: every in-flight rid the snapshot captured is now live
        # inside eng2 (restored in place, same attempt objects)
        live_rids = {r.rid for r in eng2.active.values()}
        live_rids |= {r.rid for r in eng2.backlog}
        if eng2._tenants is not None:
            for q in eng2._tenant_queues:
                live_rids |= {r.rid for r in q}
        adopted: set[int] = set()
        for rid, (t, att) in sorted(dead.inflight.items()):
            if rid not in live_rids:
                continue
            t2 = lease2.try_acquire()
            if t2 is None:
                break  # capacity guard (snapshot bigger than a lease)
            rep2.inflight[rid] = (t2, att)
            cr = self.requests[rid]
            cr.attempts += 1
            adopted.add(rid)
            self.stats.adopted += 1
        self._log("warm_takeover", dead=dead.idx, successor=idx2,
                  adopted=sorted(adopted),
                  snapshot_round=dead.rz._snap[0])
        return adopted

    # --------------------------------------------------------- shedding ----

    def _shed(self, cr: ClusterRequest, reason: str) -> None:
        if cr.state in ("done", "shed"):
            return
        cr.state = "shed"
        cr.shed_reason = reason
        self.shed[cr.rid] = reason
        cr.done_event.set()
        self._log("shed", rid=cr.rid, reason=reason)
        self.trace.add(EV_SHED, cr.rid, -1, 0, self._clk[0],
                       self.round_no)

    def _shed_pass(self) -> None:
        """Deadline-aware overload relief: a queued request whose deadline
        is already (or is about to be) unmeetable is shed NOW with a
        recorded reason, instead of wasting a binding on it."""
        now = self._clk[0]
        keep = deque()
        for cr in self.queue:
            if (cr.deadline is not None
                    and cr.deadline - now <= self.shed_slack):
                self._shed(cr, "deadline")
            else:
                keep.append(cr)
        self.queue = keep

    # ---------------------------------------------------------- binding ----

    def _bind(self, rnd: int) -> None:
        while self.queue:
            cands = [rep for rep in self.replicas
                     if rep.alive and rep.lease.headroom() > -self.max_queue
                     and rep.breaker.allow(rnd)]
            if not cands:
                return
            # max headroom (least loaded), ties to the lowest index —
            # deterministic power-of-N routing
            rep = max(cands, key=lambda r: (r.lease.headroom(), -r.idx))
            rep.breaker.bound()
            cr = self.queue.popleft()
            t = rep.lease.take_ticket()
            rep.pending[cr.rid] = t
            rep.bucket_obs[cr.rid] = rep.lease.bucket_state(t)
            self._log("bind", rid=cr.rid, replica=rep.idx, ticket=t)
            self.trace.add(EV_ROUTE, cr.rid, rep.idx, t, self._clk[0],
                           rnd, replica=rep.idx)

    def _admit(self, rnd: int) -> None:
        """Promote granted bindings to engine submissions.  Re-polls are
        bucket-gated: far-from-head tickets re-read the grant only when
        their waiting-array bucket was poked."""
        for rep in self.replicas:
            if not rep.alive or not rep.pending:
                continue
            lease = rep.lease
            for rid in sorted(rep.pending, key=rep.pending.get):
                t = rep.pending[rid]
                if rep.grant_cache - t <= 0:
                    bkt, seq = rep.bucket_obs[rid]
                    cur = self.kv.get(bkt)
                    near = rep.grant_cache + lease.threshold - t > 0
                    if cur == seq and not near:
                        self.stats.grant_poll_skips += 1
                        continue
                    rep.bucket_obs[rid] = (bkt, cur)
                    rep.grant_cache = self.kv.get(f"{lease.name}/grant")
                    if rep.grant_cache - t <= 0:
                        continue
                cr = self.requests[rid]
                att = Request(rid=cr.rid, prompt=list(cr.prompt),
                              max_new_tokens=cr.max_new_tokens,
                              tenant_id=cr.tenant_id, deadline=cr.deadline)
                rep.eng.submit(att)
                rep.inflight[rid] = (t, att)
                del rep.pending[rid]
                del rep.bucket_obs[rid]
                cr.state = "inflight"
                cr.attempts += 1
                m = self._migrate_at.pop(rid, None)
                if m is not None:
                    self.migration_hist.add(max(self._clk[0] - m, 1e-3))

    # ------------------------------------------------------------ drive ----

    def _drive(self, rnd: int) -> None:
        now = self._clk[0]
        for rep in self.replicas:
            if not rep.process_alive:
                continue
            gated = (rep.straggle > 1
                     and (rnd - rep.straggle_from) % rep.straggle != 0)
            killed_now = rep.kill_at is not None and rep.kill_at[0] == rnd
            if not gated or killed_now:
                seg = self.inner_k
                if killed_now:
                    seg = rep.kill_at[1]  # dies mid-megastep: the rounds
                    #                       past the kill offset never run
                nows = np.asarray(now + np.arange(seg) * self.dt,
                                  np.float32)
                rep.rz.megastep(seg, token_fn=self.token_fn, nows=nows)
                rep.driven_rounds += seg
                health = 0
                for smp in rep.eng._last_samples:
                    health |= int(smp["health"])
                trans = rep.breaker.record(health == 0, rnd)
                if trans is not None:
                    self._log(f"breaker_{trans}", replica=rep.idx,
                              health=health)
            if killed_now:
                rep.process_alive = False
                self._log("replica_killed", replica=rep.idx,
                          offset=rep.kill_at[1])
                continue
            # liveness: heartbeats + lease renewals — suppressed inside a
            # KV partition window (the replica IS running; its writes are
            # lost — the zombie scenario the dedupe registry exists for)
            if rep.alive and not rep.partitioned(rnd):
                self.coord.heartbeat(
                    rep.idx, step=rep.eng._round_no,
                    step_time_s=self.dt * self.inner_k * rep.straggle)
            if not rep.partitioned(rnd):
                for t in rep.tickets():
                    if (rep.lease.name, t) not in self._reaped:
                        rep.lease.renew(t)

    # ---------------------------------------------------------- collect ----

    def _deliver(self, cr: ClusterRequest, att: Request, idx: int,
                 zombie: bool) -> None:
        if cr.state in ("done", "shed"):
            self.stats.duplicates_suppressed += 1
            self._log("duplicate_suppressed", rid=cr.rid, replica=idx)
            return
        if att.expired or att.preempted:
            self._shed(cr, "deadline")
            return
        cr.tokens = list(att.out_tokens)
        cr.state = "done"
        cr.completed_by = idx
        cr.finish_clock = self._clk[0]
        if att.first_tok_clock is not None:
            cr.ttft = att.first_tok_clock - cr.submit_clock
        self.completed[cr.rid] = cr.tokens
        cr.done_event.set()
        self.stats.completed += 1
        if zombie:
            self.stats.zombie_deliveries += 1

    def _collect(self, rnd: int) -> None:
        for rep in self.replicas:
            for rid in sorted(rep.inflight):
                t, att = rep.inflight[rid]
                if not att.done_event.is_set():
                    continue
                del rep.inflight[rid]
                if (rep.lease.name, t) not in self._reaped:
                    rep.lease.release(t)
                self._deliver(self.requests[rid], att, rep.idx,
                              zombie=False)
            for rid in sorted(rep.zombie):
                att = rep.zombie[rid]
                if att.done_event.is_set():
                    del rep.zombie[rid]
                    self._deliver(self.requests[rid], att, rep.idx,
                                  zombie=True)

    def _fence_rep(self, rep: Replica) -> None:
        for s in sorted(rep.eng.active):
            rep.eng.quarantine(s)
        rep.process_alive = False
        rep.zombie.clear()
        self._log("fenced", replica=rep.idx)

    def _fence(self, rnd: int) -> None:
        """A partitioned replica that was declared dead halts when the
        partition heals and it observes the membership epoch it lost —
        its slots are quarantined so ITS exit audit is clean too."""
        for rep in self.replicas:
            if (rep.process_alive and not rep.alive
                    and rep.partition_until != -1
                    and not rep.partitioned(rnd)):
                self._fence_rep(rep)

    # ------------------------------------------------------------- loop ----

    def _process_retries(self, rnd: int) -> None:
        while self._retryq and self._retryq[0][0] <= rnd:
            _, rid = heapq.heappop(self._retryq)
            cr = self.requests[rid]
            if cr.state == "queued":
                self.queue.append(cr)

    def round(self) -> None:
        rnd = self.round_no
        self._clk[0] = rnd * self.inner_k * self.dt
        self._apply_cluster_faults(rnd)
        self._detect(rnd)
        self._process_retries(rnd)
        self._shed_pass()
        self._bind(rnd)
        self._admit(rnd)
        self._drive(rnd)
        self._collect(rnd)
        self._fence(rnd)
        self.round_no += 1

    def pending_work(self) -> bool:
        if any(cr.state in ("queued", "inflight")
               for cr in self.requests.values()):
            return True
        if self._retryq:
            return True
        # losing duplicates still running on LIVE replicas must drain
        # normally (release their tickets, hit the dedupe registry) —
        # stopping here would strand their leases for the reaper
        return any(rep.alive and rep.inflight for rep in self.replicas)

    def run(self, max_rounds: int = 200) -> dict:
        """Drive to drain (or ``max_rounds``), then settle the leases:
        keep scanning with the clock advancing until every leaked ticket
        is reaped.  Returns the exit report."""
        while self.pending_work() and self.round_no < max_rounds:
            self.round()
        # shutdown fencing: any corpse still running (a partition window
        # that outlived the workload) halts now
        for rep in self.replicas:
            if rep.process_alive and not rep.alive:
                self._fence_rep(rep)
        # settle: orphan leaks may still be aging toward the TTL
        for _ in range(8):
            if self.lease_audit()["ok"]:
                break
            self._clk[0] += self.ttl + self.dt
            for act in self.reaper.scan():
                self._reaped.add((act.lease, act.ticket))
                self.stats.orphans_reaped += 1
                self._log("reap", lease=act.lease, ticket=act.ticket,
                          how=act.action, age=round(act.age, 3))
        return self.report()

    # -------------------------------------------------------- reporting ----

    def lease_audit(self) -> dict:
        return leases_clean([rep.lease for rep in self.replicas])

    def report(self) -> dict:
        from ..resilience.recovery import exit_audit

        audits = {rep.idx: exit_audit(rep.eng) for rep in self.replicas
                  if rep.process_alive}
        return {
            "rounds": self.round_no,
            "stats": self.stats.__dict__.copy(),
            "shed": dict(self.shed),
            "completed": len(self.completed),
            "lease_audit": self.lease_audit(),
            "engine_audits": audits,
            "reaper": self.reaper.telemetry(),
            "stragglers": self.coord.stragglers(),
        }

    def cluster_spans(self) -> dict:
        """Stitched per-request span trees across the whole fleet: the
        router's fabric events (SUBMIT/ROUTE/MIGRATE/SHED) merged with
        every replica engine's in-scan event stream.  A migrated request
        comes back as ONE span whose segments carry the replica index
        that ran them, with a ``migration`` segment bridging the gap."""
        return build_spans(self.trace,
                           *[rep.eng._trace for rep in self.replicas])

    def fabric_telemetry(self) -> dict:
        """The router sections `obs.cluster.aggregate(router=...)` folds
        into the fleet report."""
        return {
            "leases": {
                rep.idx: {"headroom": rep.lease.headroom(),
                          "capacity": self.capacity,
                          "alive": rep.alive}
                for rep in self.replicas
            },
            "migrations": self.stats.migrated,
            "migration_latency": self.migration_hist.percentiles(),
            "shed": len(self.shed),
            "deaths": self.stats.replicas_dead,
            "duplicates_suppressed": self.stats.duplicates_suppressed,
        }

    def telemetry(self) -> dict:
        return {
            "round": self.round_no,
            "stats": self.stats.__dict__.copy(),
            "epoch": self.coord.epoch,
            "queue": len(self.queue),
            "fabric": self.fabric_telemetry(),
            "trace": {"events": len(self.trace),
                      "dropped": self.trace.dropped},
            "replicas": {
                rep.idx: {
                    "alive": rep.alive,
                    "process_alive": rep.process_alive,
                    "dead_reason": rep.dead_reason,
                    "headroom": rep.lease.headroom(),
                    "queue_depth": rep.lease.queue_depth(),
                    "inflight": len(rep.inflight),
                    "pending": len(rep.pending),
                    "breaker": rep.breaker.state,
                    "straggle": rep.straggle,
                    "driven_rounds": rep.driven_rounds,
                    "recovery": rep.eng.telemetry()["recovery"],
                } for rep in self.replicas
            },
            "reaper": self.reaper.telemetry(),
        }


# ------------------------------------------------------------------ toy ----


def toy_cluster(n_replicas: int, *, seed: int = 0, plan=None,
                engine_plans=None, n_slots: int = 2, capacity: int = 4,
                inner_k: int = 4, dt: float = 0.25, ttl_rounds: float = 2.5,
                snapshot_every: int = 0, standby: bool = False,
                watchdog: int = 4, obs=None, device=None, **router_kw):
    """The chunked block-paged toy cluster the example, bench, and tests
    share: ``n_replicas`` rid-deterministic engines (each request's token
    stream is a pure function of its rid — the property that makes
    exactly-once migration *bit-identical*) on one virtual clock and one
    KV store.  ``engine_plans``: {replica idx → engine-level FaultPlan}
    for sentinel/breaker scenarios; ``ttl_rounds``: TTL in router rounds.
    ``device``: where every replica engine lives (the card unless
    ``"cpu"`` is asked for); each engine runs its QoS round through the
    kernel (``use_kernel=True``).  Returns the router."""
    import tempfile

    from ..checkpoint.manager import CheckpointManager
    from ..resilience.recovery import ResilientEngine
    from .engine_state import rid_token_fn
    from .scheduler import ContinuousBatchingEngine

    kv = KVStore()
    clk = [0.0]
    engine_plans = engine_plans or {}

    def build_rz():
        # obs may be a shared EngineObs OR a zero-arg factory (one
        # recorder per replica — what per-replica flight bundles and the
        # fleet aggregator want)
        eng = ContinuousBatchingEngine(
            lambda a: np.array([r.rid * 1000 + len(r.out_tokens)
                                for r in a], np.int64),
            lambda r: None, n_slots=n_slots,
            tenants={"gold": 2.0, "bronze": 1.0}, clock=lambda: clk[0],
            kv_pool=(16, 4), chunked_prefill=(5, 9, 16), prompt_cap=32,
            use_kernel=True, watchdog=watchdog,
            obs=obs() if callable(obs) else obs, device=device)
        ck = CheckpointManager(tempfile.mkdtemp(prefix="repro-cluster-")) \
            if snapshot_every else None
        return ResilientEngine(eng, plan=None, react_every=2,
                               retry_budget=2, seed=seed, ckpt=ck,
                               snapshot_every=snapshot_every)

    replicas = []
    for i in range(n_replicas):
        rz = build_rz()
        if i in engine_plans:
            rz.plan = engine_plans[i]
        replicas.append(rz)
    return ReplicaRouter(
        replicas, kv=kv, clk=clk, token_fn=rid_token_fn,
        capacity=capacity, ttl=ttl_rounds * inner_k * dt, dt=dt,
        inner_k=inner_k, plan=plan, seed=seed,
        standby_factory=build_rz if standby else None,
        obs=None if callable(obs) else obs,
        **router_kw)


def toy_workload(n_req: int, seed: int = 0, *, deadline_frac: float = 0.0,
                 horizon: float = 40.0) -> list[ClusterRequest]:
    """Seeded mixed-tenant workload over the toy cluster's vocabulary."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_req):
        dl = None
        if deadline_frac and rng.random() < deadline_frac:
            dl = float(rng.uniform(2.0, horizon))
        out.append(ClusterRequest(
            rid=i, prompt=[1 + i % 7] * int(rng.integers(1, 19)),
            max_new_tokens=1 + int(rng.integers(0, 10)),
            tenant_id=("gold", "bronze")[int(rng.integers(0, 2))],
            deadline=dl))
    return out
