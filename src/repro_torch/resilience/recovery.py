"""The recovery ladder — escalating responses to sentinel health bits; the
port of ``repro.resilience.recovery``.

:class:`ResilientEngine` wraps a `serving.scheduler
.ContinuousBatchingEngine` and drives it (host ``step`` or ``megastep``)
with three additions, all deterministic:

1. **Fault injection** — the events of a seeded `faults.FaultPlan` are
   applied at their scheduled round boundaries (a megastep is split at
   fault rounds so both serving paths see each fault at the same
   boundary).
2. **Reaction boundaries** — the per-round health bitmask is
   OR-accumulated and examined every ``react_every`` rounds; both drives
   react at the same multiples, so ``megastep ≡ K·step`` survives
   recovery too.
3. **The ladder** — sick boundaries escalate:

   * rung 1, ``H_STUCK`` → :meth:`scheduler.quarantine` each wedged slot;
     the evicted request re-enters admission after a jittered exponential
     backoff (seeded PRNG), up to its retry budget, then is tombstoned;
   * rung 2, conservation bits → :meth:`scheduler.audit_kv` rebuilds the
     free queue and the block semaphore from the block tables; aliasing
     victims are quarantined;
   * rung 3, conservation STILL sick at the next boundary with the QoS
     kernel active → the engine's QoS round moves from the kernel to the
     functional torch round (``use_kernel=False``, on the same device),
     counted in ``stats.kernel_fallbacks`` and logged ``kernel_fallback``
     — the only thing that switches a kernel off;
   * rung 4, ``H_NAN`` or still sick → restore the last device snapshot
     through `checkpoint.manager.CheckpointManager` and replay the rounds
     since (re-applying every fault except the ones being repaired).
     ``CRASH`` faults take this rung directly.

Snapshots capture the persistent device state (QoS state, block pool and
tables, model) through the checkpoint manager, which copies every leaf
into fresh host memory, plus a host-side capture of every in-flight
request and of the host mirrors.  The port writes tensors in place (the
model's KV pools, the telemetry ring), so every tensor the host capture
keeps is a clone, and every tensor a restore puts back is fresh storage
on the engine's device: a replay never starts from post-crash state.

Replay determinism needs a round-stable clock (the virtual clocks every
test uses): replayed rounds re-read the injected ``clock=`` / sliced
``nows`` and re-fire the surviving plan events, so a crashed run converges
to the final state of an uncrashed one.
"""

from __future__ import annotations

import heapq
from collections import deque

import numpy as np
import torch

from ..serving import sentinels as sn
from ..serving.engine_state import drain
from ..serving.scheduler import _sdist
from .faults import (
    CORRUPTION_KINDS,
    CRASH,
    FaultPlan,
    InjectedCrash,
    KV_COUNTER,
    NAN_LOGIT,
    TORN_SHARD,
    apply_fault,
    tear_checkpoint,
)

# Request fields captured per snapshot (threading.Event bars deepcopy;
# out_tokens is list-copied separately, done_event becomes a bool flag)
_REQ_FIELDS = (
    "ticket", "bucket", "observed_seq", "fast", "slot", "expired",
    "preempted", "submit_clock", "first_tok_clock", "last_tok_clock",
    "finish_clock", "admit_round", "expire_round", "prefill_pos",
    "kv_blocks", "prio_key", "parked", "park_bucket", "park_seq",
    "last_adv_round", "retries",
)

_CONSERVE = (sn.H_KV_CONSERVE | sn.H_KV_PARTITION | sn.H_CREDIT_NEG
             | sn.H_BANKER | sn.H_SLOT_CONSERVE)


def _fresh(tree):
    """A copy of a state tuple of tensors (nested NamedTuples) in fresh
    storage on the same device."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_fresh(x) for x in tree])
    return tree


def exit_audit(engine) -> dict:
    """Exit-time conservation audit over host ground truth (plus the
    device block table when one persists, read back in one transfer).
    Returns ``{"ok": bool, "violations": [...]}``."""
    violations = []
    act = set(engine.active)
    free = set(engine.free_slots)
    if act & free or len(act) + len(free) != engine.n_slots:
        violations.append(
            f"slots: active {sorted(act)} ∪ free {sorted(free)} does not "
            f"partition {{0..{engine.n_slots - 1}}}")
    paged = engine._kv_pool is not None
    sharing = paged and engine._kv_share
    kv = engine._kv_state if paged else None
    if kv is not None:
        pool, tbl_t = kv.pool, kv.tbl
    elif sharing:
        # host-loop sharing: the replica pool and table ARE the ground
        # truth — audit them exactly like a persisted device pool
        pool, tbl_t = engine._kv_hpool, engine._kv_htbl
    else:
        pool = tbl_t = None
    dev_vals = {}
    if engine._tenants is not None:
        dev_vals["qos"] = (engine.qos.grant, engine.qos.consumed)
    if pool is not None:
        dev_vals["pool"] = (tbl_t, pool.sema.ticket, pool.sema.grant,
                            pool.free_q, pool.refcnt)
    dev_vals = drain(dev_vals)
    if engine._tenants is not None:
        credit = _sdist(*dev_vals["qos"])
        if (credit < 0).any():
            violations.append(f"negative tenant credit {credit.tolist()}")
    if paged:
        NB = engine._kv_blocks
        if sharing:
            # refcounted conservation: shared blocks are held ONCE
            held = int((engine._kv_refcnt_h > 0).sum())
        elif engine._chunk:
            held = sum(r.kv_blocks for r in engine.active.values())
        else:
            held = sum(engine._kv_demand(r)
                       for r in engine.active.values())
        if engine._kv_free_blocks + held != NB:
            violations.append(
                f"kv counter: free {engine._kv_free_blocks} + held "
                f"{held} != {NB}")
    if pool is not None:
        tbl, ticket, grant, free_q, refcnt = dev_vals["pool"]
        live = tbl[tbl >= 0]
        n_free = int(_sdist(grant, ticket))
        if n_free < 0 or n_free > NB:
            violations.append(f"kv sema free count {n_free} out of "
                              f"[0, {NB}]")
            return {"ok": False, "violations": violations}
        pos = (int(ticket) + np.arange(n_free)) & (NB - 1)
        if sharing:
            # generalized partition: {free ids} ∪ {refcnt > 0} tiles
            # {0..NB−1}, and table references equal the refcounts
            fid = free_q[pos]
            ok_f = (fid >= 0) & (fid < NB)
            cnt = np.bincount(fid[ok_f], minlength=NB)
            refs = np.bincount(live[live < NB], minlength=NB)
            if (~ok_f).any() or (live >= NB).any() or \
                    (cnt + (refcnt > 0) != 1).any():
                violations.append(
                    "kv partition: free queue ∪ {refcnt > 0} does not "
                    f"tile 0..{NB - 1}")
            if (refs != refcnt).any():
                violations.append(
                    "kv refcnt: table references do not match the pool "
                    "refcounts")
        else:
            ids = np.concatenate([free_q[pos], live])
            cnt = np.bincount(ids[(ids >= 0) & (ids < NB)], minlength=NB)
            if (ids < 0).any() or (ids >= NB).any() or (cnt != 1).any():
                violations.append(
                    "kv partition: free queue ∪ tables is not a "
                    f"permutation of 0..{NB - 1}")
    return {"ok": not violations, "violations": violations}


class ResilientEngine:
    """Fault-injecting, self-healing wrapper around a serving engine.

    Parameters: ``plan`` — the seeded fault schedule (default: none);
    ``react_every`` — reaction-boundary stride A (both drives react at
    round multiples of A); ``retry_budget`` / ``backoff_base`` /
    ``backoff_jitter`` — quarantine-requeue policy (delay rounds =
    ``base·2^retries + U[0, jitter]`` off the seeded PRNG); ``ckpt`` — a
    `CheckpointManager` enabling rung 4; ``snapshot_every`` — periodic
    snapshot stride in rounds (0: only the automatic pre-crash
    snapshot)."""

    def __init__(self, engine, *, plan: FaultPlan | None = None,
                 react_every: int = 1, retry_budget: int = 2,
                 backoff_base: int = 2, backoff_jitter: int = 2,
                 seed: int = 0, ckpt=None, snapshot_every: int = 0):
        self.engine = engine
        self.plan = plan if plan is not None else FaultPlan(seed=0)
        self.react_every = max(1, int(react_every))
        self.retry_budget = int(retry_budget)
        self.backoff_base = max(1, int(backoff_base))
        self.backoff_jitter = max(0, int(backoff_jitter))
        self._rng = np.random.default_rng(seed)
        self.ckpt = ckpt
        self.snapshot_every = int(snapshot_every)
        self.events: list[dict] = []  # chronological action/injection log
        # every telemetry sample the driven engine produced, in drive
        # order (replayed rounds append again: the literal history)
        self.samples: list[dict] = []
        self._retryq: list[tuple[int, int, object]] = []  # (due, rid, req)
        self._consumed: set[int] = set()  # plan event indices repaired
        self._conserve_streak = 0
        self._health_acc = 0
        self._snap = None  # (round, host_capture, ckpt_step) — newest
        # short history of snapshots: restore walks it newest→oldest past
        # an unreadable (torn) checkpoint
        self._snaps: list[tuple] = []
        self._snap_keep = 3

    # ------------------------------------------------------------- log ----

    def _log(self, rnd: int, action: str, **kw) -> None:
        self.events.append({"round": rnd, "action": action, **kw})

    def telemetry(self) -> dict:
        tel = self.engine.telemetry()
        tel["ladder_events"] = list(self.events)
        return tel

    def audit(self) -> dict:
        return exit_audit(self.engine)

    # ---------------------------------------------------------- drives ----

    def step(self, sample_fn) -> int:
        """One resilient host round: due requeues → snapshot → faults →
        ``engine.step`` → (at boundaries) react."""
        eng = self.engine
        r = eng._round_no
        if r % self.react_every == 0:
            self._process_retries(r)
        self._maybe_snapshot(r)
        try:
            self._apply_faults(r)
        except InjectedCrash:
            self._log(r, "crash")
            self._restore(r)
            n = 0
            while eng._round_no <= r:  # deterministic replay
                n = self.step(sample_fn)
            return n
        n = eng.step(sample_fn)
        if eng._last_samples:
            self.samples.extend(eng._last_samples)
            self._health_acc |= int(eng._last_samples[-1]["health"])
        if (r + 1) % self.react_every == 0:
            self._react(r + 1)
        return n

    def megastep(self, K: int, *, token_fn=None, nows=None, **kw) -> int:
        """K resilient scanned rounds: the launch is SPLIT at fault rounds,
        snapshot rounds and reaction boundaries, so every injection and
        reaction happens at the boundary the host drive would use."""
        eng = self.engine
        base = eng._round_no
        if nows is None:
            nows_a = np.zeros(K, np.float32)
        else:
            nows_a = np.asarray(nows, np.float32)
        n = len(eng.active)
        done = 0
        while done < K:
            r = base + done
            if r % self.react_every == 0:
                self._process_retries(r)
            self._maybe_snapshot(r)
            try:
                self._apply_faults(r)
            except InjectedCrash:
                self._log(r, "crash")
                rs = self._restore(r)
                done = rs - base  # replay from the snapshot round
                continue
            seg = self._segment_len(r, base + K)
            n = eng.megastep(seg, token_fn=token_fn,
                             nows=nows_a[done:done + seg], **kw)
            self.samples.extend(eng._last_samples)
            for smp in eng._last_samples:
                self._health_acc |= int(smp["health"])
            done += seg
            if (base + done) % self.react_every == 0:
                self._react(base + done)
                # a rung-4 reaction may have rewound the engine — resync
                # the cursor so the replay re-runs the rewound rounds (a
                # snapshot from an earlier call cannot be replayed here:
                # the caller's nows window does not cover it)
                rno = eng._round_no
                if rno != base + done:
                    if rno < base:
                        raise RuntimeError(
                            "restore rewound past this megastep's launch "
                            f"round ({rno} < {base}); use snapshot_every "
                            "aligned inside the launch window")
                    done = rno - base
        return n

    def _segment_len(self, r: int, end: int) -> int:
        """Rounds until the next boundary the scan must stop at."""
        cut = end
        nb = r - r % self.react_every + self.react_every
        cut = min(cut, nb)
        if self.snapshot_every and self.ckpt is not None:
            ns = r - r % self.snapshot_every + self.snapshot_every
            cut = min(cut, ns)
        for i, ev in enumerate(self.plan.events):
            if ev.round > r and i not in self._consumed:
                cut = min(cut, ev.round)
        return max(1, cut - r)

    # ------------------------------------------------------- injection ----

    def _apply_faults(self, r: int) -> None:
        for i, ev in enumerate(self.plan.events):
            if ev.round != r or i in self._consumed:
                continue
            if ev.kind == CRASH:
                self._consumed.add(i)  # one-shot: replay must not re-crash
                raise InjectedCrash(ev)
            if ev.kind == TORN_SHARD:
                # handled here like CRASH: corrupt the newest on-disk
                # checkpoint (one-shot — replay must not re-tear a freshly
                # written snapshot)
                self._consumed.add(i)
                torn = tear_checkpoint(self.ckpt) if self.ckpt else 0
                self._log(r, "inject", kind=ev.kind, applied=bool(torn))
                continue
            applied = apply_fault(self.engine, ev)
            self._log(r, "inject", kind=ev.kind, delta=ev.delta,
                      applied=bool(applied))

    # ------------------------------------------------- retries (rung 1) ----

    def _process_retries(self, r: int) -> None:
        eng = self.engine
        while self._retryq and self._retryq[0][0] <= r:
            _, _, req = heapq.heappop(self._retryq)
            req.retries += 1
            eng.stats.requeued += 1
            eng.submit(req)  # fresh ticket, fresh FCFS position
            self._log(r, "requeue", rid=req.rid, attempt=req.retries)

    def _quarantine(self, slot: int, rnd: int) -> None:
        eng = self.engine
        req = eng.quarantine(slot)
        self._log(rnd, "quarantine", slot=slot, rid=req.rid)
        if req.retries < self.retry_budget:
            delay = (self.backoff_base * (1 << req.retries)
                     + int(self._rng.integers(0, self.backoff_jitter + 1)))
            heapq.heappush(self._retryq, (rnd + delay, req.rid, req))
        else:
            with eng._lock:  # budget exhausted: tombstone (still drains)
                eng._expire_req(req, eng._tindex[req.tenant_id])
            self._log(rnd, "give_up", rid=req.rid)

    # -------------------------------------------------------- reaction ----

    def _react(self, boundary: int) -> None:
        h = self._health_acc
        self._health_acc = 0
        if h == 0:
            self._conserve_streak = 0
            return
        eng = self.engine
        self._log(boundary, "health", bits=sn.decode_health(h))
        # flight recorder: the ladder engaging IS the post-mortem moment —
        # cut a bundle before any rung mutates engine state
        fl = getattr(getattr(eng, "_obs", None), "flight", None)
        if fl is not None:
            fl.dump("recovery_ladder",
                    extra={"boundary": boundary, "mask": h,
                           "flags": sn.decode_health(h)})
        if h & sn.H_STUCK:
            W = eng._watchdog
            last = boundary - 1  # the last executed round's watchdog view
            for s in sorted(eng.active):
                if last - eng.active[s].last_adv_round >= W > 0:
                    self._quarantine(s, boundary)
        if h & _CONSERVE:
            self._conserve_streak += 1
            if self._conserve_streak == 1 and eng._kv_pool is not None:
                rep = eng.audit_kv()  # rung 2
                self._log(boundary, "audit_kv",
                          **{k: v for k, v in rep.items()})
                for s in rep["victims"]:
                    if s in eng.active:
                        self._quarantine(s, boundary)
            elif eng._use_kernel:
                eng._use_kernel = False  # rung 3: the functional round
                eng.stats.kernel_fallbacks += 1
                self._log(boundary, "kernel_fallback")
            else:
                self._rung4(boundary)
        else:
            self._conserve_streak = 0
        if h & sn.H_NAN:
            self._rung4(boundary)  # nothing below rung 4 un-poisons

    # ------------------------------------------ snapshot/restore (rung 4) ----

    def _device_tree(self):
        eng = self.engine
        kv = eng._kv_state if eng._kv_pool is not None else None
        return {
            "qos": eng.qos,
            "kv": kv if kv is not None else (),
            "model": eng.megastep_model
            if eng.megastep_model is not None else (),
        }

    def _maybe_snapshot(self, r: int) -> None:
        if self.ckpt is None:
            return
        due = self.snapshot_every and r % self.snapshot_every == 0
        first = self._snap is None and any(
            ev.kind == CRASH and i not in self._consumed
            for i, ev in enumerate(self.plan.events))
        if due or first:
            self._snapshot(r)

    def _snapshot(self, r: int) -> None:
        eng = self.engine
        self.ckpt.save_sync(r, self._device_tree())
        self._snap = (r, self._capture_host(), r)
        self._snaps = [s for s in self._snaps if s[0] != r]
        self._snaps.append(self._snap)
        del self._snaps[:-self._snap_keep]
        eng.stats.snapshots += 1
        self._log(r, "snapshot", step=r)

    def _capture_host(self) -> dict:
        eng = self.engine
        reqs = {}

        def cap(r):
            if id(r) not in reqs:
                reqs[id(r)] = (r, {f: getattr(r, f) for f in _REQ_FIELDS},
                               list(r.out_tokens), r.done_event.is_set())

        for r in eng.active.values():
            cap(r)
        for r in eng.backlog:
            cap(r)
        snap = {
            "round_no": eng._round_no,
            "free_slots": list(eng.free_slots),
            "active": dict(eng.active),
            "backlog": list(eng.backlog),
            "stats": dict(eng.stats.__dict__),
            "sema": _fresh(eng.sema),
            "sema_t": eng._sema_ticket_h, "sema_g": eng._sema_grant_h,
            "sticky": eng._nonfinite_sticky,
            "ladder": {
                "retryq": list(self._retryq),
                "consumed": set(self._consumed),
                "streak": self._conserve_streak,
                "health": self._health_acc,
                "rng": self._rng.bit_generator.state,
            },
        }
        if eng._tenants is not None:
            for q in eng._tenant_queues:
                for r in q:
                    cap(r)
            snap.update(
                qos_free=eng._qos_free,
                tenant_queues=[list(q) for q in eng._tenant_queues],
                tenant_live=eng._tenant_live.copy(),
                tenant_admitted=dict(eng.tenant_admitted),
                tenant_expired=dict(eng.tenant_expired),
                deadline_heap=list(eng._deadline_heap))
        if eng._kv_pool is not None:
            snap.update(kv_free=eng._kv_free_blocks,
                        kv_sema=_fresh(eng._kv_sema))
        for _, _, r in self._retryq:
            cap(r)
        snap["requests"] = reqs
        return snap

    def _restore(self, at_round: int) -> int:
        """Rung 4 core: device tree ← checkpoint, host state ← capture.
        Walks the snapshot history newest→oldest past unreadable (torn)
        checkpoints.  Returns the snapshot round (replay resumes there)."""
        if self.ckpt is None or self._snap is None:
            self._log(at_round, "unrecoverable")
            return at_round
        eng = self.engine
        tree = None
        for snap in reversed(self._snaps or [self._snap]):
            rs, host, step = snap
            try:
                tree, _ = self.ckpt.restore(self._device_tree(), step=step)
                break
            except Exception as exc:  # torn shard / missing step: fall back
                self._log(at_round, "torn_shard_fallback", step=step,
                          error=type(exc).__name__)
        if tree is None:
            self._log(at_round, "unrecoverable")
            return at_round
        self._snap = (rs, host, step)  # the snapshot that actually loaded
        # the checkpoint's leaves come back as fresh storage on the
        # engine's device; the host capture's tensors are cloned again, so
        # a second restore of this snapshot starts from the same state
        eng.qos = tree["qos"]
        if isinstance(tree["kv"], tuple) and tree["kv"]:
            eng._kv_state = tree["kv"]
        if isinstance(tree["model"], dict):
            eng.megastep_model = tree["model"]
        eng._round_no = host["round_no"]
        eng.free_slots = list(host["free_slots"])
        eng.active = dict(host["active"])
        eng.backlog = list(host["backlog"])
        eng.stats.__dict__.update(host["stats"])
        eng.sema = _fresh(host["sema"])
        eng._sema_ticket_h = host["sema_t"]
        eng._sema_grant_h = host["sema_g"]
        eng._nonfinite_sticky = host["sticky"]
        if eng._tenants is not None:
            eng._qos_free = host["qos_free"]
            eng._tenant_queues = [deque(q) for q in host["tenant_queues"]]
            eng._tenant_live = host["tenant_live"].copy()
            eng.tenant_admitted = dict(host["tenant_admitted"])
            eng.tenant_expired = dict(host["tenant_expired"])
            eng._deadline_heap = list(host["deadline_heap"])
            heapq.heapify(eng._deadline_heap)
        if eng._kv_pool is not None:
            eng._kv_free_blocks = host["kv_free"]
            eng._kv_sema = _fresh(host["kv_sema"])
        for r, fields, toks, done in host["requests"].values():
            for f, v in fields.items():
                setattr(r, f, v)
            r.out_tokens[:] = list(toks)
            if done:
                r.done_event.set()
            else:
                r.done_event.clear()
        lad = host["ladder"]
        self._retryq = list(lad["retryq"])
        heapq.heapify(self._retryq)
        self._conserve_streak = lad["streak"]
        self._health_acc = lad["health"]
        self._rng.bit_generator.state = lad["rng"]
        # restore MUST NOT resurrect the repaired corruption: consumed is
        # the union of what was consumed at snapshot time and now
        self._consumed |= set(lad["consumed"])
        eng.stats.restores += 1
        self._log(rs, "restore", step=step, from_round=at_round)
        return rs

    def _rung4(self, boundary: int) -> None:
        """Sickness-triggered restore: mark every past corruption event
        (incl. model poison) repaired so the replay converges clean."""
        for i, ev in enumerate(self.plan.events):
            if ev.round < boundary and (ev.kind in CORRUPTION_KINDS
                                        or ev.kind == NAN_LOGIT
                                        or (ev.kind == KV_COUNTER
                                            and ev.delta > 0)):
                self._consumed.add(i)
        self._restore(boundary)
        self._conserve_streak = 0
