"""Deterministic fault injection for the serving engine — the port of
``repro.resilience.faults``.

A :class:`FaultPlan` is a seeded, immutable schedule of
:class:`FaultEvent`\\ s — (round, kind, magnitude) triples drawn from a
``numpy`` PRNG, so the same seed yields the same fault stream on every
run, on both serving paths and in both packages.  :func:`apply_fault`
mutates the engine's state at an engine boundary (between rounds): it
always updates the host mirrors, and additionally patches the persistent
device state (block pool, model) when the engine carries one — which is
what makes the equivalence property (``megastep(K) ≡ K·step()``) extend
to faulty runs: both paths see the same state mutation at the same round
boundary.  Device state is patched out of place (`core.functional`
``post_batch``, ``scatter_set``, fresh tensors), never written into.

Fault kinds split into two classes:

**Capacity-loss faults** (``CAPACITY_KINDS``) destroy capacity or progress
but never forge state the two serving paths represent differently:

* ``DROP_POKE``   — a parked slot's observed bucket sequence is reset to
  the current value: the wake poke it was waiting on is lost;
* ``KV_COUNTER``  with ``delta < 0`` — the block semaphore's grant is
  silently decremented: free blocks leak (trips ``H_KV_CONSERVE``);
* ``STUCK_SLOT``  — a busy MID-PREFILL slot is force-parked on an
  arbitrary bucket with a current sequence snapshot: it wedges until some
  release pokes that bucket, or the watchdog trips (chunked engines only).

**Corruption faults** (``CORRUPTION_KINDS``) forge block identities or
poison the model, which only the device path physically holds:

* ``KV_COUNTER`` with ``delta > 0`` — phantom free blocks;
* ``DOUBLE_RELEASE`` — a live block id is appended to the free queue a
  second time (aliasing: ``H_KV_PARTITION``);
* ``NAN_LOGIT``   — the first float leaf of the device model (in JAX's
  flatten order: dict keys sorted) is poisoned with NaN (``H_NAN``); the
  host mirror sets the engine's sticky nonfinite flag;
* ``BIT_FLIP``    — one bit (1, 2, 4, 8 or 16) of a live device
  block-table entry flips.  In a pool of more than 16 blocks the flipped
  id stays in range and aliases another block; a flip past the pool
  (a pool of at most 16 blocks and bit 16) makes the port's pool and
  attention indexing raise where JAX drops or clamps the index.

``CRASH`` raises :class:`InjectedCrash` at the boundary (rung 4: snapshot
restore and replay).  ``TORN_SHARD`` is handled like CRASH:
`recovery.ResilientEngine` tears the newest on-disk checkpoint
(:func:`tear_checkpoint`).  **Cluster kinds** (``CLUSTER_KINDS``) are a
router's to apply; they never reach `apply_fault`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..checkpoint.manager import path_leaves
from ..core import u32
from ..core.functional import post_batch, scatter_set
from ..serving.engine_state import drain

DROP_POKE = "drop_poke"
KV_COUNTER = "kv_counter"
DOUBLE_RELEASE = "double_release"
NAN_LOGIT = "nan_logit"
STUCK_SLOT = "stuck_slot"
BIT_FLIP = "bit_flip"
TORN_SHARD = "torn_shard"
CRASH = "crash"

CAPACITY_KINDS = (DROP_POKE, KV_COUNTER, STUCK_SLOT)
CORRUPTION_KINDS = (DOUBLE_RELEASE, NAN_LOGIT, BIT_FLIP)
ALL_KINDS = CAPACITY_KINDS + CORRUPTION_KINDS + (CRASH,)

# --- cluster-level fault kinds (a router consumes these) ------------------
REPLICA_KILL = "replica_kill"    # delta: engine rounds INTO the megastep
#                                  at which the process dies (mid-launch)
KV_PARTITION = "kv_partition"    # delta: window length in router rounds
LEASE_LEAK = "lease_leak"        # an orphan ticket on the replica's lease
STRAGGLER = "straggler"          # delta: slowdown factor f

CLUSTER_KINDS = (REPLICA_KILL, KV_PARTITION, LEASE_LEAK, STRAGGLER)


class InjectedCrash(RuntimeError):
    """Raised by a ``CRASH`` fault at the engine boundary; carries the
    event so `recovery.ResilientEngine` can consume it (one-shot)."""

    def __init__(self, event: "FaultEvent"):
        super().__init__(f"injected crash at round {event.round}")
        self.event = event


@dataclass(frozen=True)
class FaultEvent:
    round: int       # engine round BEFORE which the fault fires
    kind: str        # one of the module's kind constants
    delta: int = 0   # KV_COUNTER: signed counter corruption magnitude
    arg: int = 0     # kind-specific (STUCK_SLOT: target park bucket)


@dataclass(frozen=True)
class FaultPlan:
    """Immutable, seeded fault schedule.  The plan is pure data —
    consumption bookkeeping lives in `recovery.ResilientEngine` — so ONE
    plan object can be shared by a host-loop run and a megastep run."""

    seed: int
    events: tuple = field(default_factory=tuple)

    @classmethod
    def random(cls, seed: int, *, rounds: int, n_faults: int = 3,
               kinds: tuple = CAPACITY_KINDS, max_delta: int = 4,
               first_round: int = 1) -> "FaultPlan":
        """Draw ``n_faults`` events uniformly over kinds and rounds in
        ``[first_round, rounds)``.  Same seed → same plan, always."""
        rng = np.random.default_rng(seed)
        evs = []
        lo = min(first_round, max(rounds - 1, 0))
        for _ in range(n_faults):
            r = int(rng.integers(lo, max(rounds, lo + 1)))
            kind = kinds[int(rng.integers(0, len(kinds)))]
            delta = 0
            if kind == KV_COUNTER:
                delta = -int(rng.integers(1, max_delta + 1))
            evs.append(FaultEvent(round=r, kind=kind, delta=delta,
                                  arg=int(rng.integers(0, 64))))
        evs.sort(key=lambda e: (e.round, e.kind, e.delta, e.arg))
        return cls(seed=seed, events=tuple(evs))

    @classmethod
    def cluster(cls, seed: int, *, rounds: int, n_replicas: int,
                n_leaks: int = 1, partition_rounds: int = 3,
                straggle_factor: int = 3) -> "FaultPlan":
        """The cluster chaos ladder: one replica killed mid-megastep, one
        straggler, one KV-store partition window, plus ``n_leaks`` orphan
        lease tickets — on three distinct seeded replicas, at seeded
        rounds in the first half of the run.  Same seed → same plan."""
        if n_replicas < 3:
            raise ValueError("cluster plan needs ≥ 3 replicas (kill, "
                             "straggler and partition hit distinct ones)")
        rng = np.random.default_rng(seed)
        reps = rng.permutation(n_replicas)[:3]
        hi = max(2, rounds // 2)
        evs = [
            FaultEvent(round=int(rng.integers(1, hi)), kind=REPLICA_KILL,
                       delta=int(rng.integers(1, 4)), arg=int(reps[0])),
            FaultEvent(round=int(rng.integers(1, hi)), kind=STRAGGLER,
                       delta=int(straggle_factor), arg=int(reps[1])),
            FaultEvent(round=int(rng.integers(1, hi)), kind=KV_PARTITION,
                       delta=int(partition_rounds), arg=int(reps[2])),
        ]
        for _ in range(n_leaks):
            evs.append(FaultEvent(round=int(rng.integers(1, hi)),
                                  kind=LEASE_LEAK,
                                  arg=int(rng.integers(0, n_replicas))))
        evs.sort(key=lambda e: (e.round, e.kind, e.delta, e.arg))
        return cls(seed=seed, events=tuple(evs))

    def with_crash(self, rnd: int) -> "FaultPlan":
        evs = sorted(self.events + (FaultEvent(round=rnd, kind=CRASH),),
                     key=lambda e: (e.round, e.kind, e.delta, e.arg))
        return FaultPlan(seed=self.seed, events=tuple(evs))

    def rounds(self) -> list[int]:
        return sorted({e.round for e in self.events})


# ---------------------------------------------------------- injection ----


def tear_checkpoint(ckpt) -> int:
    """``TORN_SHARD``'s teeth: truncate the shard files of the NEWEST
    complete step in ``ckpt`` (a `CheckpointManager`), leaving the
    directory and meta.json intact — the torn write a crashed writer
    leaves behind a rename barrier.  A later ``restore`` of that step
    raises.  Returns the number of shards torn (0: nothing to tear)."""
    step = ckpt.latest_step()
    if step is None:
        return 0
    d = ckpt.dir / f"step_{step:09d}"
    torn = 0
    for shard in sorted(d.glob("shard_*.pt")):
        size = shard.stat().st_size
        if size < 2:
            continue
        with open(shard, "r+b") as f:
            f.truncate(size // 2)
        torn += 1
    return torn


def _replace_at(tree, path, leaf):
    if not path:
        return leaf
    k, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {**tree, k: _replace_at(tree[k], rest, leaf)}
    items = list(tree)
    items[k] = _replace_at(items[k], rest, leaf)
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else type(tree)(items)


def _poison_model(model):
    """NaN the first element of the model's first float leaf in JAX's
    flatten order (device poison), through a new tensor: the live leaf is
    not written."""
    for path, leaf in path_leaves(model):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            new = leaf.clone(memory_format=torch.contiguous_format)
            new.view(-1)[0] = float("nan")
            return _replace_at(model, path, new)
    return model


def apply_fault(engine, ev: FaultEvent) -> bool:
    """Inject ``ev`` into ``engine`` at the current engine boundary.
    Mutates the host mirrors always, plus the persistent device state
    (block pool, model) when the engine carries one, so host-loop and
    megastep engines observe the same state change.  Returns True if the
    fault found a target.  ``CRASH`` raises :class:`InjectedCrash`."""
    if ev.kind == CRASH:
        raise InjectedCrash(ev)
    if ev.kind == TORN_SHARD or ev.kind in CLUSTER_KINDS:
        raise ValueError(
            f"{ev.kind!r} is not an engine-state mutation "
            "(ResilientEngine tears checkpoints; a router applies "
            "cluster kinds)")

    dev = engine.device
    with engine._lock:
        if ev.kind == DROP_POKE:
            seq = drain(engine._kv_sema.bucket_seq) \
                if engine._kv_pool is not None else None
            for s in sorted(engine.active):
                r = engine.active[s]
                if r.parked and seq is not None:
                    # the park's memo is overwritten with the CURRENT
                    # sequence: any poke since park time is forgotten
                    r.park_seq = int(seq[r.park_bucket])
                    return True
            return False

        if ev.kind == KV_COUNTER:
            if engine._kv_pool is None or ev.delta == 0:
                return False
            d = int(ev.delta)
            engine._kv_free_blocks += d
            engine._kv_sema = engine._kv_sema._replace(
                grant=u32.add(engine._kv_sema.grant, d & u32.MASK32))
            kv = engine._kv_state
            if kv is not None:
                sema = kv.pool.sema._replace(
                    grant=u32.add(kv.pool.sema.grant, d & u32.MASK32))
                engine._kv_state = kv._replace(
                    pool=kv.pool._replace(sema=sema))
                engine._kv_sema = sema  # the mirror IS the device sema
            return True

        if ev.kind == DOUBLE_RELEASE:
            if engine._kv_pool is None:
                return False
            engine._kv_free_blocks += 1
            kv = engine._kv_state
            if kv is not None:
                NB = kv.pool.free_q.shape[0]
                tbl, free_q, ticket, grant = drain(
                    (kv.tbl, kv.pool.free_q, kv.pool.sema.ticket,
                     kv.pool.sema.grant))
                live = tbl.reshape(-1)
                live = live[live >= 0]
                # re-free a LIVE block when one exists (true aliasing);
                # else re-free the head of the free region (double free)
                victim = int(live[0]) if live.size else int(
                    free_q[int(ticket) & (NB - 1)])
                free_q = scatter_set(
                    kv.pool.free_q,
                    torch.tensor([int(grant) & (NB - 1)], device=dev),
                    torch.tensor([victim], dtype=torch.int32, device=dev))
                sema = post_batch(kv.pool.sema, 1)  # grant+1, bucket poke
                engine._kv_state = kv._replace(
                    pool=kv.pool._replace(sema=sema, free_q=free_q))
                engine._kv_sema = sema
            else:
                engine._kv_sema = post_batch(engine._kv_sema, 1)
            return True

        if ev.kind == NAN_LOGIT:
            engine._nonfinite_sticky = True  # host H_NAN until restored
            if engine.megastep_model is not None:
                engine.megastep_model = _poison_model(engine.megastep_model)
            return True

        if ev.kind == BIT_FLIP:
            # flip one bit of a LIVE device block-table entry: the cell now
            # names another slot's block (aliasing) — the deep partition
            # sentinel trips and rung 2's audit_kv clears the forged cell
            # and quarantines the victim slot.  Device path only.
            if engine._kv_pool is None or engine._kv_state is None:
                return False
            kv = engine._kv_state
            tbl = drain(kv.tbl)
            live = np.argwhere(tbl >= 0)
            if live.size == 0:
                return False
            s, j = (int(v) for v in live[ev.arg % len(live)])
            bit = 1 << (abs(int(ev.delta)) % 5)  # low bits: in/near range
            new_tbl = kv.tbl.clone()
            new_tbl[s, j] = int(tbl[s, j]) ^ bit
            engine._kv_state = kv._replace(tbl=new_tbl)
            return True

        if ev.kind == STUCK_SLOT:
            if not engine._chunk:
                return False  # only the chunk phase honors parks
            seq = drain(engine._kv_sema.bucket_seq)
            table = len(seq)
            for s in sorted(engine.active):
                r = engine.active[s]
                # only a MID-PREFILL slot wedges the same way on both
                # paths (parks gate the chunk phase; a decode-phase slot
                # keeps emitting in-scan)
                if not r.parked and r.prefill_pos < len(r.prompt):
                    b = ev.arg % table
                    r.parked = True
                    r.park_bucket = b
                    r.park_seq = int(seq[b])
                    return True
            return False

    raise ValueError(f"unknown fault kind {ev.kind!r}")
