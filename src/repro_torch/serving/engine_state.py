"""Device-resident decode megastep on tensors — the port of
``repro.serving.engine_state`` for the unpaged and the up-front paged
modes.

One :func:`engine_round` is the pure-functional engine iteration:

  preempt expired running slots  →  QoS admission round (freed units feed
  the same round's replenish)  →  block gate (paged)  →  assign free slots
  to admitted rows in wrap-safe FCFS order  →  decode + sample every busy
  slot  →  retire completed slots  →  append the round's telemetry sample.

:func:`megastep_scan` runs K rounds as a plain loop; the caller drains
their outputs in ONE device→host transfer (:func:`drain`).  A round never
synchronizes with the host: where the reference branches on device data
with ``lax.cond`` the port computes both sides and selects with
``torch.where`` (or, where the skipped side is an identity on an empty
mask, runs the unconditional side, which is bit-identical), and on CUDA
every round runs under ``torch.cuda.set_sync_debug_mode("error")``, so a
hidden sync raises.  State is immutable except where noted: the model's KV
pools and the telemetry ring are updated in place (the reference donates
both buffers to the scan).

With ``kv=`` the allocator is the paper's semaphore at block granularity
(`core.functional.BlockPool`): admission gates on a free slot and on the
sequence's worst-case block demand ``⌈(prompt_len + max_new)/BS⌉``; the
longest FCFS prefix that fits is granted, the rest refund their slot
credit and retry next round; preempted slots post their blocks back
before admission, completed slots after decode.

Not in this slice (each raises ``NotImplementedError``): continuous
chunked prefill, prefix sharing (ROADMAP queue 1, items 1–2).
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..admission.functional_qos import (
    INT32_MAX,
    QoSState,
    block_gate,
    qos_scan_round,
)
from ..core import u32
from ..core.functional import (
    BlockPool,
    SemaState,
    _sdist,
    bucket_histogram,
    make_block_pool,
    make_sema,
    pool_alloc,
    pool_free_count,
    pool_release,
    post_batch,
    put_rows_,
    scatter_set,
    segment_counts,
    take_batch,
)
from . import events
from .prefill import pending_prompt_tokens, total_block_demand
from .sentinels import round_health

# admission-order sort key packs (clamped ticket distance, tenant index)
# into one int32: distances beyond ±2²⁰ cannot occur for admitted rows,
# tenant index < 256.
_D_CLAMP = 1 << 20
_T_BITS = 8

# waiting-array width of the engine-owned semaphores (free-slot sema and
# block pool) — also the width of the telemetry occupancy histogram.
SLOT_TABLE = 64



class Backlog(NamedTuple):
    """Waiting requests, device-resident (static capacity B ≥ S)."""

    valid: torch.Tensor         # (B,) bool — ticketed, not admitted/expired
    tenant: torch.Tensor        # (B,) i32
    ticket: torch.Tensor        # (B,) u32
    deadline: torch.Tensor      # (B,) f32 — relative to the megastep epoch
    rid: torch.Tensor           # (B,) i32
    max_new: torch.Tensor       # (B,) i32
    prompt: torch.Tensor        # (B, P) i32 — padded prompt tokens
    prompt_len: torch.Tensor    # (B,) i32
    admit_round: torch.Tensor   # (B,) i32 — global round of admission (-1)
    expire_round: torch.Tensor  # (B,) i32 — global round of expiry (-1)
    slot: torch.Tensor          # (B,) i32 — slot assigned at admission (-1)


class Slots(NamedTuple):
    """Per-slot decode state (S rows of the batched KV cache)."""

    busy: torch.Tensor       # (S,) bool
    row: torch.Tensor        # (S,) i32 — backlog row served (B+s ⇒ active at launch)
    rid: torch.Tensor        # (S,) i32
    tenant: torch.Tensor     # (S,) i32
    deadline: torch.Tensor   # (S,) f32 — decode deadline, epoch-relative
    max_new: torch.Tensor    # (S,) i32
    emitted: torch.Tensor    # (S,) i32 — tokens emitted so far
    token: torch.Tensor      # (S,) i32 — last token (next decode input)
    pos: torch.Tensor        # (S,) i32 — KV write cursor
    plen: torch.Tensor       # (S,) i32 — prompt length
    prompt: torch.Tensor     # (S, P) i32
    prio_r: torch.Tensor     # (S,) i32 — admission round
    prio_k: torch.Tensor     # (S,) i32 — packed FCFS admission key
    parked: torch.Tensor     # (S,) bool — block-parked (chunked mode)
    park_bucket: torch.Tensor  # (S,) i32
    park_seq: torch.Tensor     # (S,) u32
    chunk: torch.Tensor      # (S,) i32 — prefill tokens this round (chunked)
    last_adv: torch.Tensor   # (S,) i32 — last round with progress (watchdog)


class KVPool(NamedTuple):
    """Block-paged KV state: the TWA block semaphore over the circular
    free queue plus the per-slot block tables."""

    pool: BlockPool
    tbl: torch.Tensor        # (S, MB) i32 — per-slot block ids, -1 = none


class TelemetrySample(NamedTuple):
    """One round's end-of-round probe set (see the reference's
    ``TelemetrySample`` for the meaning of each field)."""

    round_no: torch.Tensor         # i32
    now: torch.Tensor              # f32
    admits: torch.Tensor           # i32
    expires: torch.Tensor          # i32
    preempts: torch.Tensor         # i32
    tokens: torch.Tensor           # i32
    prefill_tokens: torch.Tensor   # i32
    prefill_chunks: torch.Tensor   # i32
    prefill_pending: torch.Tensor  # i32
    gate_stalls: torch.Tensor      # i32
    parked: torch.Tensor           # i32
    backlog: torch.Tensor          # i32
    active: torch.Tensor           # i32
    slot_free: torch.Tensor        # i32
    kv_free: torch.Tensor          # i32
    kv_pokes: torch.Tensor         # u32
    prefix_hits: torch.Tensor      # i32
    blocks_shared: torch.Tensor    # i32
    cow_copies: torch.Tensor       # i32
    health: torch.Tensor           # u32 — sentinel bitmask (0 = healthy)
    credit: torch.Tensor           # (T,) i32
    poke_dead: torch.Tensor        # (T,) u32
    kv_wait_hist: torch.Tensor     # (H,) i32
    ev_n: torch.Tensor             # i32
    ev_kind: torch.Tensor          # (E,) i32
    ev_uid: torch.Tensor           # (E,) i32
    ev_slot: torch.Tensor          # (E,) i32
    ev_arg: torch.Tensor           # (E,) i32


class TelemetryRing(NamedTuple):
    """Fixed-capacity ring of samples (capacity R = pow2 ≥ K)."""

    cursor: torch.Tensor      # i32 — next write index (monotonic)
    buf: TelemetrySample      # every leaf has leading dim R


def make_telemetry_ring(capacity: int, n_tenants: int,
                        hist: int = SLOT_TABLE, ev_cap: int = 0,
                        device=None) -> TelemetryRing:
    assert capacity > 0 and (capacity & (capacity - 1)) == 0, \
        "ring capacity must be a power of two (wrap-safe cursor mask)"
    R, T = capacity, n_tenants

    def z(*shape, dtype=torch.int32, fill=0):
        return torch.full((R, *shape), fill, dtype=dtype, device=device)

    return TelemetryRing(
        cursor=torch.zeros((), dtype=torch.int32, device=device),
        buf=TelemetrySample(
            round_no=z(), now=z(dtype=torch.float32), admits=z(),
            expires=z(), preempts=z(), tokens=z(), prefill_tokens=z(),
            prefill_chunks=z(), prefill_pending=z(), gate_stalls=z(),
            parked=z(), backlog=z(), active=z(), slot_free=z(), kv_free=z(),
            kv_pokes=z(dtype=torch.int64), prefix_hits=z(),
            blocks_shared=z(), cow_copies=z(), health=z(dtype=torch.int64),
            credit=z(T), poke_dead=z(T, dtype=torch.int64),
            kv_wait_hist=z(hist), ev_n=z(), ev_kind=z(ev_cap),
            ev_uid=z(ev_cap, fill=-1), ev_slot=z(ev_cap, fill=-1),
            ev_arg=z(ev_cap)))


def ring_append(ring: TelemetryRing, sample: TelemetrySample) -> TelemetryRing:
    """Write ``sample`` at the cursor — IN PLACE on the ring's buffers."""
    R = ring.buf.round_no.shape[0]
    idx = (ring.cursor & (R - 1)).to(torch.int64).view(1)
    for b, s in zip(ring.buf, sample):
        b.index_copy_(0, idx, s.to(b.dtype).unsqueeze(0))
    return ring._replace(cursor=ring.cursor + 1)


def ring_samples(ring, t0: float = 0.0) -> list:
    """Host-side drain: a ring whose leaves are numpy arrays (already
    drained) as a list of per-round dicts in round order, oldest first —
    the record shape of the reference's ``ring_samples``.  ``t0``
    re-anchors the epoch-relative clocks (``clock = t0 + now``)."""
    buf, n = ring.buf, int(ring.cursor)
    R = buf.round_no.shape[0]
    out = []
    for i in range(max(n - R, 0), n):
        k = i & (R - 1)
        ne = int(buf.ev_n[k])
        out.append({
            "round": int(buf.round_no[k]),
            "clock": float(t0) + float(buf.now[k]),
            **{f: int(getattr(buf, f)[k]) for f in (
                "admits", "expires", "preempts", "tokens", "prefill_tokens",
                "prefill_chunks", "prefill_pending", "gate_stalls", "parked",
                "backlog", "active", "slot_free", "kv_free", "kv_pokes",
                "prefix_hits", "blocks_shared", "cow_copies", "health")},
            "credit": [int(c) for c in buf.credit[k]],
            "poke_dead": [int(d) for d in buf.poke_dead[k]],
            "kv_wait_hist": [int(h) for h in buf.kv_wait_hist[k]],
            "events": [[int(ek), int(eu), int(es), int(ea)]
                       for ek, eu, es, ea in zip(
                           buf.ev_kind[k][:ne], buf.ev_uid[k][:ne],
                           buf.ev_slot[k][:ne], buf.ev_arg[k][:ne])],
        })
    return out


class EngineState(NamedTuple):
    """The engine state carried from round to round."""

    qos: QoSState
    slot_sema: SemaState            # free-slot semaphore (grant−ticket = free)
    free: torch.Tensor              # i32 — undistributed global slot pool
    round_no: torch.Tensor          # i32 — global engine round counter
    backlog: Backlog
    slots: Slots
    kv: Optional[KVPool] = None     # block-paged KV pool (None = unpaged)
    stalls: Optional[torch.Tensor] = None  # i32 — cumulative parked rounds
    chunks: Optional[torch.Tensor] = None  # i32 — cumulative prefill chunks
    ring: Optional[TelemetryRing] = None   # in-round telemetry (None = off)


class RoundOut(NamedTuple):
    """Per-round outputs drained by the host once per megastep."""

    tokens: torch.Tensor    # (S,) i32 — token emitted by each slot
    emit: torch.Tensor      # (S,) bool — slot decoded this round
    fin: torch.Tensor       # (S,) bool — slot completed this round
    pre: torch.Tensor       # (S,) bool — slot deadline-preempted
    row: torch.Tensor       # (S,) i32 — backlog row at emit time
    prerow: torch.Tensor    # (S,) i32 — backlog row at preemption time
    n_live: torch.Tensor    # i32 — backlog rows examined by admission
    n_active: torch.Tensor  # i32 — busy slots at decode time


# TokenFn: (model, EngineState) -> (next_tokens (S,) i32, model')
TokenFn = Callable
# AdmitFn: (model, EngineState, rows (S,), mask (S,), slots (S,)) -> model'
AdmitFn = Optional[Callable]


def make_engine_state(qos: QoSState, n_slots: int, backlog_cap: int,
                      prompt_cap: int, *, free_units=0,
                      slot_table: int = SLOT_TABLE, kv_blocks: int = 0,
                      kv_slot_blocks: int = 0, ring_cap: int = 0,
                      device=None) -> EngineState:
    """Fresh state (empty backlog, idle slots) on ``device`` (default: the
    QoS state's).  ``kv_blocks`` > 0 attaches a block-paged pool (power of
    two) with ``kv_slot_blocks``-entry tables; ``ring_cap`` > 0 (power of
    two ≥ the megastep length) attaches the telemetry ring.  Prefix
    sharing's cache (ROADMAP queue 1, item 2) is not ported yet."""
    assert backlog_cap >= n_slots, "backlog capacity must cover the slots"
    dev = qos.ticket.device if device is None else device
    S, B, P = n_slots, backlog_cap, prompt_cap

    def full(n, fill, dtype=torch.int32):
        return torch.full((n,), fill, dtype=dtype, device=dev)

    kv = None
    if kv_blocks:
        assert kv_slot_blocks > 0, "paged pool needs a per-slot table size"
        kv = KVPool(pool=make_block_pool(kv_blocks, table_size=slot_table,
                                         device=dev),
                    tbl=torch.full((S, kv_slot_blocks), -1,
                                   dtype=torch.int32, device=dev))
    ring = None
    if ring_cap:
        # event table: 8 phase segments of S lanes each (events.SCAN_SEGMENTS)
        ring = make_telemetry_ring(ring_cap, qos.ticket.shape[0],
                                   hist=slot_table, ev_cap=8 * n_slots,
                                   device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return EngineState(
        qos=qos, slot_sema=make_sema(count=n_slots, table_size=slot_table,
                                     device=dev),
        free=torch.full((), free_units, dtype=torch.int32, device=dev),
        round_no=zero, stalls=zero, chunks=zero, kv=kv, ring=ring,
        backlog=Backlog(
            valid=full(B, False, torch.bool), tenant=full(B, 0),
            ticket=full(B, 0, torch.int64),
            deadline=full(B, torch.inf, torch.float32), rid=full(B, -1),
            max_new=full(B, 0),
            prompt=torch.zeros((B, P), dtype=torch.int32, device=dev),
            prompt_len=full(B, 0), admit_round=full(B, -1),
            expire_round=full(B, -1), slot=full(B, -1)),
        slots=Slots(
            busy=full(S, False, torch.bool), row=full(S, -1),
            rid=full(S, -1), tenant=full(S, 0),
            deadline=full(S, torch.inf, torch.float32), max_new=full(S, 0),
            emitted=full(S, 0), token=full(S, 0), pos=full(S, 0),
            plen=full(S, 0),
            prompt=torch.zeros((S, P), dtype=torch.int32, device=dev),
            prio_r=full(S, 0), prio_k=full(S, 0),
            parked=full(S, False, torch.bool), park_bucket=full(S, 0),
            park_seq=full(S, 0, torch.int64), chunk=full(S, 0),
            last_adv=full(S, 0)))


def _fcfs_key(backlog: Backlog, grant: torch.Tensor, mask: torch.Tensor):
    """Packed global admission-order key (wrap-safe signed ticket distance
    from the post-round grant frontier, tenant-index tiebreak); rows
    outside ``mask`` get INT32_MAX."""
    d = _sdist(backlog.ticket, grant[backlog.tenant.to(torch.int64)])
    key = (torch.clamp(d, -_D_CLAMP, _D_CLAMP) << _T_BITS) + backlog.tenant
    return torch.where(mask, key, INT32_MAX)


def _block_demand(backlog: Backlog, block_size: int) -> torch.Tensor:
    """Worst-case block demand per backlog row (truncated prompt +
    max_new), acquired in full at admission in up-front mode."""
    return total_block_demand(backlog.prompt_len, backlog.max_new,
                              block_size)


def _assign_slots(state: EngineState, admitted: torch.Tensor):
    """Map admitted backlog rows to free slots: rows in wrap-safe FCFS
    admission order take ascending free slot indices, gated through the
    free-slot TWA semaphore.  Returns ``(state', rows, assign, tgt)`` —
    lane j serves backlog row ``rows[j]`` in slot ``tgt[j]`` where
    ``assign[j]`` (``tgt`` = S elsewhere)."""
    sl, bl = state.slots, state.backlog
    S = sl.busy.shape[0]
    B = bl.valid.shape[0]
    dev = sl.busy.device

    key = _fcfs_key(bl, state.qos.grant, admitted)
    order = torch.argsort(key, stable=True)       # admitted rows first, FCFS
    n_adm = admitted.to(torch.int32).sum(dtype=torch.int32)
    j = torch.arange(S, dtype=torch.int32, device=dev)
    rows = order[:S]
    assign = j < n_adm
    free_order = torch.argsort(sl.busy.to(torch.int32), stable=True)
    tgt = torch.where(assign, free_order[:S], S)

    # inverse map slot → lane (one spare entry absorbs the S sentinel)
    inv = torch.full((S + 1,), -1, dtype=torch.int64, device=dev).scatter_(
        0, tgt, torch.arange(S, device=dev))[:S]
    has = inv >= 0
    lane = inv.clamp(min=0)

    def put(old, new_by_lane):
        new = new_by_lane[lane] if isinstance(new_by_lane, torch.Tensor) \
            and new_by_lane.dim() else new_by_lane
        return torch.where(has.view(-1, *([1] * (old.dim() - 1))), new, old)

    slot_sema, _, _, _ = take_batch(state.slot_sema, assign)
    plen = bl.prompt_len[rows]
    seed_tok = bl.prompt[rows, torch.clamp(plen - 1, min=0)]
    slots = Slots(
        busy=put(sl.busy, True), row=put(sl.row, rows.to(torch.int32)),
        rid=put(sl.rid, bl.rid[rows]), tenant=put(sl.tenant, bl.tenant[rows]),
        deadline=put(sl.deadline, bl.deadline[rows]),
        max_new=put(sl.max_new, bl.max_new[rows]),
        emitted=put(sl.emitted, 0), token=put(sl.token, seed_tok),
        pos=put(sl.pos, plen), plen=put(sl.plen, plen),
        prompt=put(sl.prompt, bl.prompt[rows]),
        prio_r=put(sl.prio_r, state.round_no),
        prio_k=put(sl.prio_k, key[rows]), parked=put(sl.parked, False),
        park_bucket=put(sl.park_bucket, 0), park_seq=put(sl.park_seq, 0),
        chunk=put(sl.chunk, 0), last_adv=put(sl.last_adv, state.round_no))
    bslot = scatter_set(bl.slot, torch.where(assign, rows, B),
                        tgt.to(torch.int32))
    return (state._replace(slots=slots, slot_sema=slot_sema,
                           backlog=bl._replace(slot=bslot)),
            rows, assign, tgt)


def _release_rows(kv: KVPool, mask: torch.Tensor) -> KVPool:
    """Post the blocks of the masked slots back to the pool and clear
    their tables (identity on an empty mask)."""
    return KVPool(pool=pool_release(kv.pool, kv.tbl, mask),
                  tbl=torch.where(mask[:, None], -1, kv.tbl))


def _select(cond: torch.Tensor, a, b):
    """Field-wise ``torch.where`` over two NamedTuples of tensors."""
    return type(a)(*[torch.where(cond, x, y) for x, y in zip(a, b)])


def engine_round(state: EngineState, model, now, *, token_fn: TokenFn,
                 admit_fn: AdmitFn = None, admit_impl=None,
                 block_size: int = 0, chunk: int = 0, watchdog: int = 0):
    """One engine iteration — the pure-functional `step()` (apart from
    the in-place pool and ring writes noted in the module docstring).

    ``admit_impl`` overrides the admission-round implementation (signature
    of `functional_qos.qos_round`; the engine passes
    :func:`fused_round_impl` with ``use_kernel=True``).
    With ``state.kv`` set, ``block_size`` is the pool's block size.
    ``chunk > 0`` (continuous chunked prefill) is not ported yet and
    raises.  ``watchdog > 0`` arms the stuck-slot sentinel.  Returns ``(state',
    model', RoundOut)``."""
    paged = state.kv is not None
    assert not paged or block_size > 0, "paged pool needs block_size"
    if chunk > 0:
        raise NotImplementedError(
            "continuous chunked prefill is not ported yet (ROADMAP queue 1, "
            "item 1); this slice serves the unpaged and up-front paged modes")
    sl, bl = state.slots, state.backlog
    S = sl.busy.shape[0]
    dev = sl.busy.device

    # (1) deadline preemption: expired RUNNING sequences are tombstoned
    # and their slots (and blocks) posted back into THIS round's pool
    pre = sl.busy & (sl.deadline <= now)
    n_pre = pre.to(torch.int32).sum(dtype=torch.int32)
    prerow = torch.where(pre, sl.row, -1)
    pre_uid, pre_arg = sl.rid, sl.emitted   # captured before re-assignment
    sl = sl._replace(busy=sl.busy & ~pre, row=torch.where(pre, -1, sl.row),
                     parked=sl.parked & ~pre)
    state = state._replace(slots=sl,
                           slot_sema=post_batch(state.slot_sema, n_pre))
    if paged:
        state = state._replace(kv=_release_rows(state.kv, pre))

    # (2) the QoS admission round, preemption-freed units feeding the
    # replenish.  On an empty backlog the reference skips the round (an
    # unconditional round would still poke the dead-slack window): both
    # sides are computed and the round's result selected by any(alive).
    alive = bl.valid
    any_alive = alive.any()
    qos_r, adm_r, exp_r, left_r = qos_scan_round(
        state.qos, bl.tenant, bl.ticket, alive, bl.deadline, now,
        state.free, n_pre, max_units=S, round_impl=admit_impl)
    qos = _select(any_alive, qos_r, state.qos)
    admitted = adm_r & any_alive
    expired = exp_r & any_alive
    leftover = torch.where(any_alive, left_r, state.free + n_pre)

    # (2b) multi-resource gate: of the QoS-admitted rows only the FCFS
    # prefix whose cumulative block demand fits the free pool is granted;
    # block-stalled rows refund their tenant's slot credit and stay live
    n_stall = torch.zeros((), dtype=torch.int32, device=dev)
    if paged:
        demand = _block_demand(bl, block_size)
        granted = block_gate(admitted, demand,
                             _fcfs_key(bl, qos.grant, admitted),
                             pool_free_count(state.kv.pool))
        stalled = admitted & ~granted
        qos = qos._replace(consumed=u32.sub(qos.consumed, segment_counts(
            bl.tenant, stalled, qos.ticket.shape[0])))
        n_stall = stalled.to(torch.int32).sum(dtype=torch.int32)
        admitted = granted
    rno = state.round_no
    bl = bl._replace(valid=alive & ~admitted & ~expired,
                     admit_round=torch.where(admitted, rno, bl.admit_round),
                     expire_round=torch.where(expired, rno,
                                              bl.expire_round))
    state = state._replace(qos=qos, backlog=bl)

    # (3) slot assignment (FCFS → ascending free slots), then the
    # wrap-safe take of each granted slot's whole-lifetime block demand
    state, rows, assign, tgt = _assign_slots(state, admitted)
    if paged:
        kv = state.kv
        counts = scatter_set(torch.zeros(S, dtype=torch.int32, device=dev),
                             tgt, torch.where(assign, demand[rows], 0))
        pool, ids = pool_alloc(kv.pool, counts, kv.tbl.shape[1])
        state = state._replace(kv=KVPool(
            pool=pool, tbl=torch.where(counts[:, None] > 0, ids, kv.tbl)))
    if admit_fn is not None:  # prefill hook for newly admitted slots
        model = admit_fn(model, state, rows, assign, tgt)

    # (4) decode + sample every busy slot (this round's admits included)
    sl = state.slots
    emit = sl.busy
    toks, model = token_fn(model, state)
    toks = torch.where(emit, toks.to(torch.int32), sl.token)
    adv = emit.to(torch.int32)
    sl = sl._replace(token=toks, emitted=sl.emitted + adv, pos=sl.pos + adv,
                     last_adv=torch.where(adv > 0, rno, sl.last_adv))

    # (5) completion: done slots post back; their units bank for the NEXT
    # round, and their blocks return to the pool after decode
    n_busy = sl.busy.to(torch.int32).sum(dtype=torch.int32)
    fin = sl.busy & (sl.emitted >= sl.max_new)
    n_fin = fin.to(torch.int32).sum(dtype=torch.int32)
    finrow = sl.row
    sl = sl._replace(busy=sl.busy & ~fin, row=torch.where(fin, -1, sl.row))
    state = state._replace(
        slots=sl, slot_sema=post_batch(state.slot_sema, n_fin),
        free=leftover + n_fin, round_no=rno + 1)
    if paged:
        state = state._replace(kv=_release_rows(state.kv, fin))

    # (6) telemetry: append this round's probe set to the ring
    if state.ring is not None:
        parked_mask = sl.busy & sl.parked
        E = state.ring.buf.ev_kind.shape[1]
        if E:
            assert E == 8 * S, "event table must be 8 segments of S lanes"
            lane = torch.arange(S, dtype=torch.int32, device=dev)
            zb = torch.zeros(S, dtype=torch.bool, device=dev)
            zi = torch.zeros(S, dtype=torch.int32, device=dev)
            # the 8 phase-major segments (events.SCAN_SEGMENTS); the
            # chunked-prefill and sharing segments are empty in this slice
            segs = (
                (events.EV_PREEMPT, pre, pre_uid, lane, pre_arg),
                (events.EV_ADMIT, assign, bl.rid[rows], tgt,
                 bl.prompt_len[rows]),
                (events.EV_PREFIX_ATTACH, zb, zi, zi, zi),
                (events.EV_PARK, zb, zi, zi, zi),
                (events.EV_RESUME, zb, zi, zi, zi),
                (events.EV_PREFILL_CHUNK, zb, zi, zi, zi),
                (events.EV_COW, zb, zi, zi, zi),
                (events.EV_FINISH, fin, sl.rid, lane, sl.emitted),
            )
            evm = torch.cat([m for _, m, _, _, _ in segs])
            kinds = torch.cat([torch.full((S,), k, dtype=torch.int32,
                                          device=dev) for k, *_ in segs])
            uids, eslots, eargs = (
                torch.cat([seg[c].to(torch.int32) for seg in segs])
                for c in (2, 3, 4))
            order = torch.argsort((~evm).to(torch.int32), stable=True)
            ev_n = evm.to(torch.int32).sum(dtype=torch.int32)
            keep = torch.arange(E, dtype=torch.int32, device=dev) < ev_n
            ev = (torch.where(keep, kinds[order], 0),
                  torch.where(keep, uids[order], -1),
                  torch.where(keep, eslots[order], -1),
                  torch.where(keep, eargs[order], 0))
        else:
            ze = torch.zeros(0, dtype=torch.int32, device=dev)
            ev_n, ev = torch.zeros((), dtype=torch.int32, device=dev), \
                (ze, ze, ze, ze)

        def cnt(m):
            return m.to(torch.int32).sum(dtype=torch.int32)

        zero = torch.zeros((), dtype=torch.int32, device=dev)
        sample = TelemetrySample(
            round_no=rno, now=now, admits=cnt(admitted), expires=cnt(expired),
            preempts=n_pre, tokens=cnt(emit), prefill_tokens=zero,
            prefill_chunks=zero,
            prefill_pending=pending_prompt_tokens(sl.pos, sl.plen, sl.busy),
            gate_stalls=n_stall, parked=cnt(parked_mask),
            backlog=cnt(state.backlog.valid), active=cnt(sl.busy),
            slot_free=_sdist(state.slot_sema.grant, state.slot_sema.ticket),
            kv_free=(pool_free_count(state.kv.pool) if paged else zero),
            kv_pokes=(state.kv.pool.sema.bucket_seq.sum() & u32.MASK32
                      if paged else zero),
            prefix_hits=zero, blocks_shared=zero, cow_copies=zero,
            health=round_health(state, model, rno, block_size=block_size,
                                watchdog=watchdog),
            credit=_sdist(state.qos.grant, state.qos.consumed),
            poke_dead=state.qos.dead,
            kv_wait_hist=bucket_histogram(
                sl.park_bucket, parked_mask,
                state.ring.buf.kv_wait_hist.shape[1]),
            ev_n=ev_n, ev_kind=ev[0], ev_uid=ev[1], ev_slot=ev[2],
            ev_arg=ev[3])
        state = state._replace(ring=ring_append(state.ring, sample))
    ys = RoundOut(tokens=toks, emit=emit, fin=fin, pre=pre, row=finrow,
                  prerow=prerow, n_live=alive.to(torch.int32).sum(
                      dtype=torch.int32), n_active=n_busy)
    return state, model, ys


@contextlib.contextmanager
def no_host_sync(device: torch.device):
    """On CUDA, make any host sync raise (``set_sync_debug_mode("error")``)
    for the duration; a no-op elsewhere."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def megastep_scan(state: EngineState, model, nows, *, token_fn: TokenFn,
                  admit_fn: AdmitFn = None, admit_impl=None,
                  block_size: int = 0, chunk: int = 0, watchdog: int = 0):
    """K engine rounds.  ``nows``: (K,) f32 epoch-relative timestamps on
    the state's device.  No round synchronizes with the host (on CUDA a
    sync raises).  Returns ``(state', model', RoundOut of (K, S)
    tensors)``."""
    ys = []
    with no_host_sync(nows.device):
        for k in range(nows.shape[0]):
            state, model, y = engine_round(
                state, model, nows[k], token_fn=token_fn, admit_fn=admit_fn,
                admit_impl=admit_impl, block_size=block_size, chunk=chunk,
                watchdog=watchdog)
            ys.append(y)
        out = RoundOut(*[torch.stack(f) for f in zip(*ys)])
    return state, model, out


def fused_round_impl(state, tenant_ids, tickets, alive, deadlines, now,
                     free_units, max_units):
    """Admission-round implementation through the fused kernel's dispatch
    (`kernels.ops.qos_round`: the CUDA kernel on the card, its plain
    version on the CPU) — bit-identical to the functional default."""
    from ..kernels import ops

    return ops.qos_round(state, tenant_ids, tickets, alive, deadlines, now,
                         free_units, max_units=max_units)


# ------------------------------------------------------------ host drain ----


def _leaves(tree, out: list):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _leaves(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _leaves(x, out)
    return out


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(x, it) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, it) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return tree


def drain(tree):
    """Copy every tensor of ``tree`` (nested NamedTuples, tuples, lists,
    dicts) to the host in ONE device→host transfer: the leaves are packed
    into one int64 buffer (floats by their bits), copied once, and
    unpacked into numpy arrays of their own dtypes.  Returns the same
    structure with numpy leaves."""
    leaves = _leaves(tree, [])
    if not leaves:
        return tree
    packed = []
    for x in leaves:
        if x.dtype == torch.float32:
            x = x.contiguous().view(torch.int32)
        packed.append(x.reshape(-1).to(torch.int64))
    host = torch.cat(packed).cpu().numpy()
    arrays, off = [], 0
    for x in leaves:
        n = x.numel()
        a = host[off:off + n].reshape(tuple(x.shape))
        off += n
        if x.dtype == torch.float32:
            a = a.astype(np.int32).view(np.float32)
        elif x.dtype == torch.bool:
            a = a.astype(bool)
        elif x.dtype == torch.int32:
            a = a.astype(np.int32)
        arrays.append(a)
    return _rebuild(tree, iter(arrays))


# --------------------------------------------------------------- models ----


def rid_token_fn(model, state: EngineState):
    """Deterministic request-identity token stream: token = rid·1000 +
    #already-emitted (slot-assignment invariant)."""
    return state.slots.rid * 1000 + state.slots.emitted, model


def zero_token_fn(model, state: EngineState):
    """The serving-bench toy model (zero sample)."""
    return torch.zeros_like(state.slots.token), model


def make_paged_pool_model(generator: torch.Generator, vocab: int, d: int,
                          num_blocks: int, block_size: int, device=None):
    """Single-layer attention LM over the shared block-paged KV pool:
    ``emb`` (vocab, d), ``wo`` (d, d) ~ N(0, 0.05²) from ``generator`` (on
    ``device``), and zeroed pools ``kp``/``vp`` (NB, BS, 1, d)."""
    emb = torch.randn((vocab, d), generator=generator, device=device) * 0.05
    wo = torch.randn((d, d), generator=generator, device=device) * 0.05
    pool = dict(dtype=torch.float32, device=device)
    return {"emb": emb, "wo": wo,
            "kp": torch.zeros((num_blocks, block_size, 1, d), **pool),
            "vp": torch.zeros((num_blocks, block_size, 1, d), **pool)}


def _pool_rows(model, bid, off):
    """Row index of (block, offset, head 0) in the pools viewed as
    (NB·BS·KV, d)."""
    _, BS, KV, _ = model["kp"].shape
    return (bid.to(torch.int64) * BS + off) * KV


def paged_pool_admit_fn(model, state: EngineState, rows, mask, slots):
    """Prefill into the pool: the admitted rows' prompt embeddings land in
    the blocks their slots were just granted (token j of a slot in block
    ``tbl[slot, j // BS]`` offset ``j % BS``) — one masked scatter per
    round for all admitted slots, IN PLACE on ``kp``/``vp``."""
    bl = state.backlog
    tbl = state.kv.tbl
    NB, BS, KV, d = model["kp"].shape
    MB = tbl.shape[1]
    P = bl.prompt.shape[1]
    dev = tbl.device
    ptoks = bl.prompt[rows]                                  # (S, P)
    plens = bl.prompt_len[rows]
    pe = model["emb"][ptoks]                                 # (S, P, d)
    j = torch.arange(P, device=dev)
    col = j // BS
    stbl = tbl[torch.where(mask, slots, 0)]                  # (S, MB)
    bid = stbl[:, col.clamp(max=MB - 1)]                     # (S, P)
    valid = (mask[:, None] & (j[None, :] < plens[:, None])
             & (col < MB)[None, :] & (bid >= 0))
    r = _pool_rows(model, bid, (j % BS)[None, :])
    put_rows_(model["kp"].view(-1, d), r, pe, valid)
    put_rows_(model["vp"].view(-1, d), r, pe, valid)
    return model


def paged_pool_token_fn(model, state: EngineState):
    """Pool-paged single-token decode: write the current token's K/V into
    the slot's cursor block (IN PLACE), attend over the slot's blocks with
    the paged-decode kernel (`kernels.ops.paged_decode`; its plain version
    on the CPU), and greedy-sample."""
    from ..kernels import ops

    sl = state.slots
    kv = state.kv
    NB, BS, KV, d = model["kp"].shape
    S, MB = kv.tbl.shape
    cur = model["emb"][sl.token]                             # (S, d)
    rows_i = torch.arange(S, device=cur.device)
    bid = kv.tbl[rows_i, torch.clamp(sl.pos // BS, 0, MB - 1)]
    wr = sl.busy & (bid >= 0)
    r = _pool_rows(model, bid, sl.pos % BS)
    put_rows_(model["kp"].view(-1, d), r, cur, wr)
    put_rows_(model["vp"].view(-1, d), r, cur, wr)
    lens = torch.where(sl.busy, sl.pos + 1, 0)               # incl. current
    o = ops.paged_decode(cur[:, None, :], model["kp"], model["vp"], kv.tbl,
                         lens)                               # (S, 1, d)
    logits = (o[:, 0] @ model["wo"]) @ model["emb"].T
    return torch.argmax(logits, dim=-1).to(torch.int32), model
