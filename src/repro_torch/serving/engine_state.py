"""Device-resident decode megastep on tensors — the port of
``repro.serving.engine_state``: the unpaged mode, the up-front paged mode,
continuous chunked prefill and refcounted prefix sharing.

One :func:`engine_round` is the pure-functional engine iteration:

  preempt expired running slots  →  QoS admission round (freed units feed
  the same round's replenish)  →  block gate (paged)  →  assign free slots
  to admitted rows in wrap-safe FCFS order  →  attach cache-covered
  prefixes (sharing)  →  chunk plan: incremental block takes, parks,
  copy-on-write (chunked)  →  prefill chunks + decode + sample  →  publish
  completed prefixes (sharing)  →  retire completed slots  →  append the
  round's telemetry sample.

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

With ``chunk > 0`` (continuous chunked prefill) admission gates on
first-chunk demand behind the Banker headroom and the commitment
watermark; each round plans chunks under the token budget
(`serving.prefill.chunk_plan`), takes blocks at boundary crossings and
parks block-stalled slots on the block semaphore's waiting array
(`core.functional.pool_try_alloc`).  The chunk K/V goes into the pool
through the paged-prefill kernel (`kernels.ops.paged_prefill`).  With the
prefix cache attached (``KVPool.cache``), admissions attach the
cache-covered prefix by `pool_incref`, pay only for post-divergence
demand, and a decode-ready slot whose next write lands in a shared block
takes a private copy first (copy-on-write).
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
    block_headroom,
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
    pool_incref,
    pool_release,
    pool_try_alloc,
    post_batch,
    put_rows_,
    scatter_set,
    segment_counts,
    take_batch,
)
from ..device import resolve_device
from . import events
from .prefill import (
    banker_order,
    cdiv,
    chunk_plan,
    first_chunk_demand,
    pending_prompt_tokens,
    shared_first_chunk_demand,
    total_block_demand,
)
from .prefix import (
    PrefixCache,
    cache_lookup,
    cache_register,
    make_prefix_cache,
)
from .sentinels import round_health

# admission-order sort key packs (clamped ticket distance, tenant index)
# into one int32: distances beyond ±2²⁰ cannot occur for admitted rows;
# the tenant index has 8 bits, so past 256 tenants it spills into the
# distance's bits, and rows order as the reference's key orders them.
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
    ph: Optional[torch.Tensor] = None  # (B, 2, W+1) u32 — prompt hashes
    #                                    (sharing; computed at submit)


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
    ph: Optional[torch.Tensor] = None       # (S, 2, W+1) u32 — prompt hashes
    cow_src: Optional[torch.Tensor] = None  # (S,) i32 — copy-on-write source
    #                                         block staged this round (-1)


class KVPool(NamedTuple):
    """Block-paged KV state: the TWA block semaphore over the circular
    free queue plus the per-slot block tables.  With ``cache`` attached a
    block may sit in several tables (a shared prefix): attaching is a
    `pool_incref` (no counter moves), and a release posts only when the
    last reference leaves.  The cache holds no references (weak,
    gen-stamped entries)."""

    pool: BlockPool
    tbl: torch.Tensor        # (S, MB) i32 — per-slot block ids, -1 = none
    cache: Optional[PrefixCache] = None  # weak prefix index (None = off)


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
                      prefix_entries: int = 0, hash_width: int = 0,
                      device=None) -> EngineState:
    """Fresh state (empty backlog, idle slots) on ``device`` (default: the
    QoS state's).  ``kv_blocks`` > 0 attaches a block-paged pool (power of
    two) with ``kv_slot_blocks``-entry tables; ``ring_cap`` > 0 (power of
    two ≥ the megastep length) attaches the telemetry ring;
    ``prefix_entries`` > 0 (power of two; needs the pool) attaches the
    weak prefix cache and the prompt-hash / copy-on-write slot state, with
    ``hash_width`` W = ``prompt_cap // block_size`` hash columns."""
    assert backlog_cap >= n_slots, "backlog capacity must cover the slots"
    assert prefix_entries == 0 or kv_blocks > 0, \
        "prefix sharing needs the block-paged pool"
    dev = qos.ticket.device if device is None else device
    S, B, P = n_slots, backlog_cap, prompt_cap
    W = hash_width

    def full(n, fill, dtype=torch.int32):
        return torch.full((n,), fill, dtype=dtype, device=dev)

    kv = None
    if kv_blocks:
        assert kv_slot_blocks > 0, "paged pool needs a per-slot table size"
        kv = KVPool(pool=make_block_pool(kv_blocks, table_size=slot_table,
                                         device=dev),
                    tbl=torch.full((S, kv_slot_blocks), -1,
                                   dtype=torch.int32, device=dev),
                    cache=(make_prefix_cache(prefix_entries, device=dev)
                           if prefix_entries else None))
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
            expire_round=full(B, -1), slot=full(B, -1),
            ph=(torch.zeros((B, 2, W + 1), dtype=torch.int64, device=dev)
                if prefix_entries else None)),
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
            last_adv=full(S, 0),
            ph=(torch.zeros((S, 2, W + 1), dtype=torch.int64, device=dev)
                if prefix_entries else None),
            cow_src=full(S, -1) if prefix_entries else None))


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


def _slot_rem(sl: Slots, held: torch.Tensor, block_size: int):
    """Worst-case remaining block demand per slot (the Banker ``rem``):
    lifetime demand minus the blocks held; 0 for idle slots."""
    total = total_block_demand(sl.plen, sl.max_new, block_size)
    return torch.where(sl.busy, total - held, 0).to(torch.int32)


def _held(tbl: torch.Tensor) -> torch.Tensor:
    """Blocks in each slot's table, (S,) i32."""
    return (tbl >= 0).to(torch.int32).sum(1, dtype=torch.int32)


def _share_flags(tbl, refcnt, busy, pos, plen, held, block_size: int):
    """The two sharing inputs of `serving.prefill.chunk_plan`: ``cow`` — a
    decode-ready slot whose next write lands in its current tail block
    while that block is shared (``refcnt > 1``); ``held_free`` — how many
    of its blocks the slot alone references (the Banker cover).  Returns
    ``(cow (S,) bool, held_free (S,) i32)``."""
    S, MB = tbl.shape
    NB = refcnt.shape[0]
    rows_i = torch.arange(S, device=tbl.device)
    cur = tbl[rows_i, torch.clamp(held - 1, 0, MB - 1).to(torch.int64)]
    cow = (busy & (pos >= plen) & (pos < held * block_size) & (cur >= 0)
           & (refcnt[torch.clamp(cur, 0, NB - 1).to(torch.int64)] > 1))
    priv = (tbl >= 0) & (refcnt[torch.clamp(tbl, 0, NB - 1).to(torch.int64)]
                         == 1)
    return cow, priv.to(torch.int32).sum(1, dtype=torch.int32)


def _set_cells(dst: torch.Tensor, rows, cols, vals, mask) -> torch.Tensor:
    """Out-of-place ``dst.at[rows, cols].set(vals, mode="drop")`` on a 2-D
    table for the ``mask``ed cells (broadcast together); cells outside the
    table are dropped.  Valid cells must be unique."""
    S, MB = dst.shape
    rows, cols, vals, mask = torch.broadcast_tensors(
        rows.to(torch.int64), cols.to(torch.int64), vals, mask)
    ok = mask & (rows >= 0) & (rows < S) & (cols >= 0) & (cols < MB)
    flat = torch.where(ok, rows * MB + cols, S * MB).reshape(-1)
    buf = torch.cat([dst.reshape(-1), dst.new_zeros(1)])
    buf = buf.scatter(0, flat, vals.reshape(-1).to(dst.dtype))
    return buf[:S * MB].view(S, MB)


def _chunk_phase(state: EngineState, chunk: int, budget: int,
                 block_size: int):
    """The chunked-prefill slice of a round: plan this round's chunks,
    takes and parks (`serving.prefill.chunk_plan` over the Banker order),
    take the granted blocks (`core.functional.pool_try_alloc` — newly
    parked slots observe their waiting-array bucket instead), put the ids
    into the tables and stage the chunk lengths for ``token_fn``.  With
    the prefix cache a granted copy-on-write block replaces the slot's
    shared tail in its table, the replaced ids drop one reference in ONE
    batched `pool_release`, and ``slots.cow_src`` stages the source block
    for ``token_fn``'s copy.  Returns ``(state', emit, n_cow, ev)`` — the
    decode mask, the round's copy-on-write count and the event masks and
    arguments of the PARK / RESUME / PREFILL_CHUNK / COW segments."""
    sl, kv = state.slots, state.kv
    prev_parked = sl.parked
    sharing = kv.cache is not None
    S, MB = kv.tbl.shape
    dev = kv.tbl.device
    held = _held(kv.tbl)
    # TWA wake gate: parked slots re-attempt only when a release poked
    # their observed bucket
    woken = (kv.pool.sema.bucket_seq[sl.park_bucket.to(torch.int64)]
             != sl.park_seq)
    if sharing:
        cow, held_free = _share_flags(kv.tbl, kv.pool.refcnt, sl.busy,
                                      sl.pos, sl.plen, held, block_size)
    else:
        cow, held_free = torch.zeros_like(sl.busy), held
    rem = _slot_rem(sl, held, block_size) + cow.to(torch.int32)
    order = banker_order(rem, sl.prio_r, sl.prio_k, sl.busy)
    plan = chunk_plan(order, sl.busy, sl.parked, woken, sl.pos, sl.plen,
                      sl.max_new, held, pool_free_count(kv.pool), cow,
                      held_free, chunk=chunk, budget=budget,
                      block_size=block_size)
    newly = plan.parked & (plan.deficit > 0)
    max_take = cdiv(chunk, block_size) + 1  # a chunk can straddle a block
    pool, ids, bkt, seq = pool_try_alloc(kv.pool, plan.take, max_take,
                                         park=newly, deficit=plan.deficit)
    k = torch.arange(max_take, dtype=torch.int32, device=dev)
    valid = k[None, :] < plan.take[:, None]
    # a COW grant replaces the shared tail (column held-1) instead of
    # extending the table; the replaced id is read before the write
    base = torch.where(plan.cow, held - 1, held) if sharing else held
    old = kv.tbl[torch.arange(S, device=dev),
                 torch.clamp(held - 1, 0, MB - 1).to(torch.int64)]
    tbl = _set_cells(kv.tbl, torch.arange(S, device=dev)[:, None],
                     base[:, None] + k[None, :], ids, valid)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    n_cow = zero
    if sharing:
        # ONE batched decref of every replaced shared block (an identity
        # on an empty mask, which most rounds are)
        pool = pool_release(pool, old, plan.cow)
        n_cow = plan.cow.to(torch.int32).sum(dtype=torch.int32)
    sl = sl._replace(
        chunk=plan.tokens, parked=plan.parked,
        park_bucket=torch.where(newly, bkt, sl.park_bucket),
        park_seq=torch.where(newly, seq, sl.park_seq),
        cow_src=(torch.where(plan.cow, old, -1) if sharing else sl.cow_src))
    state = state._replace(
        kv=KVPool(pool=pool, tbl=tbl, cache=kv.cache), slots=sl,
        stalls=state.stalls + plan.parked.to(torch.int32).sum(
            dtype=torch.int32),
        chunks=state.chunks + (plan.tokens > 0).to(torch.int32).sum(
            dtype=torch.int32))
    ev = {"park": plan.parked & ~prev_parked, "park_arg": plan.deficit,
          "resume": prev_parked & ~plan.parked, "chunk_tok": plan.tokens,
          "cow": plan.cow if sharing else torch.zeros_like(plan.parked),
          "cow_old": old}
    return state, plan.emit, n_cow, ev


def _assign_slots(state: EngineState, admitted: torch.Tensor,
                  chunked: bool = False, cov=None):
    """Map admitted backlog rows to free slots: rows in wrap-safe FCFS
    admission order take ascending free slot indices, gated through the
    free-slot TWA semaphore.  Every slot records its Banker priority
    (admission round, FCFS key).  ``chunked`` starts the KV cursor at 0
    (the prompt is prefilled chunk by chunk) instead of at ``prompt_len``;
    with sharing, ``cov`` (B,) starts it at the cache-covered length.
    Returns ``(state', rows, assign, tgt)`` — lane j serves backlog row
    ``rows[j]`` in slot ``tgt[j]`` where ``assign[j]`` (``tgt`` = S
    elsewhere)."""
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
    if cov is not None:  # sharing: resume past the cache-covered prefix
        pos0 = cov[rows]
    else:
        pos0 = torch.zeros_like(plen) if chunked else plen
    slots = Slots(
        busy=put(sl.busy, True), row=put(sl.row, rows.to(torch.int32)),
        rid=put(sl.rid, bl.rid[rows]), tenant=put(sl.tenant, bl.tenant[rows]),
        deadline=put(sl.deadline, bl.deadline[rows]),
        max_new=put(sl.max_new, bl.max_new[rows]),
        emitted=put(sl.emitted, 0), token=put(sl.token, seed_tok),
        pos=put(sl.pos, pos0), plen=put(sl.plen, plen),
        prompt=put(sl.prompt, bl.prompt[rows]),
        prio_r=put(sl.prio_r, state.round_no),
        prio_k=put(sl.prio_k, key[rows]), parked=put(sl.parked, False),
        park_bucket=put(sl.park_bucket, 0), park_seq=put(sl.park_seq, 0),
        chunk=put(sl.chunk, 0), last_adv=put(sl.last_adv, state.round_no),
        ph=(put(sl.ph, bl.ph[rows]) if sl.ph is not None else None),
        cow_src=(put(sl.cow_src, -1) if sl.cow_src is not None else None))
    bslot = scatter_set(bl.slot, torch.where(assign, rows, B),
                        tgt.to(torch.int32))
    return (state._replace(slots=slots, slot_sema=slot_sema,
                           backlog=bl._replace(slot=bslot)),
            rows, assign, tgt)


def _release_rows(kv: KVPool, mask: torch.Tensor) -> KVPool:
    """Post the blocks of the masked slots back to the pool (a decref of
    each; a block frees when its last reference leaves) and clear their
    tables (identity on an empty mask)."""
    return kv._replace(pool=pool_release(kv.pool, kv.tbl, mask),
                       tbl=torch.where(mask[:, None], -1, kv.tbl))


def _select(cond: torch.Tensor, a, b):
    """Field-wise ``torch.where`` over two NamedTuples of tensors."""
    return type(a)(*[torch.where(cond, x, y) for x, y in zip(a, b)])


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.int32).sum(dtype=torch.int32)


def engine_round(state: EngineState, model, now, *, token_fn: TokenFn,
                 admit_fn: AdmitFn = None, admit_impl=None,
                 block_size: int = 0, chunk: int = 0, budget: int = 0,
                 commit: int = 0, watchdog: int = 0):
    """One engine iteration — the pure-functional `step()` (apart from
    the in-place pool and ring writes noted in the module docstring).

    ``admit_impl`` overrides the admission-round implementation (signature
    of `functional_qos.qos_round`; the engine passes
    :func:`fused_round_impl` with ``use_kernel=True``).
    With ``state.kv`` set, ``block_size`` is the pool's block size.
    ``chunk > 0`` selects continuous chunked prefill (needs the pool and
    ``budget > 0``): admission gates on first-chunk demand behind the
    reserved headroom and the ``commit``-block watermark, and ``token_fn``
    must handle the prefill phase (:func:`chunked_prefill_token_fn`).  The
    prefix cache (``state.kv.cache``) needs chunked prefill.
    ``watchdog > 0`` arms the stuck-slot sentinel.  Returns ``(state',
    model', RoundOut)``."""
    paged = state.kv is not None
    assert not paged or block_size > 0, "paged pool needs block_size"
    chunked = chunk > 0
    assert not chunked or (paged and budget > 0), \
        "chunked prefill needs the block pool and a positive token budget"
    sharing = paged and state.kv.cache is not None
    assert not sharing or chunked, \
        "prefix sharing requires continuous chunked prefill"
    sl, bl = state.slots, state.backlog
    S = sl.busy.shape[0]
    dev = sl.busy.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    # (1) deadline preemption: expired RUNNING sequences are tombstoned
    # and their slots (and blocks) posted back into THIS round's pool
    pre = sl.busy & (sl.deadline <= now)
    n_pre = _count(pre)
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
    # block-stalled rows refund their tenant's slot credit and stay live.
    # Chunked prefill gates on first-chunk demand behind the reserved
    # headroom (the no-deadlock invariant) and the commitment watermark;
    # with sharing, on post-divergence demand (covered blocks attach).
    # The gate is an identity when nothing was admitted.
    n_stall = zero
    sh_c = sh_bids = sh_tail = sh_cov = None
    if paged:
        kv, sl = state.kv, state.slots
        headroom, commit_demand, commit_free, bootstrap = 0, None, 0, False
        eligible = admitted
        if chunked:
            held = _held(kv.tbl)
            if sharing:
                # read-only longest-prefix probe (weak entries)
                sh_c, sh_bids, sh_tail, sh_cov = cache_lookup(
                    kv.cache, kv.pool, bl.ph, bl.prompt_len, block_size)
                demand = shared_first_chunk_demand(bl.prompt_len, sh_cov,
                                                   chunk, block_size)
                commit_demand = _block_demand(bl, block_size) - sh_c
                # a row whose private demand exceeds the whole pool cannot
                # be granted at its current coverage: it must not dam the
                # FCFS prefix, and it stays live (stalled)
                eligible = admitted & ~(commit_demand > kv.pool.gen.shape[0])
                cow_a, held_cover = _share_flags(
                    kv.tbl, kv.pool.refcnt, sl.busy, sl.pos, sl.plen, held,
                    block_size)
                rem = _slot_rem(sl, held, block_size) + cow_a.to(torch.int32)
            else:
                demand = first_chunk_demand(bl.prompt_len, chunk, block_size)
                commit_demand = _block_demand(bl, block_size)
                rem = _slot_rem(sl, held, block_size)
                held_cover = held
            headroom = block_headroom(
                rem, held_cover,
                banker_order(rem, sl.prio_r, sl.prio_k, sl.busy), sl.busy)
            total_rem = rem.sum(dtype=torch.int32)
            commit_free = commit - total_rem
            bootstrap = total_rem == 0
        else:
            demand = _block_demand(bl, block_size)
        granted = block_gate(eligible, demand,
                             _fcfs_key(bl, qos.grant, eligible),
                             pool_free_count(kv.pool), headroom,
                             commit_demand, commit_free, bootstrap)
        stalled = admitted & ~granted
        qos = qos._replace(consumed=u32.sub(qos.consumed, segment_counts(
            bl.tenant, stalled, qos.ticket.shape[0])))
        n_stall = _count(stalled)
        admitted = granted
    rno = state.round_no
    bl = bl._replace(valid=alive & ~admitted & ~expired,
                     admit_round=torch.where(admitted, rno, bl.admit_round),
                     expire_round=torch.where(expired, rno,
                                              bl.expire_round))
    state = state._replace(qos=qos, backlog=bl)

    # (3) slot assignment (FCFS → ascending free slots)
    state, rows, assign, tgt = _assign_slots(
        state, admitted, chunked, cov=sh_cov if sharing else None)
    n_hits = zero
    if sharing:
        # (3a) attach the cache-covered prefix: seed the matched block ids
        # into the fresh slots' tables and incref each — no counter moves,
        # no pokes, no prefill for the covered tokens
        kv = state.kv
        MB = kv.tbl.shape[1]
        Wc = min(sh_bids.shape[1], MB)
        bids_r = sh_bids[rows][:, :Wc]             # (S, Wc) — -1 beyond c
        tail_r = sh_tail[rows]
        c_r = sh_c[rows]
        col_ok = assign[:, None] & (bids_r >= 0)
        tbl = _set_cells(kv.tbl, tgt[:, None],
                         torch.arange(Wc, device=dev)[None, :], bids_r,
                         col_ok)
        tail_ok = assign & (tail_r >= 0)
        tbl = _set_cells(tbl, tgt, torch.clamp(c_r, 0, MB - 1), tail_r,
                         tail_ok)
        pool = pool_incref(kv.pool, torch.cat([bids_r, tail_r[:, None]], 1),
                           torch.cat([col_ok, tail_ok[:, None]], 1))
        state = state._replace(kv=kv._replace(pool=pool, tbl=tbl))
        # a fully covered admit starts decode-ready: no prefill at all
        plen_r = bl.prompt_len[rows]
        n_hits = _count(assign & (sh_cov[rows] >= plen_r) & (plen_r > 0))
    if paged and not chunked:
        # wrap-safe semaphore take of each granted slot's whole-lifetime
        # block demand: ids pop off the queue at the ticket cursor in slot
        # order (an identity when nothing was assigned)
        kv = state.kv
        counts = scatter_set(torch.zeros(S, dtype=torch.int32, device=dev),
                             tgt, torch.where(assign, demand[rows], 0))
        pool, ids = pool_alloc(kv.pool, counts, kv.tbl.shape[1])
        state = state._replace(kv=kv._replace(
            pool=pool, tbl=torch.where(counts[:, None] > 0, ids, kv.tbl)))

    # (3b) chunked prefill: plan chunks and budget, take blocks
    # incrementally (this round's admits take their first chunk here),
    # park the stalled
    n_cow = zero
    chunk_ev = None
    if chunked:
        state, emit, n_cow, chunk_ev = _chunk_phase(state, chunk, budget,
                                                    block_size)
    if admit_fn is not None:  # prefill hook for newly admitted slots
        model = admit_fn(model, state, rows, assign, tgt)

    # (4) decode + sample every decode-ready slot (every busy slot in the
    # up-front modes; in chunked mode the chunk plan's emit mask)
    sl = state.slots
    if not chunked:
        emit = sl.busy
    toks, model = token_fn(model, state)
    toks = torch.where(emit, toks.to(torch.int32), sl.token)
    adv = emit.to(torch.int32) + (sl.chunk if chunked else 0)
    pos_old = sl.pos
    sl = sl._replace(token=toks, emitted=sl.emitted + emit.to(torch.int32),
                     pos=sl.pos + adv,
                     last_adv=torch.where(adv > 0, rno, sl.last_adv))
    if sharing:
        # (4b) publish prefixes at prefill completion: a slot whose
        # cursor crossed plen this round registers its full blocks and its
        # partial tail (identity on an empty mask)
        completed = sl.busy & (sl.pos >= sl.plen) & (pos_old < sl.plen)
        kv = state.kv
        state = state._replace(kv=kv._replace(cache=cache_register(
            kv.cache, kv.pool, sl.ph, sl.plen, kv.tbl, completed,
            block_size)))

    # (5) completion: done slots post back; their units bank for the NEXT
    # round, and their blocks return to the pool after decode
    n_busy = _count(sl.busy)
    fin = sl.busy & (sl.emitted >= sl.max_new)
    n_fin = _count(fin)
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
            admit_uid, admit_arg = bl.rid[rows], bl.prompt_len[rows]
            if sharing:
                att_mask, att_arg = assign & (sh_cov[rows] > 0), sh_cov[rows]
            else:
                att_mask, att_arg = zb, zi
            ck = chunk_ev if chunk_ev is not None else {
                "park": zb, "park_arg": zi, "resume": zb, "chunk_tok": zi,
                "cow": zb, "cow_old": zi}
            # the 8 phase-major segments (events.SCAN_SEGMENTS)
            segs = (
                (events.EV_PREEMPT, pre, pre_uid, lane, pre_arg),
                (events.EV_ADMIT, assign, admit_uid, tgt, admit_arg),
                (events.EV_PREFIX_ATTACH, att_mask, admit_uid, tgt, att_arg),
                (events.EV_PARK, ck["park"], sl.rid, lane, ck["park_arg"]),
                (events.EV_RESUME, ck["resume"], sl.rid, lane, zi),
                (events.EV_PREFILL_CHUNK, ck["chunk_tok"] > 0, sl.rid, lane,
                 ck["chunk_tok"]),
                (events.EV_COW, ck["cow"], sl.rid, lane, ck["cow_old"]),
                (events.EV_FINISH, fin, sl.rid, lane, sl.emitted),
            )
            evm = torch.cat([m for _, m, _, _, _ in segs])
            kinds = torch.cat([torch.full((S,), k, dtype=torch.int32,
                                          device=dev) for k, *_ in segs])
            uids, eslots, eargs = (
                torch.cat([seg[c].to(torch.int32) for seg in segs])
                for c in (2, 3, 4))
            order = torch.argsort((~evm).to(torch.int32), stable=True)
            ev_n = _count(evm)
            keep = torch.arange(E, dtype=torch.int32, device=dev) < ev_n
            ev = (torch.where(keep, kinds[order], 0),
                  torch.where(keep, uids[order], -1),
                  torch.where(keep, eslots[order], -1),
                  torch.where(keep, eargs[order], 0))
        else:
            ze = torch.zeros(0, dtype=torch.int32, device=dev)
            ev_n, ev = zero, (ze, ze, ze, ze)

        sample = TelemetrySample(
            round_no=rno, now=now, admits=_count(admitted),
            expires=_count(expired), preempts=n_pre, tokens=_count(emit),
            prefill_tokens=sl.chunk.sum(dtype=torch.int32),
            prefill_chunks=_count(sl.chunk > 0),
            prefill_pending=pending_prompt_tokens(sl.pos, sl.plen, sl.busy),
            gate_stalls=n_stall, parked=_count(parked_mask),
            backlog=_count(state.backlog.valid), active=_count(sl.busy),
            slot_free=_sdist(state.slot_sema.grant, state.slot_sema.ticket),
            kv_free=(pool_free_count(state.kv.pool) if paged else zero),
            kv_pokes=(state.kv.pool.sema.bucket_seq.sum() & u32.MASK32
                      if paged else zero),
            prefix_hits=n_hits,
            blocks_shared=(_count(state.kv.pool.refcnt >= 2) if sharing
                           else zero),
            cow_copies=n_cow,
            health=round_health(state, model, rno, block_size=block_size,
                                chunked=chunked, watchdog=watchdog),
            credit=_sdist(state.qos.grant, state.qos.consumed),
            poke_dead=state.qos.dead,
            kv_wait_hist=bucket_histogram(
                sl.park_bucket, parked_mask,
                state.ring.buf.kv_wait_hist.shape[1]),
            ev_n=ev_n, ev_kind=ev[0], ev_uid=ev[1], ev_slot=ev[2],
            ev_arg=ev[3])
        state = state._replace(ring=ring_append(state.ring, sample))
    ys = RoundOut(tokens=toks, emit=emit, fin=fin, pre=pre, row=finrow,
                  prerow=prerow, n_live=_count(alive), n_active=n_busy)
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
                  block_size: int = 0, chunk: int = 0, budget: int = 0,
                  commit: int = 0, watchdog: int = 0):
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
                budget=budget, commit=commit, watchdog=watchdog)
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


def make_paged_attn_model(generator: torch.Generator, vocab: int, d: int,
                          n_slots: int, capacity: int, device=None):
    """Single-layer attention LM over a per-slot ring KV cache (the dense
    baseline of the paged pool): ``emb`` (vocab, d), ``wo`` (d, d) ~
    N(0, 0.05²) from ``generator``, zeroed rings ``k``/``v`` (S, C, 1, d)
    and ``pos`` (S, C) = -1.  ``device`` None means the card (it raises
    where CUDA is absent); CPU callers pass ``"cpu"`` and a CPU
    generator."""
    dev = resolve_device(device, "make_paged_attn_model")
    emb = torch.randn((vocab, d), generator=generator, device=dev) * 0.05
    wo = torch.randn((d, d), generator=generator, device=dev) * 0.05
    ring = dict(dtype=torch.float32, device=dev)
    return {"emb": emb, "wo": wo,
            "k": torch.zeros((n_slots, capacity, 1, d), **ring),
            "v": torch.zeros((n_slots, capacity, 1, d), **ring),
            "pos": torch.full((n_slots, capacity), -1, dtype=torch.int32,
                              device=dev)}


def paged_attn_admit_fn(model, state: EngineState, rows, mask, slots):
    """Prefill into the rings: the admitted rows' prompt embeddings (tied
    K/V) fill their slots' rings from position 0, the rest of each ring
    zeroed and empty — one masked row write per round for all admitted
    slots, IN PLACE."""
    bl = state.backlog
    S, C = model["pos"].shape
    P = bl.prompt.shape[1]
    d = model["emb"].shape[1]
    dev = slots.device
    pe = model["emb"][bl.prompt[rows]]                       # (S, P, d)
    kc = torch.zeros((S, C, d), dtype=pe.dtype, device=dev)
    kc[:, :P] = pe
    c = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    posc = torch.where(c < bl.prompt_len[rows][:, None], c, -1)
    put_rows_(model["k"].view(S, -1), slots, kc.reshape(S, -1), mask)
    put_rows_(model["v"].view(S, -1), slots, kc.reshape(S, -1), mask)
    put_rows_(model["pos"], slots, posc, mask)
    return model


def paged_attn_token_fn(model, state: EngineState):
    """Ring single-token decode: write the current token's K/V at the
    slot's ring cursor ``pos mod C`` (busy slots, IN PLACE), attend over
    the slot's ring with the decode-attention kernel
    (`kernels.ops.decode_attention`; its plain version on the CPU), and
    greedy-sample."""
    from ..kernels import ops

    sl = state.slots
    S, C = model["pos"].shape
    cur = model["emb"][sl.token]                             # (S, d)
    ring = (sl.pos % C).to(torch.int64)
    rows_i = torch.arange(S, device=cur.device)
    wr = sl.busy
    k, v, pos = model["k"], model["v"], model["pos"]
    k[rows_i, ring, 0] = torch.where(wr[:, None], cur, k[rows_i, ring, 0])
    v[rows_i, ring, 0] = torch.where(wr[:, None], cur, v[rows_i, ring, 0])
    pos[rows_i, ring] = torch.where(wr, sl.pos.to(torch.int32),
                                    pos[rows_i, ring])
    o = ops.decode_attention(cur[:, None, :].contiguous(), k, v, pos,
                             sl.pos.to(torch.int32))         # (S, 1, d)
    logits = (o[:, 0] @ model["wo"]) @ model["emb"].T
    return torch.argmax(logits, dim=-1).to(torch.int32), model


def make_paged_pool_model(generator: torch.Generator, vocab: int, d: int,
                          num_blocks: int, block_size: int, device=None):
    """Single-layer attention LM over the shared block-paged KV pool:
    ``emb`` (vocab, d), ``wo`` (d, d) ~ N(0, 0.05²) from ``generator`` (on
    ``device``), and zeroed pools ``kp``/``vp`` (NB, BS, 1, d).  ``device``
    None means the card (it raises where CUDA is absent); CPU callers pass
    ``"cpu"`` and a CPU generator."""
    dev = resolve_device(device, "make_paged_pool_model")
    emb = torch.randn((vocab, d), generator=generator, device=dev) * 0.05
    wo = torch.randn((d, d), generator=generator, device=dev) * 0.05
    pool = dict(dtype=torch.float32, device=dev)
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


def make_chunked_prefill_token_fn(chunk: int):
    """A :func:`chunked_prefill_token_fn` whose chunk window is the static
    chunk size instead of the whole prompt width: at most ``chunk`` prompt
    tokens move per round, so the chunk tensors are (S, chunk) rather than
    (S, P).  ``chunk`` must be ≥ the engine's chunk size (the scheduler
    checks the ``_chunk_window`` attribute set here)."""
    def token_fn(model, state):
        return _chunked_prefill_step(model, state, chunk)
    token_fn._chunk_window = chunk
    return token_fn


def chunked_prefill_token_fn(model, state: EngineState):
    """Continuous chunked prefill over the shared block pool: each round
    writes the slots' prompt chunks (``slots.chunk`` tokens from the KV
    cursor, into the blocks the round just took) and decodes every
    decode-ready slot, in one model call.  Uses `make_paged_pool_model`
    state; the chunk window is the whole prompt width (see
    :func:`make_chunked_prefill_token_fn`)."""
    return _chunked_prefill_step(model, state, state.slots.prompt.shape[1])


def _chunked_prefill_step(model, state: EngineState, window: int):
    """The chunk write through the paged-prefill kernel
    (`kernels.ops.paged_prefill`; q = k = v = the chunk's embeddings, off
    = the KV cursor, lens = this round's chunk), then, in the reference's
    order, the copy-on-write block copy, the decode write and the paged
    decode of the decode-ready slots.  This one-layer toy model uses only
    the kernel's pool write: the chunk queries' attention outputs are
    discarded, as the reference's gather path computes none.  Pools are
    written in place on the card."""
    from ..kernels import ops

    sl, kv = state.slots, state.kv
    NB, BS, KV, d = model["kp"].shape
    S, MB = kv.tbl.shape
    P = sl.prompt.shape[1]
    W = min(window, P)
    dev = kv.tbl.device
    # ---- prefill: this round's chunk embeddings into the pool
    j = sl.pos[:, None] + torch.arange(W, dtype=torch.int32, device=dev)
    ptok = sl.prompt.gather(1, torch.clamp(j, 0, P - 1).to(torch.int64))
    x = model["emb"][ptok][:, :, None, :].contiguous()       # (S, W, 1, d)
    _, kp, vp = ops.paged_prefill(x, x, x, model["kp"], model["vp"],
                                  kv.tbl.contiguous(), sl.pos.contiguous(),
                                  sl.chunk.contiguous())
    model = {**model, "kp": kp, "vp": vp}
    # ---- decode: decode-ready slots only (prefilling and parked slots are
    # masked; the engine's emit mask drops their samples)
    ready = sl.busy & (sl.pos >= sl.plen)
    cur = model["emb"][sl.token]                             # (S, d)
    rows_i = torch.arange(S, device=dev)
    dbid = kv.tbl[rows_i, torch.clamp(sl.pos // BS, 0, MB - 1)]
    wr = ready & (dbid >= 0)
    if sl.cow_src is not None:
        # sharing: never write a block another slot can read (a slot
        # whose copy-on-write take was denied still points at the shared
        # tail), and a slot granted a private copy of its shared tail this
        # round copies the whole block before its decode write lands
        wr = wr & (kv.pool.refcnt[torch.clamp(dbid, 0, NB - 1)
                                  .to(torch.int64)] <= 1)
        do_cow = wr & (sl.cow_src >= 0)
        src = torch.clamp(sl.cow_src, 0, NB - 1).to(torch.int64)
        for pool in (kp, vp):
            blocks = pool.view(NB, -1)
            put_rows_(blocks, dbid, blocks[src], do_cow)
    r = _pool_rows(model, dbid, sl.pos % BS)
    put_rows_(kp.view(-1, d), r, cur, wr)
    put_rows_(vp.view(-1, d), r, cur, wr)
    lens = torch.where(wr, sl.pos + 1, 0)
    o = ops.paged_decode(cur[:, None, :], kp, vp, kv.tbl, lens)  # (S, 1, d)
    logits = (o[:, 0] @ model["wo"]) @ model["emb"].T
    return torch.argmax(logits, dim=-1).to(torch.int32), model
