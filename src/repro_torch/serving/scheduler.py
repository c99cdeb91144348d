"""Multi-tenant continuous-batching engine on PyTorch — the port of
``repro.serving.scheduler.ContinuousBatchingEngine`` for its main path:
QoS tenants, optionally the block-paged KV pool in up-front mode, served
by ``megastep(K)``.

Admission is the paper's semaphore at three granularities: per-tenant TWA
semaphores replenished by stride scheduling (`admission.functional_qos`),
the free-slot semaphore, and the block pool (`core.functional.BlockPool`).
``megastep(K)`` uploads the host queues, runs K device rounds
(`serving.engine_state.megastep_scan`, no host sync inside) and drains
every round's outputs in ONE transfer — ``stats.host_syncs`` counts 1 per
megastep.  Client threads wait on the host TWA futex semaphore
(`core.twa_semaphore`).

The engine runs on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises where CUDA is absent.

Not in this slice (each raises ``NotImplementedError`` naming its ROADMAP
item): the single-tenant engine, chunked prefill, prefix sharing, the
``obs`` hooks, and the host ``step()`` twin.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..admission.functional_qos import (
    make_qos,
    qos_reclaim,
    qos_replenish,
    qos_take,
)
from ..core.functional import next_pow2 as _next_pow2
from ..core.twa_semaphore import TWASemaphore


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1: {item})")


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    tenant_id: str = "default"
    deadline: Optional[float] = None  # absolute clock() admission deadline
    ticket: Optional[int] = None
    bucket: Optional[int] = None
    observed_seq: Optional[int] = None
    fast: bool = False
    slot: Optional[int] = None
    expired: bool = False    # deadline passed before admission
    preempted: bool = False  # deadline passed mid-decode (slot reclaimed)
    out_tokens: list[int] = field(default_factory=list)
    done_event: threading.Event = field(default_factory=threading.Event)
    enqueue_t: float = 0.0
    admit_t: float = 0.0
    finish_t: float = 0.0
    # virtual-clock lifecycle stamps (the injectable ``clock=``)
    submit_clock: Optional[float] = None
    first_tok_clock: Optional[float] = None
    last_tok_clock: Optional[float] = None
    finish_clock: Optional[float] = None
    admit_round: int = -1   # global engine round of admission
    expire_round: int = -1  # global engine round of expiry/preemption
    parked: bool = False    # block-parked (chunked prefill; never here)
    last_adv_round: int = -1  # last round with progress (watchdog clock)


@dataclass
class EngineStats:
    admitted: int = 0
    finished: int = 0
    expired: int = 0     # deadline-missed (tombstones + preemptions)
    preempted: int = 0   # deadline-missed mid-decode
    steps: int = 0
    backlog_scans: int = 0
    backlog_skipped: int = 0
    wakeups: int = 0
    host_syncs: int = 0  # host↔device round-trips (1 per megastep)
    kv_block_stalls: int = 0
    prefill_chunks: int = 0
    prefix_hits: int = 0
    cow_copies: int = 0
    quarantined: int = 0
    requeued: int = 0
    kv_audits: int = 0
    kernel_fallbacks: int = 0
    snapshots: int = 0
    restores: int = 0


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ContinuousBatchingEngine runs on the card by default and CUDA "
            "is not available here; pass device='cpu' to run on the CPU")
    return dev


class ContinuousBatchingEngine:
    """Slot-synchronous decode engine with TWA-semaphore admission.

    ``step_fn``/``prefill_fn`` are the host ``step()`` path's model hooks
    (kept for the reference's signature; that path is not ported yet).
    """

    def __init__(
        self,
        step_fn: Callable,
        prefill_fn: Callable,
        n_slots: int,
        *,
        table_size: int = 256,
        use_kernel: bool = False,
        tenants: Optional[dict[str, float]] = None,
        clock: Callable[[], float] = time.monotonic,
        backlog_cap: int = 4096,
        prompt_cap: int = 32,
        kv_pool: Optional[tuple] = None,
        chunked_prefill: Optional[tuple] = None,
        prefix_cache: int = 0,
        obs=None,
        watchdog: int = 0,
        device=None,
    ):
        if tenants is None:
            raise _not_ported("the single-tenant engine (sema_batch path)",
                              "item 5, the sema_batch path")
        if chunked_prefill is not None:
            raise _not_ported("chunked_prefill", "item 1, chunked prefill")
        if prefix_cache:
            raise _not_ported("prefix_cache", "item 2, prefix sharing")
        if obs is not None:
            raise _not_ported("the obs/trace hooks", "item 4, obs/trace")
        self.device = _resolve_device(device)
        self.n_slots = n_slots
        self.active: dict[int, Request] = {}  # slot → request
        self.free_slots = list(range(n_slots))
        self.stats = EngineStats()
        self._lock = threading.Lock()
        self._client_sem = TWASemaphore(0, waiting="futex")  # completions
        self._use_kernel = use_kernel
        self._clock = clock  # deadlines compare against THIS time source
        self._round_no = 0   # global engine round counter
        self._watchdog = int(watchdog)
        self._last_samples: list[dict] = []
        self._backlog_cap = backlog_cap
        self._prompt_cap = prompt_cap
        self.megastep_model = None  # device model (dict of tensors)
        # --- block-paged KV pool, up-front mode ---
        # ``kv_pool=(num_blocks, block_size[, max_blocks_per_seq])``:
        # admission gates on a free slot AND the request's worst-case block
        # demand; the host keeps only the free-block counter, the block
        # identities live in the device pool (`_kv_state`).
        self._kv_pool = kv_pool
        if kv_pool is not None:
            nb, bs, *rest = kv_pool
            nb, bs = int(nb), int(bs)
            if nb <= 0 or (nb & (nb - 1)) or bs <= 0:
                raise ValueError(
                    f"kv_pool needs a power-of-two block count and a "
                    f"positive block size, got {kv_pool}")
            self._kv_blocks, self._kv_bs = nb, bs
            self._kv_mb = int(rest[0]) if rest else nb  # table width
            self._kv_free_blocks = nb
            self._kv_state = None  # device KVPool, persisted across launches
        # --- multi-tenant QoS admission ---
        bad = {t: w for t, w in tenants.items() if not w > 0}
        if bad:
            raise ValueError(
                f"tenant weights must be > 0, got {bad}; zero-weight "
                "tenants would starve after at most one admission")
        self._tenants = tenants
        self._tenant_names = list(tenants)
        self._tindex = {t: i for i, t in enumerate(self._tenant_names)}
        self.qos = make_qos([tenants[t] for t in self._tenant_names],
                            table_size=table_size, device=self.device)
        self._qos_free = n_slots  # undistributed global slots
        self._tenant_queues: list[deque[Request]] = [
            deque() for _ in self._tenant_names]
        self._tenant_live = np.zeros(len(self._tenant_names), np.int64)
        self.tenant_admitted = {t: 0 for t in self._tenant_names}
        self.tenant_expired = {t: 0 for t in self._tenant_names}

    # ------------------------------------------------------------ client ----

    def submit(self, req: Request) -> Request:
        """Take a ticket (FCFS position within the tenant) and enqueue."""
        self._submit_qos([req])
        return req

    def submit_batch(self, reqs: list[Request]) -> None:
        """Vectorized ticket issuance for K arrivals."""
        self._submit_qos(reqs)

    def step(self, sample_fn):
        raise _not_ported("the host step() twin",
                          "item 3, the host step() twin")

    # ------------------------------------------------- multi-tenant (QoS) ---

    def _submit_qos(self, reqs: list[Request]) -> None:
        """Batched ticket issuance against the per-tenant QoS semaphores.
        Arrivals whose deadline already passed are dead on arrival."""
        from .engine_state import drain

        unknown = {r.tenant_id for r in reqs} - self._tindex.keys()
        if unknown:
            raise ValueError(
                f"unregistered tenant(s) {sorted(unknown)}; this engine "
                f"serves tenants {list(self._tenant_names)}")
        if self._kv_pool is not None:
            # a request whose whole-lifetime demand exceeds what the pool
            # (or its slot table) can ever hold would stall forever
            cap = min(self._kv_mb, self._kv_blocks)
            for r in reqs:
                dem = self._kv_demand(r)
                if dem > cap:
                    raise ValueError(
                        f"request rid={r.rid} needs {dem} KV blocks over "
                        f"its lifetime (> {cap} = min(table, pool)): "
                        f"prompt_len + max_new must fit "
                        f"{cap * self._kv_bs} pooled tokens — it could "
                        "never be served and would stall forever")
        with self._lock:
            now = self._clock()
            ids = [self._tindex[r.tenant_id] for r in reqs]
            # deadlines enter the device RELATIVE to now (f32 precision)
            dls = [np.inf if r.deadline is None else r.deadline - now
                   for r in reqs]
            dev = self.device
            self.qos, tickets, buckets, expired = qos_take(
                self.qos, torch.tensor(ids, dtype=torch.int32, device=dev),
                torch.ones(len(reqs), dtype=torch.bool, device=dev),
                torch.tensor(dls, dtype=torch.float32, device=dev), 0.0)
            tickets, buckets, expired, seq = drain(
                (tickets, buckets, expired, self.qos.bucket_seq))
            for r, i, t, b, e in zip(reqs, ids, tickets, buckets, expired):
                r.enqueue_t = time.time()
                r.submit_clock = now
                if e:
                    self._expire_req(r, i)
                    continue
                r.ticket = int(t)
                r.bucket = int(b)
                r.observed_seq = int(seq[r.bucket])
                r.fast = True
                self._tenant_queues[i].append(r)
                self._tenant_live[i] += 1
            # undistributed slots flow to the new demand immediately
            self._replenish_qos(0)

    def _kv_demand(self, r: Request) -> int:
        """Worst-case block demand — mirrors `engine_state._block_demand`
        (the device sees the prompt truncated to the padded cap)."""
        plen = min(len(r.prompt), self._prompt_cap) or 1
        return max(1, -(-(plen + r.max_new_tokens) // self._kv_bs))

    def _expire_req(self, r: Request, tidx: int) -> None:
        r.expired = True
        r.expire_round = self._round_no
        self.stats.expired += 1
        self.tenant_expired[self._tenant_names[tidx]] += 1
        r.finish_t = time.time()
        if r.finish_clock is None:  # megastep drains pre-stamp it
            r.finish_clock = self._clock()
        r.done_event.set()

    def _replenish_qos(self, freed: int) -> None:
        """Slot(s) freed: reclaim stranded credit, then distribute the pool
        to tenants with unmet live demand by stride scheduling.  With
        ``use_kernel`` the in-round kernel replenishes; the freed units
        only bank for the next round."""
        if self._use_kernel:
            self._qos_free += freed
            return
        depths = torch.tensor(self._tenant_live, dtype=torch.int32,
                              device=self.device)
        self.qos, reclaimed = qos_reclaim(self.qos, depths)
        self._qos_free += freed + int(reclaimed)
        if self._qos_free > 0:
            self.qos, alloc, leftover = qos_replenish(
                self.qos, self._qos_free, depths, self.n_slots)
            self._qos_free = int(leftover)
            for tidx in np.flatnonzero(alloc.cpu().numpy()):
                for r in self._tenant_queues[tidx]:
                    if not r.expired:
                        r.fast = True
                        break

    # --------------------------------------------------------- megastep ----

    def megastep(self, K: int, *, token_fn=None, admit_fn=None,
                 nows=None, admit_impl="auto") -> int:
        """K engine rounds on the device (`engine_state.megastep_scan`)
        drained in ONE host sync.  Each round: deadline preemption → QoS
        admission (freed units feed the same round) → block gate (paged) →
        FCFS slot assignment → ``token_fn`` decode + sample → completion.

        ``token_fn(model, EngineState) -> (tokens (S,) i32, model')`` and
        the prefill hook ``admit_fn(model, state, rows, mask, slots) ->
        model'`` run on the device; the model lives in
        ``self.megastep_model``.  ``nows``: optional (K,) timestamps
        relative to launch (default all 0.0).  ``admit_impl``: ``"auto"``
        routes admission through `engine_state.fused_round_impl` (the CUDA
        kernel on the card, its plain version on the CPU) when
        ``use_kernel``, else the functional round; or pass an
        implementation.  Returns the number of busy
        slots after the last round."""
        from .engine_state import (
            Slots,
            drain,
            fused_round_impl,
            make_engine_state,
            megastep_scan,
            ring_samples,
            zero_token_fn,
        )

        if K < 1:
            raise ValueError("megastep needs K >= 1")
        token_fn = token_fn or zero_token_fn
        dev = self.device
        with self._lock:
            self.stats.host_syncs += 1
            base = self._round_no
            t0 = self._clock()
            S = self.n_slots

            # round-robin drain of the tenant queues up to the backlog
            # capacity: truncation cuts per-tenant queue TAILS only
            qs = [[r for r in q if not r.expired]
                  for q in self._tenant_queues]
            heads = [0] * len(qs)
            rows: list[Request] = []
            while len(rows) < self._backlog_cap:
                moved = False
                for qi, q in enumerate(qs):
                    if heads[qi] < len(q) and len(rows) < self._backlog_cap:
                        rows.append(q[heads[qi]])
                        heads[qi] += 1
                        moved = True
                if not moved:
                    break
            n = len(rows)
            B = max(_next_pow2(max(n, S)), 8)
            maxp = max([len(r.prompt) for r in rows]
                       + [len(r.prompt) for r in self.active.values()] + [1])
            P = min(_next_pow2(maxp), self._prompt_cap)

            paged = self._kv_pool is not None
            fresh_kv = paged and self._kv_state is None
            state = make_engine_state(
                self.qos, S, B, P, free_units=self._qos_free,
                kv_blocks=self._kv_blocks if fresh_kv else 0,
                kv_slot_blocks=self._kv_mb if fresh_kv else 0,
                ring_cap=_next_pow2(K), device=dev)
            if paged and not fresh_kv:
                state = state._replace(kv=self._kv_state)
            valid = np.zeros(B, bool)
            ids = np.zeros(B, np.int32)
            tks = np.zeros(B, np.int64)
            dls = np.full(B, np.inf, np.float32)
            rid = np.full(B, -1, np.int32)
            mx = np.zeros(B, np.int32)
            pl = np.zeros(B, np.int32)
            pr = np.zeros((B, P), np.int32)
            for i, r in enumerate(rows):
                valid[i] = True
                ids[i] = self._tindex[r.tenant_id]
                tks[i] = r.ticket
                if r.deadline is not None:
                    dls[i] = r.deadline - t0
                rid[i] = r.rid
                mx[i] = r.max_new_tokens
                p = r.prompt[-P:] if r.prompt else [0]
                pl[i] = len(p)
                pr[i, :len(p)] = p
            sb = np.zeros(S, bool)
            srow = np.full(S, -1, np.int32)
            srid = np.full(S, -1, np.int32)
            sten = np.zeros(S, np.int32)
            sdl = np.full(S, np.inf, np.float32)
            smx = np.zeros(S, np.int32)
            sem = np.zeros(S, np.int32)
            stok = np.zeros(S, np.int32)
            spos = np.zeros(S, np.int32)
            spl = np.zeros(S, np.int32)
            sladv = np.zeros(S, np.int32)
            for slot, r in self.active.items():
                sb[slot] = True
                sladv[slot] = r.last_adv_round
                srow[slot] = B + slot  # host-resolved: active at launch
                srid[slot] = r.rid
                sten[slot] = self._tindex[r.tenant_id]
                if r.deadline is not None:
                    sdl[slot] = r.deadline - t0
                smx[slot] = r.max_new_tokens
                sem[slot] = len(r.out_tokens)
                stok[slot] = (r.out_tokens[-1] if r.out_tokens
                              else (r.prompt[-1] if r.prompt else 0))
                # the DEVICE cursor: prompts longer than the cap were
                # truncated at admission
                plen_t = min(len(r.prompt), self._prompt_cap) or 1
                spl[slot] = plen_t
                spos[slot] = plen_t + len(r.out_tokens)

            def up(a):
                return torch.as_tensor(a, device=dev)

            z = torch.zeros(S, dtype=torch.int32, device=dev)
            state = state._replace(
                round_no=torch.full((), base, dtype=torch.int32, device=dev),
                stalls=torch.full((), self.stats.kv_block_stalls,
                                  dtype=torch.int32, device=dev),
                chunks=torch.full((), self.stats.prefill_chunks,
                                  dtype=torch.int32, device=dev),
                backlog=state.backlog._replace(
                    valid=up(valid), tenant=up(ids), ticket=up(tks),
                    deadline=up(dls), rid=up(rid), max_new=up(mx),
                    prompt=up(pr), prompt_len=up(pl)),
                slots=Slots(
                    busy=up(sb), row=up(srow), rid=up(srid), tenant=up(sten),
                    deadline=up(sdl), max_new=up(smx), emitted=up(sem),
                    token=up(stok), pos=up(spos), plen=up(spl),
                    prompt=torch.zeros((S, P), dtype=torch.int32,
                                       device=dev),
                    prio_r=z, prio_k=z,
                    parked=torch.zeros(S, dtype=torch.bool, device=dev),
                    park_bucket=z,
                    park_seq=torch.zeros(S, dtype=torch.int64, device=dev),
                    chunk=z, last_adv=up(sladv)),
                slot_sema=state.slot_sema._replace(
                    ticket=torch.full((), int(sb.sum()), dtype=torch.int64,
                                      device=dev)))

            if nows is None:
                nows_a = np.zeros(K, np.float32)
            else:
                nows_a = np.asarray(nows, np.float32)
                if nows_a.shape != (K,):
                    raise ValueError(f"nows must be shape ({K},)")
            if admit_impl == "auto":
                admit_impl = fused_round_impl if self._use_kernel else None

            model = self.megastep_model if self.megastep_model is not None \
                else ()
            st, model, ys = megastep_scan(
                state, model, up(nows_a), token_fn=token_fn,
                admit_fn=admit_fn, admit_impl=admit_impl,
                block_size=self._kv_bs if paged else 0,
                watchdog=self._watchdog)
            self.megastep_model = model

            # ---- the ONE host sync: drain every round's outputs --------
            kv_ctr = ((st.kv.pool.sema.grant, st.kv.pool.sema.ticket)
                      if paged else ())
            bl_h, sl_h, free_h, kv_h, ring_h, ys_h = drain((
                (st.backlog.admit_round, st.backlog.expire_round,
                 st.backlog.slot),
                (st.slots.busy, st.slots.row, st.slots.last_adv),
                st.free, kv_ctr, st.ring, ys))
            admit_h, expire_h, bslot_h = bl_h
            busy_h, row_h, ladv_h = sl_h
            prev_active = dict(self.active)

            def req_of(row: int) -> Request:
                return rows[row] if row < B else prev_active[row - B]

            gone = set()
            for i, r in enumerate(rows):
                tidx = self._tindex[r.tenant_id]
                if admit_h[i] >= 0:
                    r.admit_round = int(admit_h[i])
                    r.admit_t = time.time()
                    r.slot = int(bslot_h[i])
                    self.stats.admitted += 1
                    self.tenant_admitted[r.tenant_id] += 1
                    self._tenant_live[tidx] -= 1
                    gone.add(id(r))
                elif expire_h[i] >= 0:
                    # stamp the in-round expiry clock before _expire_req
                    r.expire_round = int(expire_h[i])
                    r.finish_clock = t0 + float(
                        nows_a[r.expire_round - base])
                    self._expire_req(r, tidx)
                    r.expire_round = int(expire_h[i])
                    self._tenant_live[tidx] -= 1
                    gone.add(id(r))
            if gone:
                for tidx, q in enumerate(self._tenant_queues):
                    self._tenant_queues[tidx] = deque(
                        r for r in q if id(r) not in gone)

            for k in range(K):
                tk = t0 + float(nows_a[k])  # round k's clock (absolute)
                for s in np.flatnonzero(ys_h.pre[k]):
                    r = req_of(int(ys_h.prerow[k][s]))
                    r.expired = True
                    r.preempted = True
                    r.expire_round = base + k
                    r.finish_t = time.time()
                    r.finish_clock = tk
                    self.stats.preempted += 1
                    self.stats.expired += 1
                    self.tenant_expired[r.tenant_id] += 1
                    self.stats.wakeups += 1
                    r.done_event.set()
                    self._client_sem.post()
                for s in np.flatnonzero(ys_h.emit[k]):
                    r = req_of(int(ys_h.row[k][s]))
                    r.out_tokens.append(int(ys_h.tokens[k][s]))
                    if r.first_tok_clock is None:
                        r.first_tok_clock = tk
                    r.last_tok_clock = tk
                for s in np.flatnonzero(ys_h.fin[k]):
                    r = req_of(int(ys_h.row[k][s]))
                    r.finish_t = time.time()
                    r.finish_clock = tk
                    self.stats.finished += 1
                    self.stats.wakeups += 1
                    r.done_event.set()
                    self._client_sem.post()
            self.stats.steps += int((ys_h.n_active > 0).sum())
            self.stats.backlog_scans += int(ys_h.n_live.sum())

            self.active = {int(s): req_of(int(row_h[s]))
                           for s in np.flatnonzero(busy_h)}
            self.free_slots = [s for s in range(S) if not busy_h[s]]
            for s, r in self.active.items():
                r.last_adv_round = int(ladv_h[s])
            self._qos_free = int(free_h)
            self.qos = st.qos  # stays on the device
            if paged:
                self._kv_state = st.kv
                grant, ticket = kv_h
                self._kv_free_blocks = int(np.int64(grant - ticket)
                                           .astype(np.int32))
            self._last_samples = ring_samples(ring_h, t0=t0)
            self._round_no = base + K
            return int(busy_h.sum())

    # ---------------------------------------------------------- telemetry ---

    def telemetry(self) -> dict:
        """Gauge snapshot of the engine — pure host-side reads (no device
        transfer, no ``host_syncs`` bump).  ``last_samples`` holds the K
        per-round samples of the last ``megastep(K)``.  The reference's
        ``trace`` and ``slo`` keys wait for the obs/trace slice."""
        tel = {
            "backlog": int(self._tenant_live.sum()),
            "active": len(self.active),
            "free_slots": len(self.free_slots),
            "queue_depth": int(self._tenant_live.sum()),
            "stats": self.stats.__dict__.copy(),
            "pool_utilization": None,  # unpaged: no pool
            "last_samples": list(self._last_samples),
            "recovery": {k: getattr(self.stats, k) for k in (
                "quarantined", "requeued", "kv_audits", "kernel_fallbacks",
                "snapshots", "restores")},
        }
        if self._kv_pool is not None:
            tel["kv_blocks_free"] = int(self._kv_free_blocks)
            tel["kv_blocks_live"] = int(self._kv_blocks
                                        - self._kv_free_blocks)
            # blocks actually HOLDING tokens / pool
            written = 0
            for r in self.active.values():
                plen = min(len(r.prompt), self._prompt_cap) or 1
                written += -(-(plen + len(r.out_tokens)) // self._kv_bs)
            tel["pool_utilization"] = written / self._kv_blocks
            tel["kv_block_stalls"] = self.stats.kv_block_stalls
            tel["prefill_chunks"] = self.stats.prefill_chunks
            tel["parked_slots"] = sum(r.parked for r in self.active.values())
        total = sum(self.tenant_admitted.values())
        tel["tenants"] = {
            t: {"weight": self._tenants[t],
                "admitted": self.tenant_admitted[t],
                "expired": self.tenant_expired[t],
                "share": (self.tenant_admitted[t] / total) if total else 0.0,
                "queue_depth": int(self._tenant_live[self._tindex[t]])}
            for t in self._tenant_names
        }
        return tel
