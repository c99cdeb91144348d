"""Continuous-batching engine on PyTorch — the port of
``repro.serving.scheduler.ContinuousBatchingEngine``.

Two engines in one class, as in the reference:

* **Multi-tenant** (``tenants={...}``): QoS tenants, optionally the
  block-paged KV pool (up-front, or with continuous chunked prefill and
  refcounted prefix sharing).  Admission is the paper's semaphore at three
  granularities: per-tenant TWA semaphores replenished by stride
  scheduling (`admission.functional_qos`), the free-slot semaphore, and
  the block pool (`core.functional.BlockPool`).  Two serving paths,
  round-for-round identical (``megastep(K) ≡ K·step()``: tokens, rounds,
  the QoS and pool state, every telemetry sample and event row):

  - ``megastep(K)`` uploads the host queues, runs K device rounds
    (`serving.engine_state.megastep_scan`, no host sync inside) and
    drains every round's outputs in ONE transfer — ``stats.host_syncs``
    counts 1 per megastep;
  - the host ``step()``: preempt expired → QoS admission (with
    ``use_kernel`` one `kernels.ops.qos_round` call over the live backlog
    — one kernel launch on the card — else the TWA queue walk with the
    host deadline heap) → block gate → FCFS slot assignment → chunk plan
    (chunked) → decode through ``step_fn`` → retire.  Its state lives on
    ``self.device``; each phase reads back what it needs in one transfer
    (`engine_state.drain`), and ``stats.host_syncs`` counts 1 per step.
    The host mirrors the block semaphore (``_kv_sema``,
    ``_kv_free_blocks``); with prefix sharing it keeps a replica of the
    pool, cache and tables (``_kv_hpool``, ``_kv_cache``, ``_kv_htbl``)
    that the first megastep adopts.

* **Single-tenant** (``tenants=None``): one TWA semaphore over the free
  slots (`core.functional`), tickets issued by ``submit``/``submit_batch``
  (with ``use_kernel`` through the batched ``sema_batch`` kernel), and the
  host ``step()``: preempt expired → admit the requests whose waiting-array
  bucket moved (``woken_mask``) → prefill → decode through ``step_fn`` →
  sample on the host.

Both paths feed the always-on trace buffer (`obs.trace.TraceBuffer`) and
an optional ``obs=`` layer (`obs.EngineObs`).  Client threads wait on the
host TWA futex semaphore (`core.twa_semaphore`).  The engine runs on the
card unless the caller asks for the CPU: ``device=None`` means ``"cuda"``
and raises where CUDA is absent.

Not in the port yet: the recovery rungs (``quarantine``, ``audit_kv``,
ROADMAP queue 1 item 6, resilience).
"""

from __future__ import annotations

import heapq
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
from ..core import u32
from ..core.functional import (
    make_block_pool,
    make_sema,
    next_pow2 as _next_pow2,
    park_state,
    pool_free_count,
    pool_incref,
    pool_release,
    pool_try_alloc,
    post_batch,
    take_batch,
    woken_mask,
)
from ..core.twa_semaphore import TWASemaphore
from ..device import resolve_device
from ..kernels.qos_admission import check_backlog_rows, check_engine_limits
from ..obs.trace import TraceBuffer
from .engine_state import (
    _D_CLAMP,
    _T_BITS,
    SLOT_TABLE,
    KVPool,
    Slots,
    _held,
    _select,
    _set_cells,
    _share_flags,
    drain,
    fused_round_impl,
    make_engine_state,
    megastep_scan,
    ring_samples,
    zero_token_fn,
)
from .events import (
    EV_ADMIT,
    EV_COW,
    EV_EXPIRE,
    EV_FINISH,
    EV_PARK,
    EV_PREEMPT,
    EV_PREFILL_CHUNK,
    EV_PREFIX_ATTACH,
    EV_RESUME,
    EV_SUBMIT,
)
from .prefill import banker_order, chunk_plan, shared_first_chunk_demand
from .prefix import cache_lookup, cache_register, make_prefix_cache, \
    prompt_hashes
from .sentinels import host_round_health


def _sdist(a, b):
    """Signed u32 distance ``a − b`` of numpy u32 carriers (int64)."""
    return ((np.asarray(a, np.int64) - np.asarray(b, np.int64) + (1 << 31))
            & u32.MASK32) - (1 << 31)


def _tdist(ticket: int, grant: int) -> int:
    """Wrap-safe signed distance of a u32 ticket from a grant frontier."""
    d = (ticket - grant) & 0xFFFFFFFF
    return d - (1 << 32) if d >= (1 << 31) else d


def _prio_key(ticket: int, grant: int, tidx: int) -> int:
    """The packed FCFS admission key of `engine_state._fcfs_key`: the
    clamped ticket distance from the grant frontier, shifted, plus the
    tenant index."""
    d = _tdist(ticket, grant)
    return (max(-_D_CLAMP, min(_D_CLAMP, d)) << _T_BITS) + tidx


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
    prefill_pos: int = 0    # prompt tokens prefilled so far (chunked)
    kv_blocks: int = 0      # pool blocks held (chunked: incremental takes)
    prio_key: int = 0       # packed FCFS admission key (Banker order)
    parked: bool = False    # block-parked on the block semaphore (chunked)
    park_bucket: int = 0    # observed TWAHash bucket
    park_seq: int = 0       # bucket sequence at park time
    last_adv_round: int = -1  # last round with progress (watchdog clock)
    ph: Optional[np.ndarray] = None  # (2, W+1) u32 prompt hashes (sharing)
    share: Optional[tuple] = None  # gate-time cache hit staged for the
    #                                attach: (c, bids, tail_bid, cov)


@dataclass
class EngineStats:
    admitted: int = 0
    finished: int = 0
    expired: int = 0     # deadline-missed (tombstones + preemptions)
    preempted: int = 0   # deadline-missed mid-decode
    steps: int = 0
    backlog_scans: int = 0    # requests re-examined by admission
    backlog_skipped: int = 0  # requests the TWA buckets let it skip
    wakeups: int = 0
    host_syncs: int = 0  # host↔device round-trips (1/step; 1/megastep)
    kv_block_stalls: int = 0  # cumulative parked slot-rounds
    prefill_chunks: int = 0
    prefix_hits: int = 0  # admissions whose whole prompt was cache-covered
    cow_copies: int = 0
    # the recovery ladder's counters (ROADMAP queue 1 item 6; 0 here)
    quarantined: int = 0
    requeued: int = 0
    kv_audits: int = 0
    kernel_fallbacks: int = 0
    snapshots: int = 0
    restores: int = 0


class ContinuousBatchingEngine:
    """Slot-synchronous decode engine with TWA-semaphore admission.

    ``step_fn(reqs) -> logits`` (numpy, one row per request) and
    ``prefill_fn(req)`` are the host ``step()`` path's model hooks.
    ``obs=`` takes anything with ``record_round(sample)``,
    ``record_request(req)`` and ``summary()`` (normally `obs.EngineObs`).
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
        self.device = resolve_device(device, "ContinuousBatchingEngine")
        if tenants is not None:
            check_engine_limits(self.device, use_kernel, len(tenants),
                                backlog_cap, n_slots)
        self.step_fn = step_fn
        self.prefill_fn = prefill_fn
        self.n_slots = n_slots
        self.sema = make_sema(count=n_slots, table_size=table_size,
                              device=self.device)
        self.backlog: list[Request] = []  # pending (ticketed, not admitted)
        self.active: dict[int, Request] = {}  # slot → request
        self.free_slots = list(range(n_slots))
        self.stats = EngineStats()
        self._lock = threading.Lock()
        self._client_sem = TWASemaphore(0, waiting="futex")  # completions
        self._use_kernel = use_kernel
        self._clock = clock  # deadlines compare against THIS time source
        self._round_no = 0   # global engine round counter
        self._watchdog = int(watchdog)
        # observability: the optional obs layer, the most recent step's or
        # megastep's samples, and the always-on trace buffer (engine-phase
        # events arrive with the samples; SUBMIT/EXPIRE are added here)
        self._obs = obs
        self._last_samples: list[dict] = []
        self._trace = TraceBuffer()
        self._backlog_cap = backlog_cap
        self._prompt_cap = prompt_cap
        self.megastep_model = None  # device model (dict of tensors)
        # host step(): the round's clock, its H_NAN input (non-finite host
        # logits), its event rows (one list per in-round kind, flattened
        # in events.SCAN_SEGMENTS order) and its per-round counters
        self._now_r = 0.0
        self._round_nonfinite = False
        self._ev_preempt: list[list[int]] = []
        self._ev_admit: list[list[int]] = []
        self._ev_attach: list[list[int]] = []
        self._ev_park: list[list[int]] = []
        self._ev_resume: list[list[int]] = []
        self._ev_chunk: list[list[int]] = []
        self._ev_cow: list[list[int]] = []
        self._ev_finish: list[list[int]] = []
        self._round_gate_stalls = 0
        self._round_prefill_tokens = 0
        self._round_prefill_chunks = 0
        self._round_prefix_hits = 0
        self._round_cow_copies = 0
        # host mirrors of the slot semaphore's counters, so telemetry()
        # never reads the device: takes bump the ticket, finish-posts the
        # grant — queue_depth = ticket − grant
        self._sema_ticket_h = 0
        self._sema_grant_h = n_slots
        # --- block-paged KV pool, up-front mode ---
        # ``kv_pool=(num_blocks, block_size[, max_blocks_per_seq])``:
        # admission gates on a free slot AND the request's worst-case block
        # demand.  The host keeps the free-block counter and a mirror of
        # the block semaphore (``_kv_sema``: takes advance its ticket,
        # releases post and poke, parks read its buckets); its table size
        # and salt are the pool's in `engine_state.make_engine_state`, so
        # both paths see the same bucket moves.  The block identities live
        # in the device pool (`_kv_state`) once a megastep ran.
        self._kv_pool = kv_pool
        if kv_pool is not None:
            if tenants is None:
                raise ValueError("kv_pool requires QoS mode (tenants=...)")
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
            self._kv_sema = make_sema(count=nb, table_size=SLOT_TABLE,
                                      device=self.device)
        # --- continuous chunked prefill ---
        # ``chunked_prefill=(chunk_tokens, token_budget[, commit_blocks])``:
        # admission gates on first-chunk demand behind the reserved
        # headroom and the commitment watermark (default 9/16 of the pool);
        # prompts prefill up to chunk_tokens a round under the token
        # budget, blocks are taken at boundary crossings, and block-stalled
        # slots park on the block semaphore's waiting array.
        self._chunk, self._budget, self._kv_commit = 0, 0, 0
        if chunked_prefill is not None:
            if kv_pool is None:
                raise ValueError(
                    "chunked_prefill requires the block-paged pool "
                    "(kv_pool=...): chunks allocate pool blocks "
                    "incrementally")
            ch, bu, *cw = chunked_prefill
            if int(ch) < 1 or int(bu) < 1:
                raise ValueError(
                    f"chunked_prefill needs a positive chunk size and "
                    f"token budget, got {chunked_prefill}")
            self._chunk, self._budget = int(ch), int(bu)
            self._kv_commit = int(cw[0]) if cw \
                else max(1, int(kv_pool[0]) * 9 // 16)
        # --- refcounted prefix sharing ---
        # ``prefix_cache=E`` (power-of-two entries; needs chunked prefill):
        # admissions whose prompt prefix is pool-resident attach the shared
        # blocks by incref and pay only for post-divergence demand.  Block
        # identities and refcounts decide sharing, so the host keeps a
        # replica of the pool, cache and tables on ``self.device`` and
        # mutates it through the same functions the device round uses, in
        # the same batched pattern (one release per preempt / COW / finish
        # phase: per-slot releases would reorder the free queue).
        self._kv_share = int(prefix_cache) > 0
        if self._kv_share:
            if not self._chunk:
                raise ValueError(
                    "prefix_cache requires continuous chunked prefill "
                    "(chunked_prefill=...): shared prefixes resume at the "
                    "divergence point mid-prompt")
            e = int(prefix_cache)
            if e & (e - 1):
                raise ValueError(
                    f"prefix_cache needs a power-of-two entry count "
                    f"(direct-mapped homes are key & (E-1)), got {e}")
            self._kv_prefix = e
            self._hash_w = self._prompt_cap // self._kv_bs
            self._kv_hpool = make_block_pool(self._kv_blocks,
                                             table_size=SLOT_TABLE,
                                             device=self.device)
            self._kv_cache = make_prefix_cache(e, device=self.device)
            self._kv_htbl = torch.full((n_slots, self._kv_mb), -1,
                                       dtype=torch.int32, device=self.device)
            self._kv_sema = self._kv_hpool.sema
            # host mirrors of the replica: refcounts, blocks per slot
            self._kv_refcnt_h = np.zeros(self._kv_blocks, np.int32)
            self._kv_held_h = np.zeros(n_slots, np.int32)
        # --- multi-tenant QoS admission ---
        self._tenants = tenants
        if tenants is None:
            return
        bad = {t: w for t, w in tenants.items() if not w > 0}
        if bad:
            raise ValueError(
                f"tenant weights must be > 0, got {bad}; zero-weight "
                "tenants would starve after at most one admission")
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
        # the queue walk's expiry heap (the kernel round expires in-round)
        self._deadline_heap: list[tuple[float, int, Request]] = []

    def _up(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------ client ----

    def submit(self, req: Request) -> Request:
        """Take a ticket (FCFS position) and enqueue."""
        if self._tenants is not None:
            self._submit_qos([req])
            return req
        req.enqueue_t = time.time()
        with self._lock:
            req.submit_clock = self._clock()
            self._sema_ticket_h += 1
            self.sema, tk, adm, bkt = take_batch(
                self.sema, torch.ones(1, dtype=torch.bool,
                                      device=self.device))
            tk, bkt, adm, seq = drain((tk, bkt, adm, self.sema.bucket_seq))
            req.ticket = int(tk[0])
            req.bucket = int(bkt[0])
            req.fast = bool(adm[0])
            req.observed_seq = int(seq[req.bucket])
            self.backlog.append(req)
            self._trace.add(EV_SUBMIT, req.rid, -1, 0, req.submit_clock,
                            self._round_no)
        return req

    def submit_batch(self, reqs: list[Request]) -> None:
        """Vectorized ticket issuance for K arrivals — with ``use_kernel``
        one ``sema_batch`` pass (the CUDA kernel on the card, its plain
        version on the CPU), else `take_batch`.  Tickets, buckets, admits
        and the post-take waiting array come back in ONE transfer."""
        if self._tenants is not None:
            self._submit_qos(reqs)
            return
        with self._lock:
            n = len(reqs)
            sclk = self._clock()
            self._sema_ticket_h += n
            ones = torch.ones(n, dtype=torch.bool, device=self.device)
            if self._use_kernel:
                from ..kernels import ops

                nt, ng, nseq, tk, adm, bkt, _ = ops.sema_batch(
                    self.sema.ticket, self.sema.grant, self.sema.bucket_seq,
                    ones, 0, self.sema.salt)
                self.sema = self.sema._replace(ticket=nt, grant=ng,
                                               bucket_seq=nseq)
            else:
                self.sema, tk, adm, bkt = take_batch(self.sema, ones)
            tk, bkt, adm, seq = drain((tk, bkt, adm, self.sema.bucket_seq))
            for r, t, b, a in zip(reqs, tk, bkt, adm):
                r.enqueue_t = time.time()
                r.submit_clock = sclk
                r.ticket = int(t)
                r.bucket = int(b)
                r.fast = bool(a)
                r.observed_seq = int(seq[r.bucket])
                self.backlog.append(r)
                self._trace.add(EV_SUBMIT, r.rid, -1, 0, sclk,
                                self._round_no)

    # ------------------------------------------------- multi-tenant (QoS) ---

    def _submit_qos(self, reqs: list[Request]) -> None:
        """Batched ticket issuance against the per-tenant QoS semaphores.
        Arrivals whose deadline already passed are dead on arrival.  On
        the card with ``use_kernel``, arrivals that would take the live
        backlog past the QoS kernel's row limit are refused before any
        ticket is taken (`qos_admission.check_backlog_rows`): the host
        ``step()`` passes every live row to one kernel round."""
        unknown = {r.tenant_id for r in reqs} - self._tindex.keys()
        if unknown:
            raise ValueError(
                f"unregistered tenant(s) {sorted(unknown)}; this engine "
                f"serves tenants {list(self._tenant_names)}")
        check_backlog_rows(self.device, self._use_kernel,
                           int(self._tenant_live.sum()) + len(reqs))
        if self._kv_pool is not None:
            # a request whose whole-lifetime demand exceeds what the pool
            # (or its slot table) can ever hold would stall forever; in
            # chunked mode it would park with a deficit nothing covers
            cap = min(self._kv_mb, self._kv_blocks)
            for r in reqs:
                if self._chunk:
                    plen = len(r.prompt) or 1
                    if plen > self._prompt_cap:
                        raise ValueError(
                            f"request rid={r.rid} prompt ({plen} tokens) "
                            f"exceeds prompt_cap={self._prompt_cap}; "
                            "chunked prefill never truncates prompts — "
                            "raise prompt_cap")
                if self._kv_share and r.ph is None:
                    # hash once, here: the table rides the request as data
                    r.ph = np.asarray(
                        prompt_hashes(r.prompt or [0], self._kv_bs,
                                      self._hash_w), np.uint32)
                dem = self._kv_demand(r)
                if dem > cap:
                    if (self._kv_share and dem <= self._kv_mb
                            and dem - self._cached_blocks(r)
                            <= self._kv_blocks):
                        # post-divergence demand: the cache-covered blocks
                        # attach by incref, so the request is servable
                        # while its prefix stays resident
                        continue
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
                self._trace.add(EV_SUBMIT, r.rid, -1, 0, now,
                                self._round_no)
                if e:
                    self._expire_req(r, i)
                    continue
                r.ticket = int(t)
                r.bucket = int(b)
                r.observed_seq = int(seq[r.bucket])
                r.fast = True
                self._tenant_queues[i].append(r)
                self._tenant_live[i] += 1
                # the kernel round re-evaluates every deadline each round:
                # the heap would only leak entries there
                if r.deadline is not None and not self._use_kernel:
                    heapq.heappush(self._deadline_heap, (r.deadline, r.rid,
                                                         r))
            # undistributed slots flow to the new demand immediately
            self._replenish_qos(0)

    def _cached_blocks(self, r: Request) -> int:
        """Full blocks of ``r``'s prompt the prefix cache covers now (a
        read of the replica at submit, outside any round)."""
        plen = min(len(r.prompt), self._prompt_cap) or 1
        c, _, _, _ = cache_lookup(
            self._kv_cache, self._kv_hpool, u32.u32(r.ph[None],
                                                    device=self.device),
            torch.tensor([plen], dtype=torch.int32, device=self.device),
            self._kv_bs)
        return int(drain(c)[0])

    def _kv_demand(self, r: Request) -> int:
        """Worst-case block demand — mirrors `engine_state._block_demand`
        (the device sees the prompt truncated to the padded cap)."""
        plen = min(len(r.prompt), self._prompt_cap) or 1
        return max(1, -(-(plen + r.max_new_tokens) // self._kv_bs))

    def _kv_gate(self, cands: list[tuple[Request, int]], grants):
        """Host mirror of `functional_qos.block_gate` with the device
        round's `_fcfs_key`: of the QoS-admitted ``cands`` grant the
        longest FCFS prefix (wrap-safe ticket distance from the post-round
        ``grants``, tenant tiebreak) whose cumulative block demand fits the
        free pool — strict FCFS, no bypass.  Up-front mode gates on
        worst-case demand and takes it from the block-semaphore mirror;
        chunked mode gates on first-chunk demand (post-divergence under
        sharing) behind the Banker headroom and the commitment watermark
        and takes nothing.  Returns ``(granted, stalled)`` index lists in
        gate order; granted requests get their priority key (and, under
        sharing, the cache hit to attach)."""
        def key(i: int) -> int:
            r, tidx = cands[i]
            return _prio_key(r.ticket, int(grants[tidx]), tidx)

        order = sorted(range(len(cands)), key=key)
        free = self._kv_free_blocks
        commit_free = bootstrap = 0
        share = None
        if self._chunk:
            cow = hf = None
            if self._kv_share:
                cow, hf = self._kv_share_state()
                # read-only longest-prefix probe over the candidates (the
                # device gate's `cache_lookup` over the backlog)
                pln = np.asarray([min(len(r.prompt), self._prompt_cap) or 1
                                  for r, _ in cands], np.int32)
                ph = np.stack([np.asarray(r.ph, np.uint32)
                               for r, _ in cands])
                pln_t = self._up(pln)
                c, bids, tail, cov = cache_lookup(
                    self._kv_cache, self._kv_hpool,
                    u32.u32(ph, device=self.device), pln_t, self._kv_bs)
                dem = shared_first_chunk_demand(pln_t, cov, self._chunk,
                                                self._kv_bs)
                c_a, bids_a, tail_a, cov_a, dem_a = drain(
                    (c, bids, tail, cov, dem))
                commit_a = np.asarray([self._kv_demand(r) for r, _ in cands],
                                      np.int64) - c_a
                # a row whose post-divergence demand exceeds the whole pool
                # can never be granted at its coverage: it stays stalled
                # without damming later rows
                doomed_a = commit_a > self._kv_blocks
                share = (c_a, bids_a, tail_a, cov_a, dem_a, commit_a,
                         doomed_a)
            free -= self._kv_headroom(share=(cow, hf))
            total_rem = sum(
                self._kv_rem(r) + (1 if cow is not None and cow[s] else 0)
                for s, r in self.active.items())
            commit_free = self._kv_commit - total_rem
            bootstrap = total_rem == 0
        granted, stalled = [], []
        dammed = False  # strict FCFS: the first eligible misfit blocks all
        for i in order:
            r = cands[i][0]
            if self._chunk:
                if share is not None:
                    if share[6][i]:  # doomed: skip, do not dam successors
                        stalled.append(i)
                        continue
                    dem = int(share[4][i])
                    commit = int(share[5][i])
                else:
                    dem = self._kv_first_chunk(r)
                    commit = self._kv_demand(r)
                ok = dem <= free and (commit <= commit_free
                                      or (bootstrap and not granted))
            else:
                dem = self._kv_demand(r)
                commit = 0
                ok = dem <= free
            if not dammed and ok:
                free -= dem
                commit_free -= commit
                r.prio_key = key(i)
                if share is not None:
                    r.share = (int(share[0][i]), share[1][i],
                               int(share[2][i]), int(share[3][i]))
                granted.append(i)
            else:
                dammed = True
                stalled.append(i)
        if not self._chunk:
            # up-front take: the mirror's ticket advances by the granted
            # demand — the counter move of the device `pool_alloc`
            taken = self._kv_free_blocks - free
            self._kv_free_blocks = free
            if taken:
                self._kv_sema = self._kv_sema._replace(
                    ticket=u32.add(self._kv_sema.ticket, taken))
        self._round_gate_stalls += len(stalled)
        return granted, stalled

    def _kv_first_chunk(self, r: Request) -> int:
        """First-chunk block demand (`prefill.first_chunk_demand`)."""
        plen = min(len(r.prompt), self._prompt_cap) or 1
        return max(1, -(-min(self._chunk, plen) // self._kv_bs))

    def _kv_rem(self, r: Request) -> int:
        """Worst-case remaining block demand of an active request."""
        return self._kv_demand(r) - r.kv_blocks

    def _kv_share_state(self):
        """Per-slot ``(cow, held_free)`` off the sharing replica — one
        call into `engine_state._share_flags`, the device round's formula,
        read back in one transfer.  ``cow[s]``: the slot's next decode
        write lands in a still-shared tail block; ``held_free[s]``: blocks
        the slot alone references (the Banker cover)."""
        S = self.n_slots
        busy = np.zeros(S, bool)
        pos = np.zeros(S, np.int32)
        plen = np.zeros(S, np.int32)
        for s, r in self.active.items():
            pl = min(len(r.prompt), self._prompt_cap) or 1
            busy[s] = True
            pos[s] = (r.prefill_pos if r.prefill_pos < pl
                      else pl + len(r.out_tokens))
            plen[s] = pl
        return drain(_share_flags(
            self._kv_htbl, self._kv_hpool.refcnt, self._up(busy),
            self._up(pos), self._up(plen), _held(self._kv_htbl),
            self._kv_bs))

    def _hshare_sync(self) -> None:
        """Re-derive the host mirrors (block semaphore, free count,
        refcounts, blocks per slot) from the sharing replica after a pool
        mutation, in one transfer."""
        self._kv_sema = self._kv_hpool.sema
        free, self._kv_refcnt_h, self._kv_held_h = drain((
            pool_free_count(self._kv_hpool), self._kv_hpool.refcnt,
            _held(self._kv_htbl)))
        self._kv_free_blocks = int(free)

    def _hshare_release(self, slots: list[int]) -> None:
        """ONE batched decref of every block the given slots hold — the
        device round's single `pool_release` per phase (preempt / finish).
        Per-slot releases would enqueue freed ids in another order."""
        if not slots:
            return
        mask = np.zeros(self.n_slots, bool)
        mask[slots] = True
        mask_t = self._up(mask)
        self._kv_hpool = pool_release(self._kv_hpool, self._kv_htbl, mask_t)
        self._kv_htbl = torch.where(mask_t[:, None], -1, self._kv_htbl)
        self._hshare_sync()

    def _kv_headroom(self, share=None) -> int:
        """Host mirror of `functional_qos.block_headroom` over the Banker
        chain (`prefill.banker_order`): the smallest free-pool level that
        keeps every active sequence's remaining worst-case demand covered
        by the pool plus what its chain-predecessors release.  Under
        sharing a pending copy-on-write owes one more block and only
        privately held blocks fund the cover."""
        cow = hf = None
        if share is not None:
            cow, hf = share
        elif self._kv_share:
            cow, hf = self._kv_share_state()

        def rem_of(s: int, r: Request) -> int:
            return self._kv_rem(r) + (1 if cow is not None and cow[s]
                                      else 0)

        acts = sorted(self.active.items(),
                      key=lambda kv: (rem_of(*kv), kv[1].admit_round,
                                      kv[1].prio_key, kv[0]))
        cum = head = 0
        for s, r in acts:
            head = max(head, rem_of(s, r) - cum)
            cum += int(hf[s]) if hf is not None else r.kv_blocks
        return max(head, 0)

    def _fcfs_sort(self, reqs: list[Request], grants) -> None:
        """Sort admitted requests into wrap-safe admission order: signed
        ticket distance from the tenant's grant frontier (``grants``, read
        once a round), tenant name tiebreak."""
        reqs.sort(key=lambda r: (_tdist(
            r.ticket, int(grants[self._tindex[r.tenant_id]])), r.tenant_id))

    def _expire_req(self, r: Request, tidx: int) -> None:
        r.expired = True
        pre_rnd = r.expire_round  # a megastep drain pre-stamps its round
        r.expire_round = self._round_no
        self.stats.expired += 1
        self.tenant_expired[self._tenant_names[tidx]] += 1
        r.finish_t = time.time()
        if r.finish_clock is None:  # megastep drains pre-stamp it
            r.finish_clock = self._clock()
        # backlog expiry is resolved on the host on both paths, so its
        # trace terminal is a host event, never an in-round one
        self._trace.add(EV_EXPIRE, r.rid, -1, 0, r.finish_clock,
                        pre_rnd if pre_rnd >= 0 else r.expire_round)
        self._obs_done(r)
        r.done_event.set()

    def _expire_due_qos(self) -> None:
        """Queue walk: tombstone backlog entries whose deadline passed
        (the deadline heap); the next live same-tenant waiter is flagged
        so the dead ticket never blocks it, and the stranded credit is
        re-granted."""
        now = self._clock()
        dead_bump = np.zeros(len(self._tenant_names), np.int64)
        while self._deadline_heap and self._deadline_heap[0][0] <= now:
            _, _, r = heapq.heappop(self._deadline_heap)
            if r.expired or r.slot is not None or r.done_event.is_set():
                continue  # admitted or already resolved
            tidx = self._tindex[r.tenant_id]
            self._expire_req(r, tidx)
            self._tenant_live[tidx] -= 1
            dead_bump[tidx] += 1
            for nxt in self._tenant_queues[tidx]:
                if not nxt.expired:  # the successor inherits the wake
                    nxt.fast = True
                    break
        if dead_bump.any():
            self.qos = self.qos._replace(
                dead=u32.add(self.qos.dead, self._up(dead_bump)))
            self._replenish_qos(0)

    def _admit_ready_qos_kernel(self):
        """The fused admission round (``use_kernel=True``): expire,
        weighted replenish, tombstone-transparent FCFS admit and reclaim
        over the whole live backlog as ONE `kernels.ops.qos_round` call —
        one launch of the CUDA kernel on the card, its plain version on
        the CPU.  Its masks, leftover and post-round grants come back in
        one transfer.  Returns ``(admitted, grants)``."""
        from ..kernels import ops

        rows = [r for q in self._tenant_queues for r in q if not r.expired]
        if not rows:
            return [], None
        now = self._clock()
        ids = np.asarray([self._tindex[r.tenant_id] for r in rows], np.int32)
        tks = np.asarray([r.ticket for r in rows], np.int64)
        # relative deadlines: see _submit_qos on float32 precision
        dls = np.asarray([np.inf if r.deadline is None else r.deadline - now
                          for r in rows], np.float32)
        state, admitted, expired, leftover = ops.qos_round(
            self.qos, self._up(ids), self._up(tks),
            torch.ones(len(rows), dtype=torch.bool, device=self.device),
            self._up(dls), 0.0, self._qos_free, max_units=self.n_slots)
        self.qos = state
        admitted, expired, leftover, grants = drain(
            (admitted, expired, leftover, state.grant))
        self._qos_free = int(leftover)
        self.stats.backlog_scans += len(rows)
        admitted = admitted.copy()
        if self._kv_pool is not None and admitted.any():
            # multi-resource gate: block-stalled rows lose their grant and
            # refund the tenant's slot credit (they stay queued and retry
            # next round, as the device round does via `block_gate`)
            cidx = np.flatnonzero(admitted)
            _, stalled = self._kv_gate(
                [(rows[i], int(ids[i])) for i in cidx], grants)
            if stalled:
                bump = np.zeros(len(self._tenant_names), np.int64)
                for i in stalled:
                    admitted[cidx[i]] = False
                    bump[ids[cidx[i]]] += 1
                    rows[cidx[i]].fast = True  # retry while blocks drain
                self.qos = self.qos._replace(
                    consumed=u32.sub(self.qos.consumed, self._up(bump)))
        out: list[Request] = []
        for r, i, a, e in zip(rows, ids, admitted, expired):
            if e:
                self._expire_req(r, int(i))
                self._tenant_live[int(i)] -= 1
            elif a:
                self._tenant_live[int(i)] -= 1
                self.tenant_admitted[r.tenant_id] += 1
                out.append(r)
        if admitted.any() or expired.any():
            gone = {id(r) for r, a, e in zip(rows, admitted, expired)
                    if a or e}
            for tidx, q in enumerate(self._tenant_queues):
                self._tenant_queues[tidx] = deque(
                    r for r in q if id(r) not in gone)
        self._fcfs_sort(out, grants)
        return out, grants

    def _admit_ready_qos(self):
        """Weighted-FCFS admission.  The queue walk re-examines a tenant
        queue only when its head's bucket was poked by a replenish (or it
        was flagged by an arrival or expiry) — the TWA gating at tenant
        granularity.  Returns ``(admitted, grants)``."""
        if self._use_kernel:
            return self._admit_ready_qos_kernel()
        self._expire_due_qos()
        grants, consumed, seq = drain(
            (self.qos.grant, self.qos.consumed, self.qos.bucket_seq))
        # wrap-safe spendable credit (functional_qos.avail)
        avail = _sdist(grants, consumed)
        admitted: list[Request] = []
        spent = np.zeros(len(self._tenant_names), np.int64)
        for tidx, q in enumerate(self._tenant_queues):
            while q and q[0].expired:
                q.popleft()  # lazy removal of tombstoned heads
            if not q:
                continue
            head = q[0]
            if not (head.fast or seq[head.bucket] != head.observed_seq):
                self.stats.backlog_skipped += sum(not r.expired for r in q)
                continue
            head.fast = False
            head.observed_seq = int(seq[head.bucket])
            while q and avail[tidx] - int(spent[tidx]) > 0:
                r = q.popleft()
                if r.expired:
                    continue
                spent[tidx] += 1
                self._tenant_live[tidx] -= 1
                self.tenant_admitted[r.tenant_id] += 1
                admitted.append(r)
            # examined = the head + each admitted row; the rest of the
            # queue was never touched (the TWA skip)
            at_head = 1 if q and q[0] is head else 0
            self.stats.backlog_scans += int(spent[tidx]) + at_head
            self.stats.backlog_skipped += sum(not r.expired for r in q) \
                - at_head
        if spent.any():
            self.qos = self.qos._replace(
                consumed=u32.add(self.qos.consumed, self._up(spent)))
        if self._kv_pool is not None and admitted:
            # multi-resource gate: roll the block-stalled suffix back onto
            # the queue heads (per tenant a contiguous FIFO suffix), refund
            # their slot credit and flag them for re-examination
            cands = [(r, self._tindex[r.tenant_id]) for r in admitted]
            _, stalled = self._kv_gate(cands, grants)
            if stalled:
                unbump = np.zeros(len(self._tenant_names), np.int64)
                by_tenant: dict[int, list[Request]] = {}
                for i in stalled:
                    r, tidx = cands[i]
                    by_tenant.setdefault(tidx, []).append(r)
                for tidx, rs in by_tenant.items():
                    for r in reversed(rs):  # gate order = ticket order
                        self._tenant_queues[tidx].appendleft(r)
                        self._tenant_live[tidx] += 1
                        self.tenant_admitted[r.tenant_id] -= 1
                        unbump[tidx] += 1
                        r.fast = True
                self.qos = self.qos._replace(
                    consumed=u32.sub(self.qos.consumed, self._up(unbump)))
                stall_ids = {id(cands[i][0]) for i in stalled}
                admitted = [r for r in admitted if id(r) not in stall_ids]
        self._fcfs_sort(admitted, grants)
        return admitted, grants

    def _replenish_qos(self, freed: int) -> None:
        """Slot(s) freed: reclaim stranded credit, then distribute the pool
        to tenants with unmet live demand by stride scheduling, poking the
        enabled ticket windows.  The replenish is skipped when the pool is
        empty (selected on the device, so the call reads back once).  With
        ``use_kernel`` the kernel round replenishes; the freed units only
        bank for the next round."""
        if self._use_kernel:
            self._qos_free += freed
            return
        depths = self._up(self._tenant_live.astype(np.int32))
        qos, reclaimed = qos_reclaim(self.qos, depths)
        free = reclaimed + (self._qos_free + freed)
        rep, alloc, leftover = qos_replenish(qos, free, depths, self.n_slots)
        go = free > 0
        self.qos = _select(go, rep, qos)
        left, alloc = drain((torch.where(go, leftover, free),
                             torch.where(go, alloc, 0)))
        self._qos_free = int(left)
        # the exact host wake on top of the bucket pokes: flag each
        # replenished tenant's live head
        for tidx in np.flatnonzero(alloc):
            for r in self._tenant_queues[tidx]:
                if not r.expired:
                    r.fast = True
                    break

    # ------------------------------------------------------ host step() ----

    def _admit_ready(self):
        """Admitted requests in FCFS order and the grant(s) they were
        admitted against: per tenant in QoS mode (`_admit_ready_qos`),
        else the free-slot semaphore's (the u32 value).

        Single-tenant: only requests whose bucket moved since they last
        looked (`woken_mask`), or that were admitted at take time
        (``fast``), are re-examined; the woken mask, the buckets'
        sequences and the grant come back in ONE transfer.  The admit
        test keeps the reference's plain ``ticket < grant`` conjunct: a
        ticket issued just below the 2³² wrap is never admitted once the
        grant has wrapped (a reference fault, ROADMAP queue 3, reproduced
        bit for bit)."""
        if self._tenants is not None:
            return self._admit_ready_qos()
        if not self.backlog:
            return [], 0
        dev = self.device
        buckets = torch.tensor([r.bucket for r in self.backlog],
                               dtype=torch.int32, device=dev)
        observed = u32.u32(np.asarray([r.observed_seq for r in self.backlog],
                                      np.int64), device=dev)
        woken, seq_at, grant = drain((
            woken_mask(self.sema, observed, buckets),
            self.sema.bucket_seq[buckets.to(torch.int64)], self.sema.grant))
        grant = int(grant)
        admitted, still = [], []
        for r, w, sq in zip(self.backlog, woken, seq_at):
            if not (w or r.fast):
                # bucket untouched ⇒ the grant cannot have reached this
                # ticket (hash aliasing only adds checks)
                self.stats.backlog_skipped += 1
                still.append(r)
                continue
            self.stats.backlog_scans += 1
            r.observed_seq = int(sq)
            if (grant - r.ticket) % (1 << 32) < (1 << 31) and r.ticket < grant:
                admitted.append(r)
            else:
                still.append(r)
        admitted.sort(key=lambda r: r.ticket)  # FCFS: ticket order
        self.backlog = still
        return admitted, grant

    def _retire(self, slots: list[int], reason: str) -> None:
        """Retire the slots of one phase (preemption or completion) and
        post their blocks in ONE batched release, as the device round
        does: under sharing one decref of their table rows on the replica,
        else one post of the blocks they hold (chunked: the blocks taken;
        up-front: the worst-case reservations) to the block-semaphore
        mirror.  Per-slot posts would poke other waiting-array buckets
        once a phase frees more blocks than the array has entries (a post
        pokes at most that many tickets)."""
        if self._kv_share:
            self._hshare_release(slots)
            for slot in slots:
                self.active[slot].kv_blocks = 0
        freed = sum([self._finish(slot, reason) for slot in slots])
        if freed:
            self._kv_free_blocks += freed
            self._kv_sema = post_batch(self._kv_sema, freed)

    def _finish(self, slot: int, reason: str) -> int:
        """Retire a slot; returns the pool blocks it held, for the
        caller's batched post (`_retire`).  ``reason == "deadline"`` is
        decode preemption (tombstoned, not completed).  The freed slot
        re-enters the QoS replenish, or posts one unit to the
        single-tenant semaphore."""
        req = self.active.pop(slot)
        req.finish_t = time.time()
        req.finish_clock = self._now_r
        self.free_slots.append(slot)
        if reason == "deadline":
            req.expired = True
            req.preempted = True
            req.expire_round = self._round_no
            self.stats.preempted += 1
            self.stats.expired += 1
            if self._tenants is not None:
                self.tenant_expired[req.tenant_id] += 1
        else:
            self.stats.finished += 1
        freed = 0
        if self._kv_pool is not None:
            freed = req.kv_blocks if self._chunk else self._kv_demand(req)
            req.kv_blocks = 0
            req.parked = False
        if self._tenants is not None:
            self._replenish_qos(1)
        else:
            self.sema = post_batch(self.sema, 1)
            self._sema_grant_h += 1
        self.stats.wakeups += 1
        self._obs_done(req)
        req.done_event.set()
        self._client_sem.post()
        return freed

    def _preempt_expired(self) -> None:
        """Deadline-aware decode preemption: a running sequence whose
        deadline passed is tombstoned and its slot freed before this
        step's admission, in ascending slot order (the event order), so
        the freed unit feeds this round's replenish."""
        now = self._clock()
        due = sorted(slot for slot, req in self.active.items()
                     if req.deadline is not None and req.deadline <= now)
        for slot in due:
            r = self.active[slot]
            self._ev_preempt.append(
                [EV_PREEMPT, r.rid, slot, len(r.out_tokens)])
        self._retire(due, "deadline")

    def step(self, sample_fn: Callable[[np.ndarray], np.ndarray]) -> int:
        """One engine iteration: preempt expired → admit → prefill the
        admitted (``prefill_fn``; chunked engines stream prompts through
        the chunk phase instead) → decode the decode-ready rows
        (``step_fn``) → sample on the host (``sample_fn`` over numpy
        logits) → retire the finished.  Returns the number of active
        rows."""
        if self._kv_pool is not None and self._kv_state is not None:
            # the device pool tracks reservations the host cannot see: a
            # host admission would double-book blocks
            raise RuntimeError(
                "paged engine is decoding via megastep; host step() would "
                "desync the device block pool (serve a kv_pool engine "
                "through ONE of the two paths)")
        with self._lock:
            rnd = self._round_no
            self.stats.host_syncs += 1  # ONE nominal sync per step
            now_r = self._now_r = self._clock()
            self._round_gate_stalls = 0
            self._ev_preempt, self._ev_admit, self._ev_attach = [], [], []
            self._ev_park, self._ev_resume, self._ev_chunk = [], [], []
            self._ev_cow, self._ev_finish = [], []
            self._round_prefill_tokens = 0
            self._round_prefill_chunks = 0
            self._round_prefix_hits = 0
            self._round_cow_copies = 0
            self._round_nonfinite = False
            a0, e0, p0 = (self.stats.admitted, self.stats.expired,
                          self.stats.preempted)
            self._preempt_expired()
            admitted, grants = self._admit_ready()
            if admitted:
                # the device `_assign_slots` in every mode: admits in
                # packed-FCFS-key order take ascending free slots (under
                # sharing this fixes block identities; elsewhere the ADMIT
                # events' slot column)
                qos = self._tenants is not None
                for r in admitted:
                    tidx = self._tindex[r.tenant_id] if qos else 0
                    r.prio_key = _prio_key(
                        r.ticket, int(grants[tidx]) if qos else grants, tidx)
                admitted = sorted(admitted, key=lambda r: r.prio_key)
                self.free_slots.sort(reverse=True)
            attach_ids, attached = [], False
            for req in admitted:
                slot = self.free_slots.pop()
                req.slot = slot
                req.admit_t = time.time()
                req.admit_round = rnd
                req.last_adv_round = rnd  # assignment arms the watchdog
                self.active[slot] = req
                self.stats.admitted += 1
                self._ev_admit.append(
                    [EV_ADMIT, req.rid, slot,
                     min(len(req.prompt), self._prompt_cap) or 1])
                if not self._chunk:
                    self.prefill_fn(req)  # the owner fills the row's cache
                    continue
                # chunked: the chunk phase streams the prompt in;
                # prefill_fn fires on the round the last chunk lands
                req.prefill_pos = 0
                req.kv_blocks = 0
                if self._kv_share and req.share is not None:
                    # attach the gate's cache hit: seed the shared ids into
                    # the slot's table row and incref each (no counter
                    # move, no poke — the device round's phase 3a); the
                    # cursor resumes at the divergence point
                    c_i, bids_i, tail_i, cov_i = req.share
                    req.share = None
                    ids = [int(b) for b in bids_i[:c_i]]
                    if tail_i >= 0:
                        ids.append(tail_i)
                    ids = ids[:self._kv_mb]
                    if ids:
                        self._kv_htbl[slot, :len(ids)] = torch.tensor(
                            ids, dtype=torch.int32)
                        attach_ids += ids
                        attached = True
                    req.prefill_pos = cov_i
                    req.kv_blocks = len(ids)
                    if cov_i > 0:
                        self._ev_attach.append(
                            [EV_PREFIX_ATTACH, req.rid, slot, cov_i])
                    pl = min(len(req.prompt), self._prompt_cap) or 1
                    if cov_i >= pl:  # fully covered: decode-ready now
                        self._round_prefix_hits += 1
            if attached:
                # the increfs commute: one batched call for the round
                ids_t = torch.tensor(attach_ids, dtype=torch.int32,
                                     device=self.device)
                self._kv_hpool = pool_incref(
                    self._kv_hpool, ids_t,
                    torch.ones_like(ids_t, dtype=torch.bool))
                self._hshare_sync()

            if not self.active:
                self._round_no = rnd + 1
                self._record_round(self._host_sample(rnd, now_r, a0, e0,
                                                     p0, 0))
                return 0
            self.stats.steps += 1
            if self._chunk:
                decode = [(int(s), self.active[int(s)])
                          for s in self._chunk_step()]
            else:
                decode = list(self.active.items())
            if decode:
                logits = self.step_fn([r for _, r in decode])
                if (isinstance(logits, np.ndarray)
                        and logits.dtype.kind == "f"
                        and not np.all(np.isfinite(logits))):
                    self._round_nonfinite = True  # H_NAN sentinel input
                next_tokens = sample_fn(logits)
                done_slots = []
                for (slot, req), tok in zip(decode, next_tokens):
                    req.out_tokens.append(int(tok))
                    req.last_adv_round = rnd  # progress re-arms watchdog
                    if req.first_tok_clock is None:
                        req.first_tok_clock = now_r
                    req.last_tok_clock = now_r
                    if len(req.out_tokens) >= req.max_new_tokens:
                        done_slots.append(slot)
                for slot in sorted(done_slots):  # lane-ascending events
                    r = self.active[slot]
                    self._ev_finish.append(
                        [EV_FINISH, r.rid, slot, len(r.out_tokens)])
                self._retire(done_slots, "length")
            self.stats.prefix_hits += self._round_prefix_hits
            self.stats.cow_copies += self._round_cow_copies
            self._round_no = rnd + 1
            self._record_round(self._host_sample(rnd, now_r, a0, e0, p0,
                                                 len(decode)))
            return len(self.active)

    def _chunk_step(self) -> np.ndarray:
        """The host chunk phase — ONE call into the device round's planner
        (`prefill.chunk_plan` over `prefill.banker_order`) on the host's
        per-request state: split the prefill token budget, take blocks
        from the block-semaphore mirror (under sharing from the replica,
        through `pool_try_alloc`, with copy-on-write), park the
        block-stalled slots on its waiting array, and return the
        decode-ready slots.  The plan comes back in one transfer."""
        S = self.n_slots
        sharing = self._kv_share
        up = self._up
        busy = np.zeros(S, bool)
        parked = np.zeros(S, bool)
        woken = np.zeros(S, bool)
        pos = np.zeros(S, np.int32)
        plen = np.zeros(S, np.int32)
        mxn = np.zeros(S, np.int32)
        held = np.zeros(S, np.int32)
        prio_r = np.zeros(S, np.int32)
        prio_k = np.zeros(S, np.int32)
        rem = np.zeros(S, np.int32)
        rids = np.full(S, -1, np.int32)
        seq = drain(self._kv_sema.bucket_seq)
        for s, r in self.active.items():
            pl = min(len(r.prompt), self._prompt_cap) or 1
            rids[s] = r.rid
            busy[s] = True
            parked[s] = r.parked
            woken[s] = r.parked and seq[r.park_bucket] != r.park_seq
            pos[s] = (r.prefill_pos if r.prefill_pos < pl
                      else pl + len(r.out_tokens))
            plen[s] = pl
            mxn[s] = r.max_new_tokens
            held[s] = r.kv_blocks
            rem[s] = self._kv_rem(r)
            prio_r[s] = r.admit_round
            prio_k[s] = r.prio_key
        if sharing:
            cow_a, held_free = self._kv_share_state()
            rem = rem + cow_a.astype(np.int32)  # a pending COW owes 1 more
        else:
            cow_a, held_free = np.zeros(S, bool), held
        plan = chunk_plan(
            banker_order(up(rem), up(prio_r), up(prio_k), up(busy)),
            up(busy), up(parked), up(woken), up(pos), up(plen), up(mxn),
            up(held), self._kv_free_blocks, up(cow_a), up(held_free),
            chunk=self._chunk, budget=self._budget, block_size=self._kv_bs)
        newly_t = plan.parked & (plan.deficit > 0)
        if sharing:
            # the replica takes the granted blocks through the device
            # round's `pool_try_alloc`, scatters the fresh ids into the
            # table (a COW grant REPLACES the shared tail at column
            # held−1) and decrefs the replaced ids in ONE batched release
            max_take = -(-self._chunk // self._kv_bs) + 1
            hp, ids, bkt_t, sq_t = pool_try_alloc(
                self._kv_hpool, plan.take, max_take, park=newly_t,
                deficit=plan.deficit)
            held_t = up(held)
            rows_i = torch.arange(S, device=self.device)
            old_t = self._kv_htbl[rows_i, torch.clamp(
                held_t - 1, 0, self._kv_mb - 1).to(torch.int64)]
            k = torch.arange(max_take, dtype=torch.int32, device=self.device)
            tbl = _set_cells(
                self._kv_htbl, rows_i[:, None],
                torch.where(plan.cow, held_t - 1, held_t)[:, None]
                + k[None, :], ids, k[None, :] < plan.take[:, None])
        else:
            bkt_t, sq_t = park_state(
                self._kv_sema, torch.clamp(plan.deficit, min=1))
            old_t = torch.full((S,), -1, dtype=torch.int32,
                               device=self.device)
        (take, tokens, parked_o, deficit, emit, cow_g, old, bkt,
         sq) = drain((plan.take, plan.tokens, plan.parked, plan.deficit,
                      plan.emit, plan.cow, old_t, bkt_t, sq_t))
        newly = parked_o & (deficit > 0)
        # trace events — PARK/RESUME on park-state transitions, one
        # PREFILL_CHUNK per slot that landed tokens, lane-ascending (the
        # device `_chunk_phase` folds the same masks into its table)
        for s in np.flatnonzero(parked_o & ~parked):
            self._ev_park.append([EV_PARK, int(rids[s]), int(s),
                                  int(deficit[s])])
        for s in np.flatnonzero(parked & ~parked_o):
            self._ev_resume.append([EV_RESUME, int(rids[s]), int(s), 0])
        for s in np.flatnonzero(tokens > 0):
            self._ev_chunk.append([EV_PREFILL_CHUNK, int(rids[s]), int(s),
                                   int(tokens[s])])
        if sharing:
            for s in np.flatnonzero(cow_g):  # arg = the replaced block id
                self._ev_cow.append([EV_COW, int(rids[s]), int(s),
                                     int(old[s])])
            if cow_g.any():
                hp = pool_release(hp, old_t, plan.cow)
            self._kv_hpool, self._kv_htbl = hp, tbl
            self._hshare_sync()
            self._round_cow_copies = int(cow_g.sum())
        else:
            total = int(take.sum())
            self._kv_free_blocks -= total
            self._kv_sema = self._kv_sema._replace(
                ticket=u32.add(self._kv_sema.ticket, total))
        for s, r in self.active.items():
            pl = int(plen[s])
            if sharing:
                r.kv_blocks = int(self._kv_held_h[s])
            else:
                r.kv_blocks += int(take[s])
            r.parked = bool(parked_o[s])
            if newly[s]:
                r.park_bucket = int(bkt[s])
                r.park_seq = int(sq[s])
            if tokens[s]:
                r.prefill_pos += int(tokens[s])
                r.last_adv_round = self._round_no  # chunk landed: progress
                if r.prefill_pos >= pl:
                    self.prefill_fn(r)  # last chunk landed: full KV ready
        if sharing:
            # publish prefixes at prefill completion — the device round's
            # phase 4b, against the post-take post-COW pool and table
            comp = busy & (pos < plen) & (pos + tokens >= plen)
            if comp.any():
                sph = np.zeros((S, 2, self._hash_w + 1), np.uint32)
                for s, r in self.active.items():
                    sph[s] = np.asarray(r.ph, np.uint32)
                self._kv_cache = cache_register(
                    self._kv_cache, self._kv_hpool,
                    u32.u32(sph, device=self.device), up(plen),
                    self._kv_htbl, up(comp), self._kv_bs)
        self.stats.prefill_chunks += int((tokens > 0).sum())
        self.stats.kv_block_stalls += int(parked_o.sum())
        self._round_prefill_tokens = int(tokens.sum())
        self._round_prefill_chunks = int((tokens > 0).sum())
        return np.flatnonzero(emit)

    # --------------------------------------------------------- megastep ----

    def megastep(self, K: int, *, token_fn=None, admit_fn=None,
                 nows=None, admit_impl="auto") -> int:
        """K engine rounds on the device (`engine_state.megastep_scan`)
        drained in ONE host sync.  Each round: deadline preemption → QoS
        admission (freed units feed the same round) → block gate (paged) →
        FCFS slot assignment → ``token_fn`` decode + sample → completion.
        Round-for-round identical to K ``step()`` calls.

        ``token_fn(model, EngineState) -> (tokens (S,) i32, model')`` and
        the prefill hook ``admit_fn(model, state, rows, mask, slots) ->
        model'`` run on the device; the model lives in
        ``self.megastep_model``.  ``nows``: optional (K,) timestamps
        relative to launch (default all 0.0).  ``admit_impl``: ``"auto"``
        routes admission through `engine_state.fused_round_impl` (the CUDA
        kernel on the card, its plain version on the CPU) when
        ``use_kernel``, else the functional round; or pass an
        implementation.  A paged engine's device pool persists across
        launches; the first launch of a sharing engine adopts the host
        replica, and every launch writes the pool back to it.  Returns the
        number of busy slots after the last round."""
        if self._tenants is None:
            raise ValueError("megastep requires QoS mode (tenants=...)")
        if K < 1:
            raise ValueError("megastep needs K >= 1")
        token_fn = token_fn or zero_token_fn
        window = getattr(token_fn, "_chunk_window", None)
        if self._chunk and window is not None and window < self._chunk:
            # a narrower chunk window than the engine's chunk would drop
            # the tail of every scheduled chunk (pos still advances)
            raise ValueError(
                f"token_fn chunk window ({window}) is smaller than the "
                f"engine's chunk size ({self._chunk}); build it with "
                f"make_chunked_prefill_token_fn({self._chunk})")
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
            if paged and self._kv_state is None and self.active:
                # slots admitted by host step() have no device block
                # tables: their KV does not exist in the pool
                raise RuntimeError(
                    "paged engine has host-admitted active slots; serve a "
                    "kv_pool engine exclusively via megastep")
            chunked = self._chunk > 0
            sharing = self._kv_share
            fresh_kv = paged and self._kv_state is None
            state = make_engine_state(
                self.qos, S, B, P, free_units=self._qos_free,
                kv_blocks=self._kv_blocks if fresh_kv and not sharing else 0,
                kv_slot_blocks=self._kv_mb if fresh_kv and not sharing
                else 0,
                ring_cap=_next_pow2(K), device=dev)
            if paged and not fresh_kv:
                state = state._replace(kv=self._kv_state)
            elif paged and sharing:
                # the first sharing launch ADOPTS the host replica: pool
                # generations and cache entries of earlier host rounds
                # stay authoritative
                state = state._replace(kv=KVPool(
                    pool=self._kv_hpool, tbl=self._kv_htbl,
                    cache=self._kv_cache))
            valid = np.zeros(B, bool)
            ids = np.zeros(B, np.int32)
            tks = np.zeros(B, np.int64)
            dls = np.full(B, np.inf, np.float32)
            rid = np.full(B, -1, np.int32)
            mx = np.zeros(B, np.int32)
            pl = np.zeros(B, np.int32)
            pr = np.zeros((B, P), np.int32)
            if sharing:
                bph = np.zeros((B, 2, self._hash_w + 1), np.uint32)
                sph = np.zeros((S, 2, self._hash_w + 1), np.uint32)
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
                if sharing:
                    bph[i] = r.ph
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
            sprm = np.zeros((S, P), np.int32)
            spri_r = np.zeros(S, np.int32)
            spri_k = np.zeros(S, np.int32)
            sprk = np.zeros(S, bool)
            spb = np.zeros(S, np.int32)
            sps = np.zeros(S, np.int64)
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
                if chunked:
                    # mid-prefill slots resume at their chunk cursor, with
                    # the prompt (its backlog row was recycled) and their
                    # Banker priority and park state
                    spos[slot] = (r.prefill_pos if r.prefill_pos < plen_t
                                  else plen_t + len(r.out_tokens))
                    p = r.prompt[-P:] if r.prompt else [0]
                    sprm[slot, :len(p)] = p
                    spri_r[slot] = r.admit_round
                    spri_k[slot] = r.prio_key
                    sprk[slot] = r.parked
                    spb[slot] = r.park_bucket
                    sps[slot] = r.park_seq
                    if sharing:
                        sph[slot] = r.ph
                else:
                    spos[slot] = plen_t + len(r.out_tokens)

            up = self._up
            share_bl = {"ph": u32.u32(bph, device=dev)} if sharing else {}
            share_sl = ({"ph": u32.u32(sph, device=dev),
                         "cow_src": torch.full((S,), -1, dtype=torch.int32,
                                               device=dev)}
                        if sharing else {})
            state = state._replace(
                round_no=torch.full((), base, dtype=torch.int32, device=dev),
                stalls=torch.full((), self.stats.kv_block_stalls,
                                  dtype=torch.int32, device=dev),
                chunks=torch.full((), self.stats.prefill_chunks,
                                  dtype=torch.int32, device=dev),
                backlog=state.backlog._replace(
                    valid=up(valid), tenant=up(ids), ticket=up(tks),
                    deadline=up(dls), rid=up(rid), max_new=up(mx),
                    prompt=up(pr), prompt_len=up(pl), **share_bl),
                slots=Slots(
                    busy=up(sb), row=up(srow), rid=up(srid), tenant=up(sten),
                    deadline=up(sdl), max_new=up(smx), emitted=up(sem),
                    token=up(stok), pos=up(spos), plen=up(spl),
                    prompt=up(sprm), prio_r=up(spri_r), prio_k=up(spri_k),
                    parked=up(sprk), park_bucket=up(spb), park_seq=up(sps),
                    chunk=torch.zeros(S, dtype=torch.int32, device=dev),
                    last_adv=up(sladv), **share_sl),
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
                block_size=self._kv_bs if paged else 0, chunk=self._chunk,
                budget=self._budget, commit=self._kv_commit,
                watchdog=self._watchdog)
            self.megastep_model = model

            # ---- the ONE host sync: drain every round's outputs --------
            kv_h = ()
            if paged:
                kv_h = (st.kv.pool.sema.grant, st.kv.pool.sema.ticket,
                        st.kv.pool.refcnt, st.kv.tbl)
            sl_ch = ((st.slots.pos, st.slots.prio_k, st.slots.parked,
                      st.slots.park_bucket, st.slots.park_seq, st.stalls,
                      st.chunks) if chunked else ())
            bl_h, sl_h, free_h, kv_h, ch_h, ring_h, ys_h = drain((
                (st.backlog.admit_round, st.backlog.expire_round,
                 st.backlog.slot),
                (st.slots.busy, st.slots.row, st.slots.last_adv),
                st.free, kv_h, sl_ch, st.ring, ys))
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
                    # stamp the in-round expiry round and clock before
                    # _expire_req, so its trace event carries them
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
                    self._obs_done(r)
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
                    self._obs_done(r)
                    r.done_event.set()
                    self._client_sem.post()
            self.stats.steps += int((ys_h.n_active > 0).sum())
            self.stats.backlog_scans += int(ys_h.n_live.sum())

            # drop resolved entries from the queue walk's expiry heap
            # (only step() pops it: a megastep-only engine would keep
            # every deadline request forever)
            if self._deadline_heap:
                self._deadline_heap = [
                    e for e in self._deadline_heap
                    if not (e[2].expired or e[2].slot is not None
                            or e[2].done_event.is_set())]
                heapq.heapify(self._deadline_heap)

            self.active = {int(s): req_of(int(row_h[s]))
                           for s in np.flatnonzero(busy_h)}
            self.free_slots = [s for s in range(S) if not busy_h[s]]
            for s, r in self.active.items():
                r.last_adv_round = int(ladv_h[s])
            self._qos_free = int(free_h)
            self.qos = st.qos  # stays on the device
            if paged:
                self._kv_state = st.kv
                grant, ticket, refcnt_h, tbl_h = kv_h
                self._kv_free_blocks = int(np.int64(grant - ticket)
                                           .astype(np.int32))
                # the block-semaphore mirror follows the device pool in
                # both paged modes
                self._kv_sema = st.kv.pool.sema
                if sharing:
                    # the replica ← the post-scan pool, cache and table
                    self._kv_hpool = st.kv.pool
                    self._kv_cache = st.kv.cache
                    self._kv_htbl = st.kv.tbl
                    self._kv_refcnt_h = refcnt_h
                    self._kv_held_h = (tbl_h >= 0).sum(1).astype(np.int32)
            if chunked:
                # each still-running request's prefill and park state rides
                # to the next launch (the pool itself persists in _kv_state)
                pos_h, prio_h, park_h, pbkt_h, pseq_h, stalls_h, chunks_h = \
                    ch_h
                for s, r in self.active.items():
                    r.prefill_pos = int(pos_h[s])
                    r.prio_key = int(prio_h[s])
                    r.parked = bool(park_h[s])
                    r.park_bucket = int(pbkt_h[s])
                    r.park_seq = int(pseq_h[s])
                    r.kv_blocks = int((tbl_h[s] >= 0).sum())
                self.stats.kv_block_stalls = int(stalls_h)
                self.stats.prefill_chunks = int(chunks_h)
            # the telemetry ring rode the same transfer: observability
            # adds no host sync
            self._last_samples = ring_samples(ring_h, t0=t0)
            for smp in self._last_samples:
                self._trace.ingest_sample(smp)
            if sharing:
                self.stats.prefix_hits += sum(
                    s["prefix_hits"] for s in self._last_samples)
                self.stats.cow_copies += sum(
                    s["cow_copies"] for s in self._last_samples)
            if self._obs is not None:
                for smp in self._last_samples:
                    self._obs.record_round(smp)
            self._round_no = base + K
            return int(busy_h.sum())

    # ---------------------------------------------------------- telemetry ---

    def _obs_done(self, r: Request) -> None:
        """Feed a resolved request (finished, tombstoned or preempted) to
        the attached obs layer (`obs.EngineObs.record_request`)."""
        if self._obs is not None:
            self._obs.record_request(r)

    def _record_round(self, sample: dict) -> None:
        self._last_samples = [sample]
        self._trace.ingest_sample(sample)
        if self._obs is not None:
            self._obs.record_round(sample)

    def _host_sample(self, rnd: int, now_r: float, a0: int, e0: int,
                     p0: int, n_tok: int) -> dict:
        """The host ``step()`` round's telemetry sample — the record (keys
        and values) `engine_state.ring_samples` drains from a megastep's
        ring, mirrored from the host bookkeeping; the device values it
        needs (tenant credit and poke slack, the block semaphore's pokes)
        come back in one transfer."""
        qos = self._tenants is not None
        paged = self._kv_pool is not None
        dev_vals = ((self.qos.grant, self.qos.consumed, self.qos.dead)
                    if qos else ())
        if paged:
            dev_vals += (self._kv_sema.bucket_seq,)
        dev_vals = drain(dev_vals)
        if qos:
            grant, consumed, dead = dev_vals[:3]
            credit = _sdist(grant, consumed)
            backlog = int(self._tenant_live.sum())
        else:
            credit = dead = np.zeros(0, np.int64)
            backlog = len(self.backlog)
        hist = np.zeros(SLOT_TABLE, np.int64)
        parked = pending = 0
        for r in self.active.values():
            if r.parked:
                parked += 1
                hist[r.park_bucket] += 1
            if self._chunk:
                plen = min(len(r.prompt), self._prompt_cap) or 1
                pending += max(plen - r.prefill_pos, 0)
        # the health bitmask — the host mirror of the device round's
        # sentinel checks (`sentinels.round_health`)
        if self._chunk:
            if self._kv_share:
                # shared blocks are held once: the refcount support
                kv_held = int((self._kv_refcnt_h > 0).sum())
            else:
                kv_held = sum(r.kv_blocks for r in self.active.values())
        elif paged:
            kv_held = sum(self._kv_demand(r) for r in self.active.values())
        else:
            kv_held = 0
        health = host_round_health(
            n_slots=self.n_slots, free_slots=len(self.free_slots),
            active=len(self.active), credit=credit, paged=paged,
            kv_free=int(self._kv_free_blocks) if paged else 0,
            kv_held=kv_held,
            kv_blocks=self._kv_blocks if paged else 0,
            chunked=self._chunk > 0,
            headroom=self._kv_headroom() if self._chunk else 0,
            stuck=(self._watchdog > 0 and any(
                rnd - r.last_adv_round >= self._watchdog
                for r in self.active.values())),
            nonfinite=self._round_nonfinite)
        return {
            "round": rnd,
            "clock": float(now_r),
            "admits": self.stats.admitted - a0,
            "expires": (self.stats.expired - e0)
            - (self.stats.preempted - p0),
            "preempts": self.stats.preempted - p0,
            "tokens": n_tok,
            "prefill_tokens": self._round_prefill_tokens,
            "prefill_chunks": self._round_prefill_chunks,
            "prefill_pending": pending,
            "gate_stalls": self._round_gate_stalls,
            "parked": parked,
            "backlog": backlog,
            "active": len(self.active),
            "slot_free": len(self.free_slots),
            "kv_free": int(self._kv_free_blocks) if paged else 0,
            "kv_pokes": (int(dev_vals[-1].sum()) & u32.MASK32 if paged
                         else 0),
            "prefix_hits": self._round_prefix_hits,
            "blocks_shared": (int((self._kv_refcnt_h >= 2).sum())
                              if self._kv_share else 0),
            "cow_copies": self._round_cow_copies,
            "health": int(health),
            "credit": [int(c) for c in credit],
            "poke_dead": [int(d) for d in dead],
            "kv_wait_hist": [int(h) for h in hist],
            # the event rows in the canonical segment order
            # (events.SCAN_SEGMENTS) — the list the device table drains
            "events": (self._ev_preempt + self._ev_admit
                       + self._ev_attach + self._ev_park + self._ev_resume
                       + self._ev_chunk + self._ev_cow + self._ev_finish),
        }

    def telemetry(self) -> dict:
        """Gauge snapshot of the engine — pure host-side reads (no device
        transfer, no ``host_syncs`` bump).  ``last_samples`` holds the
        one sample of the last ``step()`` or the K per-round samples of the
        last ``megastep(K)``; ``trace`` the span summary of the trace
        buffer (`obs.trace.TraceBuffer.summary`); with an ``obs=`` layer,
        ``slo`` its per-tenant TTFT/TPOT summary."""
        qos = self._tenants is not None
        tel = {
            "backlog": (int(self._tenant_live.sum()) if qos
                        else len(self.backlog)),
            "active": len(self.active),
            "free_slots": len(self.free_slots),
            "queue_depth": (int(self._tenant_live.sum()) if qos else
                            max(0, self._sema_ticket_h - self._sema_grant_h)),
            "stats": self.stats.__dict__.copy(),
            "pool_utilization": None,  # unpaged: no pool
            "last_samples": list(self._last_samples),
            "recovery": {k: getattr(self.stats, k) for k in (
                "quarantined", "requeued", "kv_audits", "kernel_fallbacks",
                "snapshots", "restores")},
            "trace": self._trace.summary(),
        }
        if self._kv_pool is not None:
            tel["kv_blocks_free"] = int(self._kv_free_blocks)
            tel["kv_blocks_live"] = int(self._kv_blocks
                                        - self._kv_free_blocks)
            # blocks actually HOLDING tokens / pool
            written = 0
            for r in self.active.values():
                plen = min(len(r.prompt), self._prompt_cap) or 1
                cur = (r.prefill_pos if self._chunk and r.prefill_pos < plen
                       else plen + len(r.out_tokens))
                written += -(-cur // self._kv_bs) if cur else 0
            tel["pool_utilization"] = written / self._kv_blocks
            if self._kv_share:
                # shared blocks count once: the refcount support is the
                # allocated set (the host mirror, no device read)
                live = int((self._kv_refcnt_h > 0).sum())
                tel["pool_utilization"] = live / self._kv_blocks
                tel["blocks_shared"] = int((self._kv_refcnt_h >= 2).sum())
                tel["prefix_hits"] = self.stats.prefix_hits
                tel["cow_copies"] = self.stats.cow_copies
            tel["kv_block_stalls"] = self.stats.kv_block_stalls
            tel["prefill_chunks"] = self.stats.prefill_chunks
            tel["parked_slots"] = sum(r.parked for r in self.active.values())
        if qos:
            total = sum(self.tenant_admitted.values())
            tel["tenants"] = {
                t: {"weight": self._tenants[t],
                    "admitted": self.tenant_admitted[t],
                    "expired": self.tenant_expired[t],
                    "share": ((self.tenant_admitted[t] / total) if total
                              else 0.0),
                    "queue_depth": int(self._tenant_live[self._tindex[t]])}
                for t in self._tenant_names
            }
        if self._obs is not None:
            tel["slo"] = self._obs.summary()
        return tel
