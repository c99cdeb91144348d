"""Continuous-batching engine on PyTorch — the port of
``repro.serving.scheduler.ContinuousBatchingEngine``.

Two engines in one class, as in the reference:

* **Multi-tenant** (``tenants={...}``): QoS tenants, optionally the
  block-paged KV pool (up-front, or with continuous chunked prefill and
  refcounted prefix sharing), served by ``megastep(K)``.  Admission is the
  paper's semaphore at three granularities: per-tenant TWA semaphores
  replenished by stride scheduling (`admission.functional_qos`), the
  free-slot semaphore, and the block pool (`core.functional.BlockPool`).
  ``megastep(K)`` uploads the host queues, runs K device rounds
  (`serving.engine_state.megastep_scan`, no host sync inside) and drains
  every round's outputs in ONE transfer — ``stats.host_syncs`` counts 1
  per megastep.
* **Single-tenant** (``tenants=None``): one TWA semaphore over the free
  slots (`core.functional`), tickets issued by ``submit``/``submit_batch``
  (with ``use_kernel`` through the batched ``sema_batch`` kernel), and the
  host ``step()``: preempt expired → admit the requests whose waiting-array
  bucket moved (``woken_mask``) → prefill → decode through ``step_fn`` →
  sample on the host.  The semaphore lives on the device; each call reads
  back what it needs in ONE transfer.

Client threads wait on the host TWA futex semaphore (`core.twa_semaphore`).
The engine runs on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises where CUDA is absent.

Not in the port yet (each raises ``NotImplementedError`` naming its
ROADMAP item): the ``obs`` hooks and the host ``step()`` of the
multi-tenant engine.  Without that ``step()`` there is no host replica of
the sharing pool: the first sharing launch builds a fresh pool and cache,
which is what the reference's first launch adopts when no ``step()`` ran.
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
from ..core import u32
from ..core.functional import (
    make_sema,
    next_pow2 as _next_pow2,
    post_batch,
    take_batch,
    woken_mask,
)
from ..core.twa_semaphore import TWASemaphore
from ..device import resolve_device
from ..kernels.qos_admission import check_engine_limits
from .events import EV_ADMIT, EV_FINISH, EV_PREEMPT
from .prefix import prompt_hashes


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
    prefill_pos: int = 0    # prompt tokens prefilled so far (chunked)
    prio_key: int = 0       # packed FCFS admission key (Banker order)
    parked: bool = False    # block-parked on the block semaphore (chunked)
    park_bucket: int = 0    # observed TWAHash bucket
    park_seq: int = 0       # bucket sequence at park time
    last_adv_round: int = -1  # last round with progress (watchdog clock)
    ph: Optional[np.ndarray] = None  # (2, W+1) u32 prompt hashes (sharing)


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


class ContinuousBatchingEngine:
    """Slot-synchronous decode engine with TWA-semaphore admission.

    ``step_fn(reqs) -> logits`` (numpy, one row per request) and
    ``prefill_fn(req)`` are the host ``step()`` path's model hooks.
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
        if obs is not None:
            raise _not_ported("the obs/trace hooks", "item 4, obs/trace")
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
        self._last_samples: list[dict] = []
        self._backlog_cap = backlog_cap
        self._prompt_cap = prompt_cap
        self.megastep_model = None  # device model (dict of tensors)
        # host step(): the round's clock, its H_NAN input (non-finite host
        # logits) and its event rows, one list per in-round kind
        self._now_r = 0.0
        self._round_nonfinite = False
        self._ev_preempt: list[list[int]] = []
        self._ev_admit: list[list[int]] = []
        self._ev_finish: list[list[int]] = []
        # host mirrors of the slot semaphore's counters, so telemetry()
        # never reads the device: takes bump the ticket, finish-posts the
        # grant — queue_depth = ticket − grant
        self._sema_ticket_h = 0
        self._sema_grant_h = n_slots
        # --- block-paged KV pool, up-front mode ---
        # ``kv_pool=(num_blocks, block_size[, max_blocks_per_seq])``:
        # admission gates on a free slot AND the request's worst-case block
        # demand; the host keeps only the free-block counter, the block
        # identities live in the device pool (`_kv_state`).
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
        # blocks by incref and pay only for post-divergence demand.
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
            self._kv_refcnt_h = np.zeros(self._kv_blocks, np.int32)
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

    # ------------------------------------------------------------ client ----

    def submit(self, req: Request) -> Request:
        """Take a ticket (FCFS position) and enqueue."""
        if self._tenants is not None:
            self._submit_qos([req])
            return req
        from .engine_state import drain

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
        return req

    def submit_batch(self, reqs: list[Request]) -> None:
        """Vectorized ticket issuance for K arrivals — with ``use_kernel``
        one ``sema_batch`` pass (the CUDA kernel on the card, its plain
        version on the CPU), else `take_batch`.  Tickets, buckets, admits
        and the post-take waiting array come back in ONE transfer."""
        if self._tenants is not None:
            self._submit_qos(reqs)
            return
        from .engine_state import drain

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

    def _cached_blocks(self, r: Request) -> int:
        """Full blocks of ``r``'s prompt the device prefix cache covers now
        (a read of the device cache at submit, outside any round)."""
        from .engine_state import drain
        from .prefix import cache_lookup

        kv = self._kv_state
        if kv is None:  # no launch yet: the cache is empty
            return 0
        plen = min(len(r.prompt), self._prompt_cap) or 1
        dev = self.device
        c, _, _, _ = cache_lookup(
            kv.cache, kv.pool, u32.u32(r.ph[None], device=dev),
            torch.tensor([plen], dtype=torch.int32, device=dev), self._kv_bs)
        return int(drain(c)[0])

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

    # ------------------------------------------------ single-tenant step ----

    def _admit_ready(self) -> tuple[list[Request], int]:
        """Admit backlog requests whose ticket the grant has reached;
        returns them in ticket order with the grant they were tested
        against (the u32 value).
        TWA-style: only requests whose bucket moved since they last looked
        (`woken_mask`), or that were admitted at take time (``fast``), are
        re-examined.  The woken mask, the buckets' sequences and the grant
        come back in ONE transfer.  The admit test keeps the reference's
        plain ``ticket < grant`` conjunct: a ticket issued just below the
        2³² wrap is never admitted once the grant has wrapped (a reference
        fault, ROADMAP queue 3, reproduced bit for bit)."""
        from .engine_state import drain

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

    def _finish(self, slot: int, reason: str) -> None:
        """Retire a slot of the single-tenant engine.  ``reason ==
        "deadline"`` is decode preemption (tombstoned, not completed).  The
        freed slot posts one unit: the grant advances and the next ticket's
        bucket is poked."""
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
        else:
            self.stats.finished += 1
        self.sema = post_batch(self.sema, 1)
        self._sema_grant_h += 1
        self.stats.wakeups += 1
        req.done_event.set()
        self._client_sem.post()

    def _preempt_expired(self) -> None:
        """Deadline-aware decode preemption: a running sequence whose
        deadline passed is tombstoned and its slot freed before this
        step's admission, in ascending slot order (the event order)."""
        now = self._clock()
        due = sorted(slot for slot, req in self.active.items()
                     if req.deadline is not None and req.deadline <= now)
        for slot in due:
            r = self.active[slot]
            self._ev_preempt.append(
                [EV_PREEMPT, r.rid, slot, len(r.out_tokens)])
        for slot in due:
            self._finish(slot, "deadline")

    def step(self, sample_fn: Callable[[np.ndarray], np.ndarray]) -> int:
        """One iteration of the single-tenant engine: preempt expired →
        admit → prefill the admitted (``prefill_fn``) → decode the active
        rows (``step_fn``) → sample on the host (``sample_fn`` over numpy
        logits) → retire the finished.  Returns the number of active
        rows."""
        from .engine_state import _D_CLAMP, _T_BITS

        if self._tenants is not None:
            raise _not_ported("the host step() of the multi-tenant engine",
                              "item 3, the host step() twin")
        with self._lock:
            rnd = self._round_no
            self.stats.host_syncs += 1  # ONE nominal sync per step
            now_r = self._now_r = self._clock()
            self._ev_preempt, self._ev_admit, self._ev_finish = [], [], []
            self._round_nonfinite = False
            a0, e0, p0 = (self.stats.admitted, self.stats.expired,
                          self.stats.preempted)
            self._preempt_expired()
            admitted, g0 = self._admit_ready()
            if admitted:
                # admits in packed-FCFS-key order take ascending free
                # slots (the device `_assign_slots` order)
                for r in admitted:
                    d = (r.ticket - g0) & 0xFFFFFFFF
                    d = d - (1 << 32) if d >= (1 << 31) else d
                    r.prio_key = max(-_D_CLAMP, min(_D_CLAMP, d)) << _T_BITS
                admitted = sorted(admitted, key=lambda r: r.prio_key)
                self.free_slots.sort(reverse=True)
            for req in admitted:
                slot = self.free_slots.pop()
                req.slot = slot
                req.admit_t = time.time()
                req.admit_round = rnd
                req.last_adv_round = rnd
                self.active[slot] = req
                self.stats.admitted += 1
                self._ev_admit.append(
                    [EV_ADMIT, req.rid, slot,
                     min(len(req.prompt), self._prompt_cap) or 1])
                self.prefill_fn(req)  # the owner fills the row's cache

            if not self.active:
                self._round_no = rnd + 1
                self._record_round(self._host_sample(rnd, now_r, a0, e0,
                                                     p0, 0))
                return 0
            self.stats.steps += 1
            decode = list(self.active.items())
            logits = self.step_fn([r for _, r in decode])
            if (isinstance(logits, np.ndarray) and logits.dtype.kind == "f"
                    and not np.all(np.isfinite(logits))):
                self._round_nonfinite = True  # H_NAN sentinel input
            next_tokens = sample_fn(logits)
            done_slots = []
            for (slot, req), tok in zip(decode, next_tokens):
                req.out_tokens.append(int(tok))
                req.last_adv_round = rnd
                if req.first_tok_clock is None:
                    req.first_tok_clock = now_r
                req.last_tok_clock = now_r
                if len(req.out_tokens) >= req.max_new_tokens:
                    done_slots.append(slot)
            for slot in sorted(done_slots):  # lane-ascending event order
                r = self.active[slot]
                self._ev_finish.append(
                    [EV_FINISH, r.rid, slot, len(r.out_tokens)])
            for slot in done_slots:
                self._finish(slot, "length")
            self._round_no = rnd + 1
            self._record_round(self._host_sample(rnd, now_r, a0, e0, p0,
                                                 len(decode)))
            return len(self.active)

    def _record_round(self, sample: dict) -> None:
        self._last_samples = [sample]

    def _host_sample(self, rnd: int, now_r: float, a0: int, e0: int,
                     p0: int, n_tok: int) -> dict:
        """The single-tenant step()'s telemetry sample: the reference's
        record (keys and values), mirrored from the host bookkeeping (no
        pool, no tenants, no chunked prefill)."""
        from .engine_state import SLOT_TABLE
        from .sentinels import host_round_health

        health = host_round_health(
            n_slots=self.n_slots, free_slots=len(self.free_slots),
            active=len(self.active),
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
            "prefill_tokens": 0,
            "prefill_chunks": 0,
            "prefill_pending": 0,
            "gate_stalls": 0,
            "parked": 0,
            "backlog": len(self.backlog),
            "active": len(self.active),
            "slot_free": len(self.free_slots),
            "kv_free": 0,
            "kv_pokes": 0,
            "prefix_hits": 0,
            "blocks_shared": 0,
            "cow_copies": 0,
            "health": int(health),
            "credit": [],
            "poke_dead": [],
            "kv_wait_hist": [0] * SLOT_TABLE,
            # the event rows in the canonical segment order
            "events": self._ev_preempt + self._ev_admit + self._ev_finish,
        }

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
            chunked = self._chunk > 0
            sharing = self._kv_share
            fresh_kv = paged and self._kv_state is None
            state = make_engine_state(
                self.qos, S, B, P, free_units=self._qos_free,
                kv_blocks=self._kv_blocks if fresh_kv else 0,
                kv_slot_blocks=self._kv_mb if fresh_kv else 0,
                ring_cap=_next_pow2(K),
                prefix_entries=self._kv_prefix if fresh_kv and sharing
                else 0,
                hash_width=self._hash_w if sharing else 0, device=dev)
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

            def up(a):
                return torch.as_tensor(a, device=dev)

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
                        st.kv.pool.refcnt)
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
                grant, ticket, refcnt_h = kv_h
                self._kv_free_blocks = int(np.int64(grant - ticket)
                                           .astype(np.int32))
                if sharing:
                    self._kv_refcnt_h = refcnt_h
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
                self.stats.kv_block_stalls = int(stalls_h)
                self.stats.prefill_chunks = int(chunks_h)
            self._last_samples = ring_samples(ring_h, t0=t0)
            if sharing:
                self.stats.prefix_hits += sum(
                    s["prefix_hits"] for s in self._last_samples)
                self.stats.cow_copies += sum(
                    s["cow_copies"] for s in self._last_samples)
            self._round_no = base + K
            return int(busy_h.sum())

    # ---------------------------------------------------------- telemetry ---

    def telemetry(self) -> dict:
        """Gauge snapshot of the engine — pure host-side reads (no device
        transfer, no ``host_syncs`` bump).  ``last_samples`` holds the
        one sample of the last ``step()`` or the K per-round samples of the
        last ``megastep(K)``.  The reference's ``trace`` and ``slo`` keys
        wait for the obs/trace slice."""
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
                # allocated set (the drained host mirror, no device read)
                live = int((self._kv_refcnt_h > 0).sum())
                tel["pool_utilization"] = live / self._kv_blocks
                tel["blocks_shared"] = int((self._kv_refcnt_h >= 2).sum())
                tel["prefix_hits"] = self.stats.prefix_hits
                tel["cow_copies"] = self.stats.cow_copies
            tel["kv_block_stalls"] = self.stats.kv_block_stalls
            tel["prefill_chunks"] = self.stats.prefill_chunks
            tel["parked_slots"] = sum(r.parked for r in self.active.values())
        if not qos:
            return tel
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
