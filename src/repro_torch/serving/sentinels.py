"""In-scan invariant sentinels — the engine's per-round health bitmask,
ported from ``repro.serving.sentinels``.

Mirrored bits (low 16): free-slot counter identity, negative tenant
credit, block-pool conservation (refcounted under sharing), Banker
headroom (chunked mode), stuck-slot watchdog.  Deep bits (high 16): the
block-pool partition audit and non-finite model values.  0 = every
invariant holds.
"""

from __future__ import annotations

import torch

from ..admission.functional_qos import block_headroom
from ..core.functional import _sdist, pool_free_count
from .prefill import banker_order

H_SLOT_CONSERVE = 1 << 0   # free-slot sema: grant − ticket ≠ S − busy
H_CREDIT_NEG = 1 << 1      # some tenant credit grant − consumed < 0
H_KV_CONSERVE = 1 << 2     # block sema: free + held ≠ pool size
H_BANKER = 1 << 3          # Banker headroom > free pool (chunked mode)
H_STUCK = 1 << 4           # watchdog: no progress for ≥ W rounds

H_KV_PARTITION = 1 << 16   # free queue ∪ tables ≠ {0..NB−1}
H_NAN = 1 << 17            # non-finite value in a model float leaf

HEALTH_MIRRORED_MASK = 0xFFFF

HEALTH_BITS = {
    "slot_conserve": H_SLOT_CONSERVE,
    "credit_neg": H_CREDIT_NEG,
    "kv_conserve": H_KV_CONSERVE,
    "banker": H_BANKER,
    "stuck": H_STUCK,
    "kv_partition": H_KV_PARTITION,
    "nan": H_NAN,
}


def decode_health(mask: int) -> list[str]:
    """Human-readable view of a health bitmask."""
    return [name for name, bit in HEALTH_BITS.items() if int(mask) & bit]


def _bit(cond, bit):
    """A u32 carrier: ``bit`` where ``cond`` holds, else 0."""
    return torch.where(cond, bit, 0).to(torch.int64)


def kv_partition_violated(kv) -> torch.Tensor:
    """Ground-truth partition audit of the block pool (bool scalar):
    ``{free_q[ticket..grant)} ∪ {refcnt > 0} = {0..NB−1}`` and per-block
    table references equal ``refcnt``.  O(NB + S·MB)."""
    NB = kv.pool.free_q.shape[0]
    dev = kv.pool.free_q.device
    free_n = pool_free_count(kv.pool)
    bad = (free_n < 0) | (free_n > NB)
    n = torch.clamp(free_n, 0, NB)
    pos = torch.arange(NB, device=dev)
    in_free = pos < n
    fid = kv.pool.free_q[(kv.pool.sema.ticket + pos) & (NB - 1)]
    ok_f = in_free & (fid >= 0) & (fid < NB)
    bad = bad | (in_free & ~ok_f).any()
    cnt = torch.zeros(NB, dtype=torch.int32, device=dev).scatter_add_(
        0, torch.where(ok_f, fid, 0).to(torch.int64), ok_f.to(torch.int32))
    tid = kv.tbl.reshape(-1)
    ok_t = (tid >= 0) & (tid < NB)
    bad = bad | (tid >= NB).any()
    refs = torch.zeros(NB, dtype=torch.int32, device=dev).scatter_add_(
        0, torch.where(ok_t, tid, 0).to(torch.int64), ok_t.to(torch.int32))
    live = (kv.pool.refcnt > 0).to(torch.int32)
    return bad | (cnt + live != 1).any() | (refs != kv.pool.refcnt).any()


def model_nonfinite(model, device=None) -> torch.Tensor:
    """True iff any float tensor of the model dict holds a NaN/Inf (a
    model that is not a dict, such as ``()``, holds none)."""
    leaves = [v for v in (model.values() if isinstance(model, dict) else ())
              if isinstance(v, torch.Tensor) and v.is_floating_point()]
    bad = torch.zeros((), dtype=torch.bool, device=device)
    for leaf in leaves:
        bad = bad | ~torch.isfinite(leaf).all()
    return bad


def round_health(state, model, round_no, *, block_size: int = 0,
                 chunked: bool = False, watchdog: int = 0) -> torch.Tensor:
    """The per-round health bitmask over the post-round engine state.
    Returns a u32 carrier scalar; 0 = every invariant holds."""
    sl = state.slots
    S = sl.busy.shape[0]
    active = sl.busy.to(torch.int32).sum(dtype=torch.int32)
    h = _bit(_sdist(state.slot_sema.grant, state.slot_sema.ticket)
             != S - active, H_SLOT_CONSERVE)
    h = h | _bit((_sdist(state.qos.grant, state.qos.consumed) < 0).any(),
                 H_CREDIT_NEG)
    if state.kv is not None:
        kv = state.kv
        sharing = kv.cache is not None
        NB = kv.pool.free_q.shape[0]
        # refcounted conservation under sharing: free + {refcnt > 0} = NB
        # (table entries over-count shared blocks)
        live = kv.pool.refcnt > 0 if sharing else kv.tbl >= 0
        held = live.to(torch.int32).sum(dtype=torch.int32)
        free = pool_free_count(kv.pool)
        h = h | _bit(free + held != NB, H_KV_CONSERVE)
        h = h | _bit(kv_partition_violated(kv), H_KV_PARTITION)
        if chunked:
            from .engine_state import _held, _share_flags, _slot_rem

            held_s = _held(kv.tbl)
            rem = _slot_rem(sl, held_s, block_size)
            cover = held_s
            if sharing:
                # a pending copy-on-write still owes one block; only
                # privately held blocks fund the Banker cover
                cow, cover = _share_flags(kv.tbl, kv.pool.refcnt, sl.busy,
                                          sl.pos, sl.plen, held_s,
                                          block_size)
                rem = rem + cow.to(torch.int32)
            need = block_headroom(
                rem, cover, banker_order(rem, sl.prio_r, sl.prio_k, sl.busy),
                sl.busy)
            h = h | _bit(need > free, H_BANKER)
    if watchdog > 0:
        h = h | _bit((sl.busy & (round_no - sl.last_adv >= watchdog)).any(),
                     H_STUCK)
    return h | _bit(model_nonfinite(model, sl.busy.device), H_NAN)


def host_round_health(*, n_slots: int, free_slots: int, active: int,
                      stuck: bool = False, nonfinite: bool = False) -> int:
    """Host mirror of :func:`round_health`'s mirrored bits for the
    single-tenant host ``step()`` (no tenants, no pool): the free-slot
    identity and the watchdog, plus ``H_NAN`` from the host path's own
    logits.  Healthy rounds give 0 on both paths; the deep device-side
    bits are 0 on the host by definition.  (The reference's credit, pool
    and Banker inputs come with the multi-tenant ``step()``, ROADMAP
    item 3.)"""
    h = 0
    if free_slots != n_slots - active:
        h |= H_SLOT_CONSERVE
    if stuck:
        h |= H_STUCK
    if nonfinite:
        h |= H_NAN
    return h
