"""Batched multi-tenant QoS admission on tensors — the port of
``repro.admission.functional_qos``.

Per-tenant TWA semaphores (``ticket``/``grant``) replenished from the
global slot pool by stride scheduling (``weight``/``vpass``), with
deadline tombstones (``dead``) that stay transparent to later live
tickets, and one waiting array (``bucket_seq``) shared by all tenants
through a per-tenant salt.  A whole round (expire → replenish → admit →
reclaim) is :func:`qos_round`, the plain version of the fused CUDA kernel
(`repro_torch.kernels.qos_admission`), which must match it bit for bit.

Counters are u32 carriers (:mod:`repro_torch.core.u32`); weights and
virtual passes are float32, computed with correctly rounded division so
the stride keys equal the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import u32
from ..core.functional import (
    _sdist,
    live_fifo_rank,
    live_fifo_rank_pairwise,
    segment_counts,
    twa_hash_u32,
)
from ..core.hashfn import MIX32KA, TICKET_STRIDE
from ..device import resolve_device

DEFAULT_TABLE_SIZE = 1024

# 17⁻¹ mod 2³² — stays the inverse mod any power-of-two table size, so
# ((bucket − start)·STRIDE_INV) mod T recovers a ticket's window offset.
STRIDE_INV = pow(TICKET_STRIDE, -1, 1 << 32)

INT32_MAX = 2**31 - 1


class QoSState(NamedTuple):
    ticket: torch.Tensor      # (S,) u32 — per-tenant tickets issued
    grant: torch.Tensor       # (S,) u32 — per-tenant units replenished
    consumed: torch.Tensor    # (S,) u32 — units spent on admitted rows
    dead: torch.Tensor        # (S,) u32 — tombstones (poke-window slack)
    weight: torch.Tensor      # (S,) f32 — QoS weights
    vpass: torch.Tensor       # (S,) f32 — stride virtual pass
    bucket_seq: torch.Tensor  # (T,) u32 — shared waiting array
    salt: torch.Tensor        # u32 scalar


def make_qos(weights, table_size: int = DEFAULT_TABLE_SIZE,
             salt: int = 0x9E3779B9, device=None) -> QoSState:
    """Weights must be ≥ 0 (a zero-weight tenant gets at most one unit).
    ``device=None`` is the card (raises without CUDA)."""
    device = resolve_device(device, "make_qos")
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    assert table_size > 0 and (table_size & (table_size - 1)) == 0
    S = w.shape[0]

    def z():
        return torch.zeros(S, dtype=torch.int64, device=device)

    return QoSState(ticket=z(), grant=z(), consumed=z(), dead=z(), weight=w,
                    vpass=torch.zeros_like(w),
                    bucket_seq=torch.zeros(table_size, dtype=torch.int64,
                                           device=device),
                    salt=torch.full((), salt & u32.MASK32, dtype=torch.int64,
                                    device=device))


def tenant_salt(state: QoSState, tenant_ids) -> torch.Tensor:
    """Per-tenant TWAHash salt (disperses the tenants over one array)."""
    t = tenant_ids.to(torch.int64)
    return u32.add(state.salt, u32.mul(t + 1, MIX32KA))


def qos_bucket_index(state: QoSState, tenant_ids, tickets) -> torch.Tensor:
    table = state.bucket_seq.shape[-1]
    h = twa_hash_u32(tenant_salt(state, tenant_ids), tickets)
    return (h & (table - 1)).to(torch.int32)


def avail(state: QoSState) -> torch.Tensor:
    """Spendable grant units per tenant (int32)."""
    return _sdist(state.grant, state.consumed)


def qos_take(state: QoSState, tenant_ids: torch.Tensor, mask: torch.Tensor,
             deadlines: torch.Tensor | None = None, now=0.0):
    """Batched ticket issuance for N arrivals; rows already past their
    deadline are dead on arrival (no ticket).  Returns ``(state', tickets,
    buckets, expired)``."""
    ids = tenant_ids.to(torch.int64)
    if deadlines is None:
        expired = torch.zeros_like(mask)
    else:
        expired = mask & (deadlines <= now)
    eff = mask & ~expired
    S = state.ticket.shape[0]
    onehot = ((ids[:, None] == torch.arange(S, device=ids.device)[None])
              & eff[:, None]).to(torch.int64)
    ranks = torch.cumsum(onehot, 0) - onehot
    my_rank = ranks.gather(1, ids[:, None])[:, 0]
    tickets = u32.add(state.ticket[ids], my_rank)
    new_ticket = u32.add(state.ticket, segment_counts(ids, eff, S))
    buckets = qos_bucket_index(state, ids, tickets)
    return state._replace(ticket=new_ticket), tickets, buckets, expired


def qos_expire(state: QoSState, tenant_ids: torch.Tensor,
               alive: torch.Tensor, deadlines: torch.Tensor, now):
    """Tombstone waiting rows whose deadline passed.  Returns
    ``(state', alive', newly_expired)``."""
    newly = alive & (deadlines <= now)
    per_tenant = segment_counts(tenant_ids, newly, state.ticket.shape[0])
    return (state._replace(dead=u32.add(state.dead, per_tenant)),
            alive & ~newly, newly)


def qos_admit(state: QoSState, tenant_ids: torch.Tensor,
              tickets: torch.Tensor, alive: torch.Tensor, *,
              pairwise_rank: bool = False):
    """Tombstone-transparent weighted-FCFS admission: a row is admitted
    iff its live FIFO rank is below its tenant's avail.  Returns
    ``(state', admitted)``.  ``pairwise_rank=True`` takes the O(N²) rank
    (benchmark baseline)."""
    S = state.ticket.shape[0]
    if pairwise_rank:
        rank = live_fifo_rank_pairwise(tenant_ids, tickets, alive)
    else:
        rank = live_fifo_rank(tenant_ids, tickets, alive, S)
    admitted = alive & (rank < avail(state)[tenant_ids.to(torch.int64)])
    spent = segment_counts(tenant_ids, admitted, S)
    return state._replace(consumed=u32.add(state.consumed, spent)), admitted


def stride_alloc(vpass: torch.Tensor, weight: torch.Tensor,
                 unmet: torch.Tensor, free_units, max_units: int):
    """Closed-form stride allocation: tenant s's k-th grant crosses
    virtual time ``vpass_s + k/w_s``; the first ``take`` crossings of the
    (value, tenant, k) order are granted (stable argsort — ties to the
    lower tenant).  Non-finite crossings are never granted.  Returns
    ``alloc (S,) u32``."""
    S, U = vpass.shape[0], max_units
    dev = vpass.device
    k = torch.arange(U, dtype=torch.float32, device=dev)[None, :].expand(S, U)
    w = weight[:, None]
    step = torch.where(w > 0, k / w, torch.inf)
    step = torch.where(k == 0, 0.0, step)
    cross = torch.where(k < unmet[:, None].to(torch.float32),
                        vpass[:, None] + step, torch.inf)
    n_finite = torch.isfinite(cross).to(torch.int32).sum()
    take = torch.minimum(
        torch.clamp(torch.as_tensor(free_units, device=dev), 0, U),
        n_finite)
    order = torch.argsort(cross.reshape(-1), stable=True)
    rank = torch.empty(S * U, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.arange(S * U, device=dev))
    granted = (rank < take).reshape(S, U)
    return granted.to(torch.int64).sum(1)


def poke_bump(state: QoSState, widths: torch.Tensor) -> torch.Tensor:
    """Waiting-array bump for per-tenant windows ``[grant_s, grant_s+w_s)``
    through the coprime-stride permutation: ``bump[j] = Σ_s [((j −
    start_s)·17⁻¹ mod T) < w_s]``."""
    table = state.bucket_seq.shape[-1]
    S = state.ticket.shape[0]
    dev = state.grant.device
    start = twa_hash_u32(
        tenant_salt(state, torch.arange(S, device=dev)), state.grant)
    j = torch.arange(table, dtype=torch.int64, device=dev)[None, :]
    offs = u32.mul(u32.sub(j, start[:, None]), STRIDE_INV) & (table - 1)
    return (offs < widths[:, None]).to(torch.int64).sum(0)


def qos_replenish(state: QoSState, free_units, live_depth: torch.Tensor,
                  max_units: int):
    """Distribute up to ``free_units`` slots by stride scheduling to
    tenants with unmet live demand and poke the conservatively-enabled
    ticket windows (alloc + dead slack, clamped to the issued frontier).
    Returns ``(state', alloc, leftover)``."""
    dev = state.grant.device
    free_units = torch.as_tensor(free_units, dtype=torch.int32, device=dev)
    live_depth = live_depth.to(torch.int32)
    unmet = torch.clamp(live_depth - avail(state), 0, max_units)
    alloc = stride_alloc(state.vpass, state.weight, unmet, free_units,
                         max_units)
    af = alloc.to(torch.float32)
    dv = torch.where(alloc > 0,
                     torch.where(state.weight > 0, af / state.weight,
                                 torch.inf),
                     0.0)
    vpass = state.vpass + dv
    leftover = free_units - alloc.to(torch.int32).sum(dtype=torch.int32)
    outstanding = torch.clamp(_sdist(state.ticket, state.grant), min=0)
    width = torch.minimum(u32.to_bits32(u32.add(alloc, state.dead)),
                          outstanding)
    bump = poke_bump(state, u32.u32(width))
    return state._replace(grant=u32.add(state.grant, alloc), vpass=vpass,
                          bucket_seq=u32.add(state.bucket_seq, bump)), \
        alloc, leftover


def qos_reclaim(state: QoSState, live_depth: torch.Tensor):
    """Burn credit granted past all live demand back to the caller's
    pool; the poke slack ``dead`` shrinks by the reclaimed amount.
    Returns ``(state', units)``."""
    surplus = torch.clamp(avail(state) - live_depth.to(torch.int32),
                          min=0).to(torch.int64)
    return (state._replace(consumed=u32.add(state.consumed, surplus),
                           dead=state.dead - torch.minimum(state.dead,
                                                           surplus)),
            surplus.to(torch.int32).sum(dtype=torch.int32))


def block_gate(admitted: torch.Tensor, demand: torch.Tensor,
               key: torch.Tensor, free_blocks, headroom=0,
               commit_demand=None, commit_free=0, commit_bootstrap=False):
    """Second-resource gate: of the QoS-admitted rows, keep the longest
    FCFS prefix (by ``key``; non-admitted rows carry INT32_MAX) whose
    cumulative block demand fits ``free_blocks − headroom``; an unfit row
    blocks every later one (no bypass).  ``commit_demand``/``commit_free``
    add the commitment watermark of chunked prefill (each candidate's
    lifetime demand must also fit the remaining budget), and
    ``commit_bootstrap`` exempts the FCFS-first candidate from it.
    Returns the granted mask."""
    demand = demand.to(torch.int32)
    order = torch.argsort(torch.where(admitted, key, INT32_MAX), stable=True)
    adm_s = admitted[order]
    cum = torch.cumsum(torch.where(adm_s, demand[order], 0), 0,
                       dtype=torch.int32)
    fits = cum <= free_blocks - headroom
    if commit_demand is not None:
        cum2 = torch.cumsum(torch.where(
            adm_s, commit_demand.to(torch.int32)[order], 0), 0,
            dtype=torch.int32)
        first = adm_s & (torch.cumsum(adm_s.to(torch.int32), 0) == 1)
        fits = fits & ((cum2 <= commit_free) | (first & commit_bootstrap))
    blocked = torch.cumsum((adm_s & ~fits).to(torch.int32), 0) > 0
    ok = adm_s & fits & ~blocked
    return torch.zeros_like(admitted).scatter_(0, order, ok)


def block_headroom(rem: torch.Tensor, held: torch.Tensor,
                   order: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Reserved headroom of the incremental block allocator (the Banker
    margin): ``max(0, max_i(rem_i − Σ_{j<i} held_j))`` over the active
    slots in priority ``order``.  Returns an i32 scalar."""
    order = order.to(torch.int64)
    act_s = active[order]
    held_s = torch.where(act_s, held.to(torch.int32)[order], 0)
    cum_held = torch.cumsum(held_s, 0, dtype=torch.int32) - held_s
    deficit = torch.where(act_s, rem.to(torch.int32)[order] - cum_held,
                          torch.iinfo(torch.int32).min)
    return torch.clamp(deficit.max() if deficit.numel() else
                       torch.zeros((), dtype=torch.int32,
                                   device=rem.device), min=0)


def qos_scan_round(state: QoSState, tenant_ids: torch.Tensor,
                   tickets: torch.Tensor, alive: torch.Tensor,
                   deadlines: torch.Tensor, now, free_pool, released,
                   max_units: int, *, round_impl=None):
    """One admission round with slot-release feedback: ``released`` units
    join the pool before the replenish.  ``round_impl`` selects the round
    implementation (default :func:`qos_round`).  Returns ``(state',
    admitted, expired, leftover)``."""
    impl = round_impl if round_impl is not None else qos_round
    return impl(state, tenant_ids, tickets, alive, deadlines, now,
                free_pool + released, max_units)


def qos_round(state: QoSState, tenant_ids: torch.Tensor,
              tickets: torch.Tensor, alive: torch.Tensor,
              deadlines: torch.Tensor, now, free_units, max_units: int, *,
              pairwise_rank: bool = False):
    """One whole multi-tenant admission round: expire → replenish
    (weighted) → admit (tombstone-transparent FCFS) → reclaim.  Returns
    ``(state', admitted, expired, leftover)``.  The plain version of the
    fused CUDA kernel; ``pairwise_rank=True`` takes the O(N²) rank
    (benchmark baseline)."""
    state, alive, expired = qos_expire(state, tenant_ids, alive, deadlines,
                                       now)
    S = state.ticket.shape[0]
    depth = segment_counts(tenant_ids, alive, S, dtype=torch.int32)
    state, _, leftover = qos_replenish(state, free_units, depth, max_units)
    state, admitted = qos_admit(state, tenant_ids, tickets, alive,
                                pairwise_rank=pairwise_rank)
    depth_after = depth - segment_counts(tenant_ids, admitted, S,
                                         dtype=torch.int32)
    state, reclaimed = qos_reclaim(state, depth_after)
    return state, admitted, expired, leftover + reclaimed
