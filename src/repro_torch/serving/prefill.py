"""Continuous chunked prefill on tensors — the port of
``repro.serving.prefill``: block-demand arithmetic, the Banker priority
order, and the per-round chunk plan.

Admission gates on first-chunk demand only; every round co-schedules
prompt chunks with decode under a per-round prefill token budget; blocks
are taken when a sequence crosses a block boundary, and a slot that finds
the pool short parks on the block semaphore's waiting array
(`core.functional.pool_try_alloc`).  Deadlock freedom rests on the Banker
invariant over the slots in nearest-completion order
(:func:`banker_order`)::

    rem_i  ≤  free  +  Σ_{j<i} held_j       for every live slot i,

kept at admission (`admission.functional_qos.block_gate` with
`block_headroom`) and at every take (:func:`chunk_plan`).

:func:`chunk_plan` is a scan over the S slots in priority order with a
sequential carry; it has no vector form.  Here it is a Python loop of S
steps on 0-dim tensors: sync-free, but some twenty small kernel launches
per step on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT32_MAX = 2**31 - 1


def cdiv(a, b: int):
    return (a + b - 1) // b


def first_chunk_demand(prompt_len, chunk: int, block_size: int):
    """Blocks the first prefill chunk of a prompt needs:
    ``max(⌈min(chunk, plen)/BS⌉, 1)``, int32."""
    plen = prompt_len.to(torch.int32)
    return torch.clamp(cdiv(torch.clamp(plen, max=chunk), block_size), min=1)


def total_block_demand(prompt_len, max_new, block_size: int):
    """Worst-case whole-lifetime block demand of a sequence (every token
    it can ever hold): ``max(⌈(plen + max_new)/BS⌉, 1)``, int32."""
    return torch.clamp(cdiv(prompt_len.to(torch.int32)
                            + max_new.to(torch.int32), block_size), min=1)


def shared_first_chunk_demand(prompt_len, cov, chunk: int, block_size: int):
    """Post-divergence first-chunk demand when the leading ``cov`` tokens
    are cache-resident: ``max(⌈min(chunk, plen − cov)/BS⌉, 1)``; a fully
    covered prompt needs 1 block if ``cov`` is block-aligned (its first
    decode write opens a block), else 0 (it writes copy-on-write into the
    shared tail).  Equals :func:`first_chunk_demand` at ``cov = 0``."""
    plen = prompt_len.to(torch.int32)
    cov = cov.to(torch.int32)
    aligned = cov == (cov // block_size) * block_size
    full = torch.where(aligned, 1, 0).to(torch.int32)
    part = torch.clamp(cdiv(torch.clamp(plen - cov, max=chunk), block_size),
                       min=1)
    return torch.where(cov >= plen, full, part)


def pending_prompt_tokens(pos: torch.Tensor, plen: torch.Tensor,
                          busy: torch.Tensor) -> torch.Tensor:
    """Prompt tokens still waiting to be prefilled across the busy slots
    (identically 0 in the up-front modes).  i32 scalar."""
    return torch.where(busy, torch.clamp(plen - pos, min=0), 0).sum(
        dtype=torch.int32)


def banker_order(rem, prio_round, prio_key, active) -> torch.Tensor:
    """The safety-chain permutation: ascending (remaining worst-case
    demand, admission round, packed FCFS key, slot index), inactive rows
    last — three stable argsorts composed into a lexsort, so it is the
    reference's permutation bit for bit.  Returns int64 indices."""
    key3 = torch.where(active, prio_key.to(torch.int32), INT32_MAX)
    key2 = torch.where(active, prio_round.to(torch.int32), INT32_MAX)
    key1 = torch.where(active, rem.to(torch.int32), INT32_MAX)
    o3 = torch.argsort(key3, stable=True)
    o = o3[torch.argsort(key2[o3], stable=True)]
    return o[torch.argsort(key1[o], stable=True)]


class ChunkPlan(NamedTuple):
    """Per-slot outcome of one round's budget + Banker scan, in slot
    order."""

    take: torch.Tensor     # (S,) i32 — blocks granted this round
    tokens: torch.Tensor   # (S,) i32 — prefill tokens to write this round
    parked: torch.Tensor   # (S,) bool — block-stalled (parked)
    deficit: torch.Tensor  # (S,) i32 — grant advance that wakes a new park
    emit: torch.Tensor     # (S,) bool — decode-ready this round (post-take)
    cow: torch.Tensor      # (S,) bool — granted a copy-on-write block


def chunk_plan(order, busy, parked, woken, pos, plen, max_new, held, free,
               cow, held_free, *, chunk: int, budget: int,
               block_size: int) -> ChunkPlan:
    """Plan one round of continuous chunked prefill: split the prefill
    token ``budget`` over the prefilling slots, decide every incremental
    block take (prefill chunks, decode boundary crossings, copy-on-write
    replacements) and park the block-stalled slots, walking the slots in
    priority ``order`` (:func:`banker_order`) with the reference's carry
    ``(T, minM, budget_left)``.  A take by a slot is capped at ``min(free,
    min_{j<s} M_j) − T`` where ``M_j = free + Σheld_{<j} + Σtake_{≤j} −
    rem_j`` keeps invariant (I).  ``cow`` marks decode-ready slots whose
    next write block is shared; ``held_free`` is each slot's privately
    held count (the Banker cover).  Without sharing (``cow`` all False,
    ``held_free == held``) it is the plain chunk plan.

    The per-slot inputs are computed as vectors first; only the carry
    recurrence runs as a loop of S steps.  Returns a :class:`ChunkPlan`
    in slot order."""
    BS = block_size
    S = busy.shape[0]
    dev = busy.device
    i32 = torch.int32
    free = torch.as_tensor(free, dtype=i32, device=dev)
    pos, plen, held = pos.to(i32), plen.to(i32), held.to(i32)
    cow_in = cow.to(torch.bool)
    rem = (total_block_demand(plen, max_new, BS) - held
           + torch.where(cow_in, 1, 0).to(i32))
    trying = busy & (~parked | woken)
    prefilling = busy & (pos < plen)

    order = order.to(torch.int64)
    held_b = torch.where(busy, held_free.to(i32), 0)[order]
    cum_held = torch.cumsum(held_b, 0, dtype=i32) - held_b
    b_s, t_s, pf_s = busy[order], trying[order], prefilling[order]
    p_s, h_s, r_s, cw_s = pos[order], held[order], rem[order], cow_in[order]
    want = torch.where(pf_s & t_s, torch.clamp(plen[order] - p_s, max=chunk),
                       0).to(i32)
    dec_try = b_s & ~pf_s & t_s & (p_s >= h_s * BS)
    cow_try = b_s & ~pf_s & t_s & cw_s & (p_s < h_s * BS)
    atomic = (dec_try | cow_try).to(i32)   # one block, all or nothing
    pB = p_s + (BS - 1)                    # cdiv(p + ctb, BS) numerator
    room = h_s * BS - p_s                  # token room in held blocks
    base_M = free + cum_held - r_s         # M_j without the running T, take
    big = torch.full((), INT32_MAX, dtype=i32, device=dev)

    T = torch.zeros((), dtype=i32, device=dev)
    minM = free                            # min(free, min_{j<s} M_j)
    budget_left = torch.full((), budget, dtype=i32, device=dev)
    takes, cts, ctbs, caps = [], [], [], []
    for i in range(S):
        ctb = torch.minimum(want[i], budget_left)
        need_pf = torch.clamp(torch.div(pB[i] + ctb, BS, rounding_mode="floor")
                              - h_s[i], min=0)
        need = torch.where(pf_s[i], need_pf, atomic[i])
        cap = minM - T
        # prefill: clip(cap, 0, need); atomic: need (= 1) iff need ≤ cap
        take = torch.minimum(torch.clamp(cap, min=0), need)
        ct = torch.where(pf_s[i], torch.minimum(ctb, room[i] + take * BS), 0)
        M = torch.where(b_s[i], base_M[i] + T + take, big)
        T = T + take
        minM = torch.minimum(minM, M)
        budget_left = budget_left - ct
        takes.append(take)
        cts.append(ct)
        ctbs.append(ctb)
        caps.append(cap)
    take_s, ct_s = torch.stack(takes), torch.stack(cts)
    ctb_s, cap_s = torch.stack(ctbs), torch.stack(caps)
    newly_s = t_s & ((pf_s & (ctb_s > 0) & (ct_s == 0))
                     | ((atomic > 0) & (take_s == 0)))
    def_s = torch.where(newly_s, 1 - torch.clamp(cap_s, max=0), 0).to(i32)
    cow_s = cow_try & (take_s > 0)

    inv = torch.empty(S, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.arange(S, device=dev))
    take = take_s[inv]
    tokens = ct_s[inv].to(i32)
    still_parked = busy & parked & ~woken
    parked_out = newly_s[inv] | still_parked
    # a slot with a pending copy-on-write may not emit until granted
    emit = (busy & ~prefilling & (pos < (held + take) * BS)
            & (~cow_in | (take > 0)))
    return ChunkPlan(take=take.to(i32), tokens=tokens, parked=parked_out,
                     deficit=def_s[inv], emit=emit, cow=cow_s[inv])
