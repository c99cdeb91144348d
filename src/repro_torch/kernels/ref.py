"""Plain PyTorch oracles for the ported kernels — the port of
``repro.kernels.ref`` for this slice's functions.  Each CUDA kernel is
held against these on the card, and the CPU tests hold these against the
JAX package's oracles."""

from __future__ import annotations

import math

import torch

NEG_INF = float("-inf")


# ------------------------------------------------------------- qos_round ----


def qos_round_ref(state, tenant_ids, tickets, alive, deadlines, now,
                  free_units, max_units: int):
    """Oracle for the fused multi-tenant admission round: delegates to
    `admission.functional_qos.qos_round`.  Returns a dict with the new
    QoSState, the per-row admitted/expired masks and the leftover units."""
    from ..admission.functional_qos import qos_round

    state2, admitted, expired, leftover = qos_round(
        state, tenant_ids, tickets, alive, deadlines, now, free_units,
        max_units)
    return {"state": state2, "admitted": admitted, "expired": expired,
            "leftover": leftover}


def qos_round_scan_ref(state, tenant_ids, tickets, alive, deadlines, nows,
                       free_units, released, max_units: int):
    """Oracle for the K-round scan: K sequential `qos_scan_round` calls —
    admitted/expired rows leave the alive set, each round's released units
    join the pool before its replenish, the leftover carries.  Returns a
    dict with the final state, per-row admit/expire round indices (-1 =
    never) and the final free pool."""
    from ..admission.functional_qos import qos_scan_round

    n = tickets.shape[0]
    dev = tickets.device
    admit_round = torch.full((n,), -1, dtype=torch.int32, device=dev)
    expire_round = torch.full((n,), -1, dtype=torch.int32, device=dev)
    free = free_units
    for k in range(nows.shape[0]):
        state, adm, exp, free = qos_scan_round(
            state, tenant_ids, tickets, alive, deadlines, nows[k], free,
            released[k], max_units)
        admit_round = torch.where(adm, k, admit_round)
        expire_round = torch.where(exp, k, expire_round)
        alive = alive & ~adm & ~exp
    return {"state": state, "admit_round": admit_round,
            "expire_round": expire_round, "free": free}


# ---------------------------------------------------------- paged decode ----


def flash_decode_block(q, k, v, mask, m_prev, l_prev, acc_prev, *, scale):
    """One online-softmax block step of flash-decode, batched over leading
    dims.  q: (..., G, hd); k/v: (..., BS, hd); mask: (..., 1, BS) bool;
    m/l: (..., G, 1) f32; acc: (..., G, hd) f32.  Returns (m', l', acc')."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe), 0.0)
    alpha = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - m_safe),
                        0.0)
    l_new = l_prev * alpha + p.sum(-1, keepdim=True)
    acc_new = acc_prev * alpha + torch.matmul(p, v.float())
    return m_new, l_new, acc_new


def paged_decode_ref(q, k_pool, v_pool, block_tbl, lens):
    """Blockwise oracle for ragged paged decode — the plain version of the
    CUDA kernel.  q: (S, H, hd); k_pool/v_pool: (NB, BS, KV, hd);
    block_tbl: (S, MB) int32 (-1 = unallocated, read as block 0 and
    masked); lens: (S,) int32 valid tokens.  Token t of slot s lives at
    block ``block_tbl[s, t // BS]`` offset ``t % BS``.  The recurrence runs
    over the table columns for all (slot, kv head) rows at once; a column
    at or past a slot's length leaves its carry untouched.  Returns
    (S, H, hd) in q's dtype."""
    S, H, hd = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = block_tbl.shape[1]
    G = H // KV
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(S, KV, G, hd).float()
    lens = lens.to(torch.int64)
    tbl = block_tbl.to(torch.int64).clamp(min=0)
    m = torch.full((S, KV, G, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((S, KV, G, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((S, KV, G, hd), dtype=torch.float32, device=dev)
    tpos0 = torch.arange(BS, device=dev)
    for i in range(MB):
        b = tbl[:, i]
        kb = k_pool[b].permute(0, 2, 1, 3)   # (S, KV, BS, hd)
        vb = v_pool[b].permute(0, 2, 1, 3)
        mask = ((i * BS + tpos0)[None, :] < lens[:, None])[:, None, None, :]
        m2, l2, acc2 = flash_decode_block(qr, kb, vb, mask, m, l, acc,
                                          scale=scale)
        upd = (i * BS < lens)[:, None, None, None]
        m = torch.where(upd, m2, m)
        l = torch.where(upd, l2, l)
        acc = torch.where(upd, acc2, acc)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(S, H, hd).to(q.dtype)


def paged_gather_kv(pool, block_tbl, lens):
    """Dense view of a paged cache: ``(S, MB·BS, KV, hd)`` plus the
    per-token position array (-1 = empty)."""
    NB, BS, KV, hd = pool.shape
    S, MB = block_tbl.shape
    b = block_tbl.to(torch.int64).clamp(min=0)
    dense = pool[b].reshape(S, MB * BS, KV, hd)
    t = torch.arange(MB * BS, dtype=torch.int32, device=pool.device)[None, :]
    pos = torch.where(t < lens.to(torch.int32)[:, None], t, -1)
    return dense, pos


def decode_attention_ref(q, k, v, kv_pos, q_pos, *, window=0):
    """Single-token decode oracle with explicit KV slot positions.
    q: (B,H,hd); k/v: (B,C,KV,hd); kv_pos: (B,C) int32 (-1 = empty);
    q_pos: (B,) int32.  Returns (B,H,hd) in q's dtype."""
    B, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    kh = k.repeat_interleave(group, dim=2).float()
    vh = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bhd,bchd->bhc", q.float(), kh) / math.sqrt(hd)
    d = q_pos[:, None] - kv_pos
    mask = (kv_pos >= 0) & (d >= 0)
    if window > 0:
        mask &= d < window
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhc,bchd->bhd", p, vh).to(q.dtype)
