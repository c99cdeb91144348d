"""Plain PyTorch oracles for the ported kernels — the port of
``repro.kernels.ref`` for this slice's functions.  Each CUDA kernel is
held against these on the card, and the CPU tests hold these against the
JAX package's oracles."""

from __future__ import annotations

import math
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from ..core import u32
from ..core.functional import put_rows_
from ..core.hashfn import TICKET_STRIDE
from ..parallel.sharding import constrain

NEG_INF = float("-inf")


# ------------------------------------------------------------ sema_batch ----


def sema_batch_ref(ticket, grant, bucket_seq, requests, post_n, salt):
    """Oracle of the batched semaphore pass (take + post + wake for a
    vector of requests).  ``ticket``/``grant``/``post_n``/``salt`` are u32
    carriers (0-dim tensors or ints), ``bucket_seq`` (T,) u32 carriers with
    T a power of two, ``requests`` (N,) bool.  Returns a dict with the new
    ticket, grant and bucket_seq, and per row the ticket, the admitted
    mask, the bucket and the woken mask (its bucket moved this pass)."""
    T = bucket_seq.shape[0]
    dev = bucket_seq.device
    ticket, grant, post_n, salt = (u32.u32(x, device=dev) for x in (
        ticket, grant, post_n, salt))
    req = requests.to(torch.int64)
    ranks = torch.cumsum(req, 0) - req
    tickets = u32.add(ticket, ranks)
    admitted = requests & (u32.sdist(grant, tickets) > 0)
    idx = (u32.add(salt, u32.mul(tickets, TICKET_STRIDE)) & (T - 1)).to(
        torch.int32)
    # post: grant advances by post_n; the enabled range's buckets bump
    offs = torch.arange(T, dtype=torch.int64, device=dev)
    enabled = offs < post_n
    post_idx = u32.add(salt, u32.mul(u32.add(grant, offs), TICKET_STRIDE)) \
        & (T - 1)
    bump = torch.zeros(T, dtype=torch.int64, device=dev).scatter_add_(
        0, post_idx, enabled.to(torch.int64))
    new_seq = u32.add(bucket_seq, bump)
    i64 = idx.to(torch.int64)
    woken = requests & (new_seq[i64] != bucket_seq[i64])
    return {"ticket": u32.add(ticket, req.sum()), "grant": u32.add(grant,
                                                                    post_n),
            "bucket_seq": new_seq, "tickets": tickets, "admitted": admitted,
            "bucket": idx, "woken": woken}


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


def qos_live_rank(tenant_ids, tickets, live, num_tenants: int):
    """The QoS kernel's order-free rank, for the CPU tests: each tenant's
    first-seen row (over all rows), each live row's key the signed 32-bit
    distance of its ticket from that row's ticket, and a sort of (tenant,
    key, row) packed into one 64-bit key as the kernel packs it (tenant in
    bits 48–55, the key biased by 2³¹ in 16–47, the row in 0–15; a row
    that is not live sorts last).  A live row's rank is its sorted
    position less its tenant's first one — the count of live rows of its
    tenant with a smaller ``(key, row)``.  Rows not live get N, as
    `core.functional.live_fifo_rank` gives them.  Returns (N,) i32."""
    n = tickets.shape[0]
    assert n <= 1 << 16, "the packed key holds a 16-bit row"
    dev = tickets.device
    ids = tenant_ids.to(torch.int64)
    rows = torch.arange(n, device=dev)
    first = torch.full((num_tenants,), n, dtype=torch.int64,
                       device=dev).scatter_reduce_(0, ids, rows,
                                                   reduce="amin")
    d = u32.sub(tickets.to(torch.int64), tickets[first[ids].clamp(max=n - 1)]
                .to(torch.int64)) if n else rows
    packed = (ids << 48) | ((d ^ (1 << 31)) << 16) | rows
    packed = torch.where(live, packed, torch.iinfo(torch.int64).max)
    order = torch.sort(packed).indices
    depth = torch.zeros(num_tenants, dtype=torch.int64,
                        device=dev).scatter_add_(0, ids, live.to(torch.int64))
    start = torch.cumsum(depth, 0) - depth
    pos = torch.empty(n, dtype=torch.int64, device=dev).scatter_(0, order,
                                                                 rows)
    return torch.where(live, pos - start[ids], n).to(torch.int32)


def qos_round_kernel_ref(state, tenant_ids, tickets, alive, deadlines, now,
                         free_units, max_units: int):
    """The QoS kernel's round in its own order, for the CPU tests: expire,
    replenish as `functional_qos` does, admit by `qos_live_rank` (a live
    row is admitted iff its rank is below its tenant's avail), each
    tenant's spend in closed form ``min(depth, max(avail, 0))``, reclaim.
    Returns ``(state', admitted, expired, leftover)``."""
    from ..admission import functional_qos as fq
    from ..core.functional import segment_counts

    S = state.ticket.shape[0]
    state, live, expired = fq.qos_expire(state, tenant_ids, alive,
                                         deadlines, now)
    depth = segment_counts(tenant_ids, live, S, dtype=torch.int32)
    state, _, leftover = fq.qos_replenish(state, free_units, depth,
                                          max_units)
    av = fq.avail(state)
    rank = qos_live_rank(tenant_ids, tickets, live, S)
    admitted = live & (rank < av[tenant_ids.to(torch.int64)])
    spent = torch.clamp(torch.minimum(depth, av), min=0)
    state = state._replace(consumed=u32.add(state.consumed,
                                            spent.to(torch.int64)))
    state, reclaimed = fq.qos_reclaim(state, depth - spent)
    return state, admitted, expired, leftover + reclaimed


_INF_BITS = 0x7F800000   # f32 +inf: crossings are >= 0
_WARPS = 32              # the large kernel's row chunks, one a warp


def _cross_bits(weight, vpass, unmet, k):
    """Bits (u32 carriers) of each tenant's ``k``-th crossing ``vpass +
    k/w`` as the kernels compute it: +inf at ``k >= unmet`` or ``w <=
    0``; correctly rounded division and addition."""
    kf = k.to(torch.float32)
    step = torch.where(weight > 0, kf / weight, torch.inf)
    step = torch.where(k == 0, 0.0, step)
    cross = torch.where(kf < unmet.to(torch.float32), vpass + step,
                        torch.inf)
    return cross.view(torch.int32).to(torch.int64) & u32.MASK32


def _count_below(weight, vpass, unmet, cand: int, max_units: int):
    """Per tenant, its crossings ``k < unmet`` whose key lies below
    ``cand``: a binary search over k, since a tenant's keys do not
    decrease with k (the large kernel's ``count_below``)."""
    lo = torch.zeros_like(unmet)
    hi = unmet.clone()
    for _ in range(max_units.bit_length() + 1):
        mid = (lo + hi) // 2
        below = _cross_bits(weight, vpass, unmet, mid) < cand
        act = lo < hi
        lo = torch.where(act & below, mid + 1, lo)
        hi = torch.where(act & ~below, mid, hi)
    return lo


def qos_round_large_ref(state, tenant_ids, tickets, alive, deadlines, now,
                        free_units, max_units: int, order=None):
    """The QoS kernel's large path in its own order, for the CPU tests
    (``qos_round_large_kernel`` of ``csrc/qos_admission.cu``): the rows
    sorted by `core.functional.ticket_order` (a row whose tenant id lies
    outside [0, S) gets a tenant of its own and is never live), unless
    ``order`` is given; the sorted rows cut into 32 chunks of whole
    32-row steps; live rows counted per (chunk, tenant) and newly expired
    per tenant; an exclusive scan over the chunks gives each chunk its
    rank bases and the live depth; the replenish by per-tenant binary
    searches under the 32-step bit-descend, ties flowing in tenant
    order; the poke over (bucket, tenant) pairs; a live row's rank its
    chunk's base plus its tenant's live rows before it in the chunk;
    each tenant's spend in closed form; the reclaim.  Returns
    ``(state', admitted, expired, leftover)``."""
    from ..admission.functional_qos import STRIDE_INV
    from ..core.functional import ticket_order
    from ..core.hashfn import MIX32KA

    n = tickets.shape[0]
    S = state.ticket.shape[0]
    T = state.bucket_seq.shape[0]
    dev = tickets.device
    I32 = torch.int32
    ids = tenant_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < S)
    safe = torch.where(valid, ids, S)
    if order is None:
        order = ticket_order(safe, tickets, S + 1)
    now = torch.as_tensor(now, dtype=torch.float32, device=dev)
    free = torch.as_tensor(free_units, device=dev).to(I32).reshape(())

    # (0) the sorted rows in chunks: live rows per (chunk, tenant), newly
    # expired per tenant
    t_s = safe[order]
    a_s = valid[order] & alive[order]
    newly_s = a_s & (deadlines[order] <= now)
    live_s = a_s & ~newly_s
    chunk = -(-n // 1024) * 32
    c_s = torch.arange(n, device=dev) // max(chunk, 1)
    cnt = torch.zeros(_WARPS, S + 1, dtype=I32, device=dev).index_put_(
        (c_s, t_s), live_s.to(I32), accumulate=True)[:, :S]
    deadb = torch.zeros(S + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, t_s, newly_s.to(torch.int64))[:S]
    base = torch.cumsum(cnt, 0, dtype=I32) - cnt
    depth = cnt.sum(0, dtype=I32)

    # (2) the closed-form weighted stride replenish
    w, vp = state.weight, state.vpass
    avail0 = u32.sdist(state.grant, state.consumed)
    unmet = torch.clamp(depth - avail0, 0, max_units).to(torch.int64)

    def below(cand):
        return _count_below(w, vp, unmet, cand, max_units)

    take = min(max(int(free), 0), max_units, int(below(_INF_BITS).sum()))
    theta = 0
    for b in range(32):
        cand = theta | (1 << (31 - b))
        if int(below(cand).sum()) < take:
            theta = cand
    lt = below(theta)
    eq = below(theta + 1) - lt
    rem = take - int(lt.sum())
    exc = torch.cumsum(eq, 0) - eq
    alloc = lt + torch.minimum(torch.clamp(rem - exc, min=0), eq)
    availr = avail0 + alloc.to(I32)
    dv = torch.where(alloc > 0, torch.where(w > 0, alloc.to(torch.float32) / w,
                                            torch.inf), 0.0)
    dead0 = u32.add(state.dead, deadb)
    outstanding = torch.clamp(u32.sdist(state.ticket, state.grant), min=0)
    width = u32.u32(torch.minimum(u32.to_bits32(u32.add(alloc, dead0)),
                                  outstanding))
    s_idx = torch.arange(S, dtype=torch.int64, device=dev)
    pstart = u32.add(u32.add(state.salt, u32.mul(s_idx + 1, MIX32KA)),
                     u32.mul(state.grant, TICKET_STRIDE))
    j = torch.arange(T, dtype=torch.int64, device=dev)[None, :]
    offs = u32.mul(u32.sub(j, pstart[:, None]), STRIDE_INV) & (T - 1)
    bump = (offs < width[:, None]).to(torch.int64).sum(0)

    # (3) the FCFS admit: a chunk's base plus the live rows of the row's
    # tenant before it in the chunk
    rank = torch.zeros(n, dtype=I32, device=dev)
    for c in range(_WARPS):
        lo, hi = c * chunk, min((c + 1) * chunk, n)
        if lo >= hi:
            break
        t = t_s[lo:hi]
        oh = (t[:, None] == s_idx[None, :]) & live_s[lo:hi, None]
        pre = torch.cumsum(oh.to(I32), 0, dtype=I32) - oh.to(I32)
        rank[lo:hi] = (pre.gather(1, t.clamp(max=S - 1)[:, None])[:, 0]
                       + base[c][t.clamp(max=S - 1)])
    adm_s = live_s & (rank < availr[t_s.clamp(max=S - 1)])
    admitted = torch.zeros(n, dtype=torch.bool, device=dev).scatter_(
        0, order, adm_s)
    expired = torch.zeros(n, dtype=torch.bool, device=dev).scatter_(
        0, order, newly_s)

    # (4) reclaim, the spend in closed form
    sp = torch.clamp(torch.minimum(depth, availr), min=0)
    surplus = torch.clamp((availr - sp) - (depth - sp), min=0).to(
        torch.int64)
    new_state = state._replace(
        grant=u32.add(state.grant, alloc),
        consumed=u32.add(u32.add(state.consumed, sp.to(torch.int64)),
                         surplus),
        dead=dead0 - torch.minimum(dead0, surplus),
        vpass=vp + dv, bucket_seq=u32.add(state.bucket_seq, bump))
    leftover = (free - alloc.to(I32).sum(dtype=I32)
                + surplus.to(I32).sum(dtype=I32))
    return new_state, admitted, expired, leftover


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


# ------------------------------------------------------------- attention ---


def tf32_split(x):
    """``x`` (f32) as ``(hi, lo)`` with ``hi = tf32(x)`` and ``lo =
    tf32(x − hi)``, each rounded as ``cvt.rna.tf32.f32`` rounds: to the
    nearest 10-bit mantissa, ties away from zero, on the int32 view (add
    0x1000, clear the low 13 bits).  The flash kernel splits both
    operands of every product so."""
    def rna(t):
        return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float().contiguous()
    hi = rna(x)
    return hi, rna((x - hi).contiguous())


def einsum_3xtf32(eq, a, b):
    """``torch.einsum(eq, a, b)`` with every product taken as the flash
    kernel takes it on the tensor cores, 3xTF32: ``lo·hi + hi·lo +
    hi·hi`` of the `tf32_split` halves, summed in f32 (the ``lo·lo`` term
    is dropped).  For the CPU tests of the kernel's arithmetic."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _online_softmax_block(carry, scale, q, k, v, mask, einsum=torch.einsum):
    """One KV-block step of the online-softmax recurrence.
    carry: (acc (B,H,Sq,hd) f32, m (B,H,Sq), l (B,H,Sq)); q: (B,H,Sq,hd);
    k/v: (B,H,Sk,hd); mask: (B,1|H,Sq,Sk) bool (True = keep); ``einsum``
    takes the two products.  P enters P·V rounded to v's dtype (a no-op
    in f32), as the reference rounds it; ``l`` sums the unrounded P."""
    acc, m, l = carry
    s = einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, -torch.inf)
    m_new = torch.maximum(m, s.amax(-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + einsum(
        "bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return acc_new, m_new, l_new


def blockwise_attention(q, k, v, q_positions, kv_positions, *, window: int = 0,
                        kv_block: int = 1024, causal: bool = True,
                        einsum=torch.einsum):
    """Flash-style attention with O(S) memory — the plain version of the
    flash kernel.  q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd); positions
    give each row's absolute index (-1 = empty key).  GQA by head
    repetition.  window > 0 keeps key j for query i iff 0 ≤ i−j < window.
    Returns (B, Sq, H, hd) in q's dtype; a row with no key gives 0.
    ``einsum=einsum_3xtf32`` (tests only) takes the products as the
    kernel's tensor cores do.  Under autograd each KV block is
    checkpointed when there is more than one, as in the reference, so
    backward recomputes a block's scores and probabilities instead of
    keeping all of them: O(S) activations, not O(S²)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    assert H % KV == 0
    group = H // KV
    scale = 1.0 / math.sqrt(hd)
    qh = q.permute(0, 2, 1, 3)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(group, dim=1)
    # under a mesh, the repeated KV takes q's head sharding (the
    # reference's constraint points; no-ops on plain tensors)
    kh = constrain(kh, "batch", "heads", "seq")
    vh = constrain(vh, "batch", "heads", "seq")
    qh = constrain(qh, "batch", "heads", "seq")
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    kv_block = max(1, min(kv_block, Sk))
    step = _online_softmax_block
    if torch.is_grad_enabled() and kv_block < Sk:
        step = partial(checkpoint, _online_softmax_block, use_reentrant=False)
    for j0 in range(0, Sk, kv_block):
        kp = kv_positions[:, j0:j0 + kv_block]
        dpos = q_positions[:, None, :, None] - kp[:, None, None, :]
        mask = kp[:, None, None, :] >= 0
        if causal:
            mask = mask & (dpos >= 0)
        if window > 0:
            mask = mask & (dpos < window)
        acc, m, l = step((acc, m, l), scale, qh, kh[:, :, j0:j0 + kv_block],
                         vh[:, :, j0:j0 + kv_block], mask, einsum)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def single_query_attention(q, k, v, q_positions, kv_positions, *,
                           window: int = 0, return_lse: bool = False):
    """Decode-path attention (Sq == 1) against a KV cache, computed
    densely — the plain version of the decode kernel.  q: (B, 1, H, hd);
    k/v: (B, C, KV, hd); q_positions (B, 1); kv_positions (B, C) with -1
    for empty rows.  Returns (B, 1, H, hd) in q's dtype, P rounded to v's
    dtype before P·V as the reference rounds it (``l`` sums the unrounded
    P); with ``return_lse`` the output stays f32 (a partial for
    `parallel.shard_attention.lse_merge`, rounded once after the merge)
    beside the (B, H) log-sum-exp of each row's visible scores, ``m + log
    l`` (−inf where none is visible)."""
    B, Sq, H, hd = q.shape
    C, KV = k.shape[1], k.shape[2]
    assert Sq == 1 and H % KV == 0
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = constrain(q.reshape(B, KV, G, hd), "batch", None, None, None)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), k.float()) * scale
    s = constrain(s, "batch", None, None, "seq_kv")
    dpos = q_positions[:, None, None, :] - kv_positions[:, None, None, :]
    mask = (kv_positions[:, None, None, :] >= 0) & (dpos >= 0)
    if window > 0:
        mask = mask & (dpos < window)
    s = torch.where(mask, s, -torch.inf)
    mx = s.amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    p = torch.where(mask, torch.exp(s - mx), 0.0)
    l = p.sum(-1, keepdim=True)
    ctx = torch.einsum("bkgc,bckd->bkgd", p.to(v.dtype).float(),
                       v.float()) / torch.clamp(l, min=1e-30)
    ctx = ctx.reshape(B, 1, H, hd)
    if return_lse:
        lse = torch.where(l > 0, mx + torch.log(l), -torch.inf)
        return constrain(ctx, "batch", "seq", "heads"), lse.reshape(B, H)
    return constrain(ctx.to(q.dtype), "batch", "seq", "heads")


def mha_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """Naive O(S²) attention oracle.  q: (B, Sq, H, hd); k/v: (B, Sk, KV,
    hd).  GQA by head repetition, f32 softmax; ``q_offset`` is the
    absolute position of q row 0.  A row with no visible key gives 0."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    group = H // KV
    dev = q.device
    kh = k.repeat_interleave(group, dim=2).float()
    vh = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh) * (1.0 / math.sqrt(hd))
    d = ((torch.arange(Sq, device=dev) + q_offset)[:, None]
         - torch.arange(Sk, device=dev)[None, :])
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= d >= 0
    if window > 0:
        mask &= d < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)   # fully-masked rows
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).to(q.dtype)


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


def paged_decode_split_ref(q, k_pool, v_pool, block_tbl, lens, grid: int):
    """The paged-decode kernel's split-K arithmetic, for the CPU tests.
    Shapes as `paged_decode_ref`.  The live blocks of each (slot, kv head)
    pair cut among ``grid`` CTAs by `paged_decode.split_plan`, as the
    kernel cuts them on the card; each piece's partial ``(m, l, acc)`` per
    query row over the valid tokens of its blocks (-1 read as block 0),
    then per pair the log-sum-exp merge ``out = Σ e^{m_p − M} acc_p /
    Σ e^{m_p − M} l_p``; an idle slot outputs 0.  Returns ``(out,
    parts)`` with ``parts`` a list of ``(piece, m (G,), l (G,), acc (G,
    hd))``."""
    from .paged_decode import split_plan

    S, H, hd = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = block_tbl.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    lns = [min(int(n), MB * BS) for n in lens.tolist()]
    out = torch.zeros((S, H, hd), dtype=torch.float32, device=q.device)
    parts, by_pair = [], {}
    for piece in split_plan(lns, KV, BS, MB, grid):
        pr, k0, k1 = piece[:3]
        s, h = divmod(pr, KV)
        keys = torch.arange(k0 * BS, min(k1 * BS, lns[s]), device=q.device)
        blk = block_tbl[s].to(torch.int64).clamp(min=0)[keys // BS]
        kk = k_pool[blk, keys % BS, h].float()
        vv = v_pool[blk, keys % BS, h].float()
        sc = q[s, h * G:(h + 1) * G].float() @ kk.T * scale   # (G, keys)
        m = sc.amax(-1)
        p = torch.exp(sc - m[:, None])
        l, acc = p.sum(-1), p @ vv
        parts.append((piece, m, l, acc))
        by_pair.setdefault(pr, []).append((m, l, acc))
    for pr, ps in by_pair.items():
        m, l, acc = (torch.stack([x[i] for x in ps]) for i in range(3))
        w = torch.exp(m - m.amax(0))
        s, h = divmod(pr, KV)
        out[s, h * G:(h + 1) * G] = (w[..., None] * acc).sum(0) / torch.clamp(
            (w * l).sum(0), min=1e-30)[:, None]
    return out.to(q.dtype), parts


# --------------------------------------------------------- paged prefill ----


def paged_prefill_merge(chunk, tpos, off, length):
    """The chunk rows that land in one block position of every slot.
    ``chunk``: (S, CT, KV, hd) chunk K or V; ``tpos``: (BS,) absolute
    positions of the block's rows; ``off``/``length``: (S,) chunk start
    and token count.  Row t receives chunk row ``tpos[t] − off`` iff it
    lies in the chunk window (a row past CT receives zeros, as the
    reference's one-hot merge gives).  Returns ``(sel (S, BS) bool, upd
    (S, BS, KV, hd))`` — a gather where the TPU kernel used an exact 0/1
    matmul."""
    S, CT = chunk.shape[:2]
    off = off.to(torch.int64)[:, None]
    sel = (tpos[None, :] >= off) & (tpos[None, :] < off + length.to(
        torch.int64)[:, None])
    c = tpos[None, :] - off
    rows = torch.arange(S, device=chunk.device)[:, None]
    upd = chunk[rows, c.clamp(0, CT - 1)]
    upd = torch.where(((c >= 0) & (c < CT))[:, :, None, None], upd, 0.0)
    return sel, upd


# one online-softmax step with a per-query-row mask (..., Q, BS): the same
# recurrence as the decode step, which already takes any broadcastable mask
flash_prefill_block = flash_decode_block


def paged_prefill_ref(q, k_chunk, v_chunk, k_pool, v_pool, block_tbl, off,
                      lens):
    """Blockwise oracle of the ragged chunked-prefill kernel — the plain
    version of ``csrc/paged_prefill.cu``.

    q: (S, CT, H, hd) chunk queries; k_chunk/v_chunk: (S, CT, KV, hd) the
    chunk's new K/V rows; k_pool/v_pool: (NB, BS, KV, hd); block_tbl:
    (S, MB) int32 (-1 = unallocated: read as block 0, never written); off:
    (S,) chunk start positions (tokens already in the pool); lens: (S,)
    chunk lengths (0 = idle slot).  Token t of slot s lives at block
    ``block_tbl[s, t // BS]`` offset ``t % BS``.

    Returns ``(out (S, CT, H, hd), k_pool', v_pool')``, the pools new
    tensors with the chunk rows written (`paged_prefill_merge`); each chunk
    query attends causally within the chunk and fully to the prior tokens,
    one table column at a time (`flash_prefill_block`, with the
    reference's ``i·BS < off+len`` skip), batched over slots and kv
    heads."""
    S, CT, H, hd = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = block_tbl.shape[1]
    G = H // KV
    Q = G * CT
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qr = (q.reshape(S, CT, KV, G, hd).permute(0, 2, 3, 1, 4)
          .reshape(S, KV, Q, hd).float())
    off64, len64 = off.to(torch.int64), lens.to(torch.int64)
    rows_q = torch.arange(Q, device=dev) % CT
    qpos = off64[:, None] + rows_q[None, :]                  # (S, Q)
    qvalid = rows_q[None, :] < len64[:, None]
    tbl = block_tbl.to(torch.int64)
    m = torch.full((S, KV, Q, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((S, KV, Q, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((S, KV, Q, hd), dtype=torch.float32, device=dev)
    kp2, vp2 = k_pool.clone(), v_pool.clone()
    for i in range(MB):
        b = tbl[:, i].clamp(min=0)
        tpos = i * BS + torch.arange(BS, device=dev)
        sel, ku = paged_prefill_merge(k_chunk, tpos, off64, len64)
        _, vu = paged_prefill_merge(v_chunk, tpos, off64, len64)
        kblk = torch.where(sel[:, :, None, None], ku, k_pool[b])
        vblk = torch.where(sel[:, :, None, None], vu, v_pool[b])
        mask = (qvalid[:, :, None]
                & (tpos[None, None, :] <= qpos[:, :, None]))[:, None]
        m2, l2, acc2 = flash_prefill_block(
            qr, kblk.permute(0, 2, 1, 3), vblk.permute(0, 2, 1, 3), mask,
            m, l, acc, scale=scale)
        upd = (i * BS < off64 + len64) & (len64 > 0)
        u4 = upd[:, None, None, None]
        m = torch.where(u4, m2, m)
        l = torch.where(u4, l2, l)
        acc = torch.where(u4, acc2, acc)
        # the merged block goes back where the column overlaps the chunk
        wr = upd & (i * BS + BS > off64) & (tbl[:, i] >= 0)
        put_rows_(kp2.view(NB, -1), b, kblk, wr)
        put_rows_(vp2.view(NB, -1), b, vblk, wr)
    out = acc / torch.clamp(l, min=1e-30)
    out = (out.reshape(S, KV, G, CT, hd).permute(0, 3, 1, 2, 4)
           .reshape(S, CT, H, hd).to(q.dtype))
    return out, kp2, vp2


def paged_prefill_split_ref(q, k_chunk, v_chunk, k_pool, v_pool, block_tbl,
                            off, lens, grid: int, einsum=torch.einsum):
    """The paged-prefill kernel's split-K arithmetic, for the CPU tests.
    Shapes as `paged_prefill_ref`.  The tiles (slot, kv head, R chunk
    rows) and their costs as `paged_prefill.tile_costs` counts them; the
    key tiles cut among ``grid`` CTAs by `paged_prefill.split_plan`, as
    the kernel cuts them on the card.  Each piece's partial ``(m, l,
    acc)`` per query row over the keys of its 16-key tiles that the row
    sees (keys below ``off`` from the pool through the table, -1 read as
    block 0; from ``off`` on from the chunk; ``m = -inf``, ``l = 0``,
    ``acc = 0`` where it sees none), then per tile the log-sum-exp merge
    ``out = Σ e^{m_p − M} acc_p / Σ e^{m_p − M} l_p``.  The chunk rows go
    into the pools as the kernel writes them, one row copy each.
    ``einsum`` takes the two products (`einsum_3xtf32` for the kernel's
    tensor-core arithmetic).  Returns ``(out, k_pool', v_pool', parts)``
    with ``parts`` a list of ``(piece, m (Q,), l (Q,), acc (Q, hd))``,
    query row r = jj·G + g of the tile."""
    from .paged_prefill import KEY_TILE, split_plan, tile_costs

    S, CT, H, hd = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = block_tbl.shape[1]
    G = H // KV
    n = MB * BS
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    offs, lns = off.tolist(), lens.tolist()
    costs, R = tile_costs(offs, lns, CT, H, KV, BS, MB)
    ntiles = -(-CT // R)
    pos = torch.arange(n, device=dev)
    out = torch.zeros_like(q, dtype=torch.float32)
    parts, by_tile = [], {}
    for piece in split_plan(costs, grid):
        t, k0, k1 = piece[:3]
        s, h, j0 = t // (KV * ntiles), t // ntiles % KV, t % ntiles * R
        o, ln = offs[s], min(lns[s], CT)
        nrow = min(R, CT - j0)
        nvalid = max(0, min(nrow, ln - j0))
        kend = min(o + j0 + nvalid, n)
        keys = pos[k0 * KEY_TILE:min(kend, k1 * KEY_TILE)]
        blk = block_tbl[s].to(torch.int64).clamp(min=0)[keys // BS]
        c = (keys - o).clamp(0, CT - 1)
        prior = (keys < o)[:, None]
        kk = torch.where(prior, k_pool[blk, keys % BS, h], k_chunk[s, c, h])
        vv = torch.where(prior, v_pool[blk, keys % BS, h], v_chunk[s, c, h])
        jj = torch.arange(nrow * G, device=dev) // G
        qq = q[s, j0 + jj, h * G + torch.arange(nrow * G, device=dev) % G]
        vis = (jj[:, None] < nvalid) & (keys[None, :] <= o + j0 + jj[:, None])
        sc = einsum("qd,kd->qk", qq.float(), kk.float()) * scale
        sc = torch.where(vis, sc, NEG_INF)
        m = sc.amax(-1)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(vis, torch.exp(sc - m_safe[:, None]), 0.0)
        l, acc = p.sum(-1), einsum("qk,kd->qd", p, vv.float())
        parts.append((piece, m, l, acc))
        by_tile.setdefault(t, []).append((m, l, acc, s, h, j0, nrow))
    for t, ps in by_tile.items():
        m, l, acc = (torch.stack([x[i] for x in ps]) for i in range(3))
        s, h, j0, nrow = ps[0][3:]
        M = m.amax(0)
        w = torch.where(torch.isfinite(m),
                        torch.exp(m - torch.where(torch.isfinite(M), M, 0.0)),
                        0.0)
        o_t = (w[..., None] * acc).sum(0) / torch.clamp(
            (w * l).sum(0), min=1e-30)[:, None]
        out[s, j0:j0 + nrow, h * G:(h + 1) * G] = o_t.reshape(nrow, G, hd)
    # the chunk rows into their blocks: row j of slot s at off + j
    off64, len64 = off.to(torch.int64), lens.to(torch.int64)
    jr = torch.arange(CT, device=dev)
    p_w = off64[:, None] + jr[None, :]                           # (S, CT)
    col = (p_w // BS).clamp(max=MB - 1)
    b = block_tbl.to(torch.int64).gather(1, col)
    wr = (jr[None, :] < len64[:, None]) & (p_w < n) & (b >= 0)
    kp2, vp2 = k_pool.clone(), v_pool.clone()
    for pool, ch in ((kp2, k_chunk), (vp2, v_chunk)):
        pool[b[wr], (p_w % BS)[wr]] = ch[wr]
    return out.to(q.dtype), kp2, vp2, parts


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


def decode_attention_split_ref(q, k, v, kv_pos, q_pos, *, window=0,
                               nsplit=1, rows=None):
    """The decode kernel's split-K arithmetic, for the CPU tests: the C
    cache rows cut into ``nsplit`` runs of ``R = rows`` (by default
    ``ceil(C / nsplit)``; the last run ragged, an empty run contributes
    nothing), as `decode_attention.split_plan` cuts them, each run's
    partial ``(m, l, acc)`` over its visible keys (``m = -inf``, ``l =
    0``, ``acc = 0`` where it sees none), then the log-sum-exp merge
    ``out = Σ_s e^{m_s − M} acc_s / Σ_s e^{m_s − M} l_s`` with ``M =
    max_s m_s``, each run's P rounded to v's dtype before P·V (``l``
    sums the unrounded P), the output in q's dtype.  Shapes as
    `decode_attention_ref`; a row with no visible key gives 0.  Returns ``(out, (m, l, acc))`` with the
    partials (B, KV, nsplit, G[, hd])."""
    B, H, hd = q.shape
    C, KV = k.shape[1], k.shape[2]
    G = H // KV
    R = rows or -(-C // nsplit)
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).float()
    d = q_pos[:, None] - kv_pos
    vis = (kv_pos >= 0) & (d >= 0)
    if window > 0:
        vis &= d < window
    ms, ls, accs = [], [], []
    for s in range(nsplit):
        rows = slice(s * R, min(C, (s + 1) * R))
        sc = torch.einsum("bkgd,bckd->bkgc", qg, k[:, rows].float()) * scale
        mask = vis[:, None, None, rows]
        sc = torch.where(mask, sc, NEG_INF)
        m = sc.amax(-1) if sc.shape[-1] else torch.full(
            sc.shape[:-1], NEG_INF, device=q.device)
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(mask, torch.exp(sc - m_safe[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgc,bckd->bkgd", p.to(v.dtype).float(),
                                 v[:, rows].float()))
    m, l, acc = (torch.stack(x, 2) for x in (ms, ls, accs))
    M = m.amax(2, keepdim=True)
    w = torch.where(torch.isfinite(m),
                    torch.exp(m - torch.where(torch.isfinite(M), M, 0.0)),
                    0.0)
    L = (w * l).sum(2)
    o = (w[..., None] * acc).sum(2) / torch.clamp(L, min=1e-30)[..., None]
    return o.reshape(B, H, hd).to(q.dtype), (m, l, acc)
