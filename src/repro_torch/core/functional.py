"""The paper's semaphore as a functional, batched construct on tensors —
the port of ``repro.core.functional``.

A batch of K concurrent ``take`` requests is linearized by row order; their
tickets are ``base + exclusive_prefix_rank``.  The waiting array is a
``bucket_seq`` vector: ``post_batch`` bumps the TWAHash buckets of the
granted ticket range, and a scheduler re-examines only the requests whose
bucket moved (``woken_mask``).

Every function is pure (it returns new tensors) and runs on whatever
device its inputs live on, without a host sync: no ``.item()``, no
boolean-mask indexing, no data-dependent shapes.  Counters are u32
carriers (int64 tensors, see :mod:`repro_torch.core.u32`); signed
distances are int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import u32
from .hashfn import TICKET_STRIDE

DEFAULT_TABLE_SIZE = 1024


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (shape-bucketing helper)."""
    return 1 << max(n - 1, 0).bit_length()


def scatter_set(dst: torch.Tensor, idx: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``dst.at[idx].set(src, mode="drop")`` along dim 0:
    entries whose index equals ``len(dst)`` (the reference's out-of-range
    sentinel) are dropped.  Valid indices must be unique.  Built as an
    inverse map over a buffer with one spare slot, then a gather, so it
    never raises on the sentinel and never syncs."""
    n = dst.shape[0]
    inv = torch.full((n + 1,), -1, dtype=torch.int64, device=dst.device)
    inv.scatter_(0, idx.to(torch.int64),
                 torch.arange(idx.shape[0], device=dst.device))
    inv = inv[:n]
    hit = (inv >= 0).view(-1, *([1] * (dst.dim() - 1)))
    return torch.where(hit, src[inv.clamp(min=0)], dst)


def put_rows_(dst: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              mask: torch.Tensor) -> None:
    """IN PLACE: ``dst[rows[i]] = vals[i]`` where ``mask[i]`` (valid rows
    unique) — the reference's masked ``.at[...].set(mode="drop")`` for
    buffers too large to copy (the KV pools).  Masked-out entries are
    redirected to the first valid entry with that entry's value, or, when
    none is valid, rewrite row 0 with its own contents: every write is
    well defined and no host sync is needed."""
    rows = rows.reshape(-1).to(torch.int64)
    vals = vals.reshape(rows.shape[0], *dst.shape[1:])
    mask = mask.reshape(-1)
    any_ = mask.any()
    j0 = mask.to(torch.int32).argmax().view(1)
    r0 = torch.where(any_, rows.index_select(0, j0), 0)
    v0 = torch.where(any_, vals.index_select(0, j0), dst[:1])
    keep = mask.view(-1, *([1] * (dst.dim() - 1)))
    dst.index_put_((torch.where(mask, rows, r0),),
                   torch.where(keep, vals, v0))


class SemaState(NamedTuple):
    """One functional semaphore."""

    ticket: torch.Tensor      # u32 scalar
    grant: torch.Tensor       # u32 scalar
    bucket_seq: torch.Tensor  # (table_size,) u32 — waiting-array sequences
    salt: torch.Tensor        # u32 scalar — the uintptr_t(L) of TWAHash


def make_sema(count: int, table_size: int = DEFAULT_TABLE_SIZE,
              salt: int = 0x9E3779B9, device=None) -> SemaState:
    """A semaphore of ``count`` units on ``device`` (None: the card,
    raising without CUDA)."""
    assert table_size > 0 and (table_size & (table_size - 1)) == 0
    z = dict(dtype=torch.int64, device=resolve_device(device, "make_sema"))
    return SemaState(ticket=torch.zeros((), **z),
                     grant=torch.full((), count & u32.MASK32, **z),
                     bucket_seq=torch.zeros((table_size,), **z),
                     salt=torch.full((), salt & u32.MASK32, **z))


def _sdist(grant, ticket) -> torch.Tensor:
    """Signed distance grant − ticket under the u32 wrap (int32)."""
    return u32.sdist(grant, ticket)


def twa_hash_u32(salt, ticket):
    return u32.add(salt, u32.mul(ticket, TICKET_STRIDE))


def bucket_index(state: SemaState, ticket) -> torch.Tensor:
    table = state.bucket_seq.shape[-1]
    return (twa_hash_u32(state.salt, ticket) & (table - 1)).to(torch.int32)


def take_batch(state: SemaState, requests: torch.Tensor):
    """Batched SemaTake.  ``requests`` (N,) bool in FIFO order.  Returns
    ``(state', tickets (N,) u32, admitted (N,) bool, buckets (N,) i32)``."""
    req = requests.to(torch.int64)
    ranks = torch.cumsum(req, 0) - req
    tickets = u32.add(state.ticket, ranks)
    admitted = requests & (_sdist(state.grant, tickets) > 0)
    new_state = state._replace(ticket=u32.add(state.ticket, req.sum()))
    return new_state, tickets, admitted, bucket_index(state, tickets)


def post_batch(state: SemaState, n) -> SemaState:
    """Batched SemaPost of ``n`` units: grant += n and poke the TWAHash
    buckets of the enabled ticket range [grant, grant+n)."""
    table = state.bucket_seq.shape[-1]
    offs = torch.arange(table, dtype=torch.int64,
                        device=state.bucket_seq.device)
    enabled = offs < n
    idx = bucket_index(state, u32.add(state.grant, offs))
    bump = torch.zeros_like(state.bucket_seq).scatter_add_(
        0, idx.to(torch.int64), enabled.to(torch.int64))
    return state._replace(grant=u32.add(state.grant, n),
                          bucket_seq=u32.add(state.bucket_seq, bump))


def woken_mask(state: SemaState, observed_seq: torch.Tensor,
               buckets: torch.Tensor) -> torch.Tensor:
    """True for waiters whose bucket sequence moved since ``observed_seq``."""
    return state.bucket_seq[buckets.to(torch.int64)] != observed_seq


def poll(state: SemaState, tickets: torch.Tensor) -> torch.Tensor:
    """Grant check for specific tickets (the short-term spin on Grant)."""
    return _sdist(state.grant, tickets) > 0


# -- block-paged pool (TWA semaphore over a circular free queue) --------------


class BlockPool(NamedTuple):
    """Demand-paged block allocator gated by a TWA semaphore: the
    semaphore's ``ticket``/``grant`` are the cursors of a circular free
    queue of block ids, ``grant − ticket`` is the free-block count, and
    blocks are refcounted (see ``repro.core.functional.BlockPool``)."""

    sema: SemaState        # ticket/grant u32 — free blocks = grant − ticket
    free_q: torch.Tensor   # (NB,) i32 — circular queue of free block ids
    refcnt: torch.Tensor   # (NB,) i32 — live references per block
    gen: torch.Tensor      # (NB,) u32 — bumped on free


def make_block_pool(num_blocks: int, table_size: int = 64,
                    salt: int = 0x9E3779B9, start: int = 0,
                    device=None) -> BlockPool:
    """Fresh pool: all blocks free.  ``start`` offsets both counters (and
    rotates the queue to match) so tests can park the cursors below the
    2³² wrap.  ``device=None`` is the card (raises without CUDA)."""
    device = resolve_device(device, "make_block_pool")
    assert num_blocks > 0 and (num_blocks & (num_blocks - 1)) == 0, \
        "num_blocks must be a power of two (wrap-safe queue positions)"
    sema = make_sema(count=num_blocks, table_size=table_size, salt=salt,
                     device=device)
    sema = sema._replace(ticket=u32.add(sema.ticket, start),
                         grant=u32.add(sema.grant, start))
    ids = torch.arange(num_blocks, dtype=torch.int32, device=device)
    pos = (start + torch.arange(num_blocks, dtype=torch.int64,
                                device=device)) & (num_blocks - 1)
    free_q = torch.zeros(num_blocks, dtype=torch.int32,
                         device=device).scatter_(0, pos, ids)
    return BlockPool(sema=sema, free_q=free_q,
                     refcnt=torch.zeros(num_blocks, dtype=torch.int32,
                                        device=device),
                     gen=torch.zeros(num_blocks, dtype=torch.int64,
                                     device=device))


def pool_free_count(pool: BlockPool) -> torch.Tensor:
    """Free blocks — the paper's counter identity, i32 scalar."""
    return _sdist(pool.sema.grant, pool.sema.ticket)


def pool_alloc(pool: BlockPool, counts: torch.Tensor, max_per: int):
    """Batched wrap-safe take: consumer ``s`` receives ``counts[s]`` block
    ids (row ``s`` of the returned ``(S, max_per)`` table, -1 padded) from
    the free queue in cursor order.  The caller guarantees ``sum(counts) ≤
    pool_free_count``.  Returns ``(pool', ids)``."""
    counts = counts.to(torch.int32)
    NB = pool.free_q.shape[0]
    dev = counts.device
    cum = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    k = torch.arange(max_per, dtype=torch.int32, device=dev)
    take = k[None, :] < counts[:, None]
    pos = (pool.sema.ticket + cum[:, None].to(torch.int64)
           + k[None, :].to(torch.int64)) & (NB - 1)
    ids = torch.where(take, pool.free_q[pos], -1)
    sema = pool.sema._replace(
        ticket=u32.add(pool.sema.ticket, counts.to(torch.int64).sum()))
    refcnt = pool.refcnt.scatter_add(
        0, torch.where(take, ids, 0).reshape(-1).to(torch.int64),
        take.reshape(-1).to(torch.int32))
    return pool._replace(sema=sema, refcnt=refcnt), ids


def pool_release(pool: BlockPool, ids: torch.Tensor,
                 mask: torch.Tensor) -> BlockPool:
    """Batched decref-then-``post``: every non-negative id in the rows
    selected by ``mask`` drops one reference; a block whose refcount hits
    zero re-enters the free queue at the grant cursor (ascending id order)
    and the semaphore posts, poking the enabled range's buckets.  Each
    freed block's ``gen`` bumps.  Identity on an empty mask."""
    NB = pool.free_q.shape[0]
    valid = mask[:, None] & (ids >= 0) if ids.dim() == 2 else mask & (ids >= 0)
    flat = ids.reshape(-1)
    vflat = valid.reshape(-1)
    cnt = torch.zeros(NB, dtype=torch.int32, device=ids.device).scatter_add_(
        0, torch.where(vflat, flat, 0).to(torch.int64), vflat.to(torch.int32))
    refcnt = pool.refcnt - cnt
    freed = (cnt > 0) & (refcnt == 0)
    fu = freed.to(torch.int64)
    rank = torch.cumsum(fu, 0) - fu
    pos = (pool.sema.grant + rank) & (NB - 1)
    free_q = scatter_set(pool.free_q, torch.where(freed, pos, NB),
                         torch.arange(NB, dtype=torch.int32,
                                      device=ids.device))
    return BlockPool(sema=post_batch(pool.sema, fu.sum()), free_q=free_q,
                     refcnt=refcnt, gen=u32.add(pool.gen, fu))


def pool_incref(pool: BlockPool, ids: torch.Tensor,
                mask: torch.Tensor) -> BlockPool:
    """Attach further references (prefix sharing): every non-negative id
    selected by ``mask`` gains one.  No counter moves, no queue traffic,
    no poke — only the last `pool_release` of a block posts."""
    valid = (mask & (ids >= 0)).reshape(-1)
    refcnt = pool.refcnt.scatter_add(
        0, torch.where(valid, ids.reshape(-1), 0).to(torch.int64),
        valid.to(torch.int32))
    return pool._replace(refcnt=refcnt)


def park_state(sema: SemaState, deficit: torch.Tensor):
    """Waiting-array park of a block waiter short ``deficit`` (≥ 1) units:
    it becomes runnable when ticket ``grant + deficit − 1`` is enabled, so
    it observes that ticket's TWAHash bucket and sequence.  Returns
    ``(bucket (…,) i32, observed_seq (…,) u32)``."""
    wake = u32.sub(u32.add(sema.grant, deficit.to(torch.int64) & u32.MASK32),
                   1)
    bucket = bucket_index(sema, wake)
    return bucket, sema.bucket_seq[bucket.to(torch.int64)]


def pool_try_alloc(pool: BlockPool, counts: torch.Tensor, max_per: int, *,
                   park: torch.Tensor, deficit: torch.Tensor):
    """Guarded batched take plus waiting-array park: ``counts`` rows take
    their blocks (`pool_alloc`; the caller's plan guarantees they fit),
    rows flagged in ``park`` record the `park_state` of their ``deficit``
    (on the pre-take semaphore).  Returns ``(pool', ids (S, max_per),
    bucket (S,) i32, seq (S,) u32)`` — bucket/seq are 0 where not
    parked."""
    new_pool, ids = pool_alloc(pool, counts, max_per)
    bucket, seq = park_state(pool.sema,
                             torch.clamp(deficit.to(torch.int32), min=1))
    return (new_pool, ids, torch.where(park, bucket, 0),
            torch.where(park, seq, 0))


# -- vectorized multi-semaphore (one per expert / per resource class) ---------


class MultiSemaState(NamedTuple):
    ticket: torch.Tensor  # (S,) u32
    grant: torch.Tensor   # (S,) u32


def make_multi_sema(counts, device=None) -> MultiSemaState:
    """``device=None`` is the card (raises without CUDA)."""
    grant = u32.u32(counts, device=resolve_device(device, "make_multi_sema"))
    return MultiSemaState(ticket=torch.zeros_like(grant), grant=grant)


def take_batch_multi(state: MultiSemaState, sema_ids: torch.Tensor,
                     mask: torch.Tensor, block: int = 1024):
    """N requests against S semaphores in one pass (MoE capacity
    admission).  ``sema_ids`` (N,) in [0, S); ``mask`` (N,) bool.  Returns
    ``(state', tickets (N,) u32, admitted (N,) bool)``: each row's ticket
    is its semaphore's ticket plus its FCFS rank among that semaphore's
    requests, and it is admitted while within the grant.  The rank is the
    reference's two-level blocked prefix (a per-block inclusive count plus
    the carried per-block base), O(N·S)."""
    S = state.ticket.shape[0]
    N = sema_ids.shape[0]
    pad = (-N) % block
    ids = sema_ids.to(torch.int64)
    onehot = torch.zeros((N + pad, S), dtype=torch.int64, device=ids.device)
    onehot[:N].scatter_(1, ids[:, None], mask.to(torch.int64)[:, None])
    onehot = onehot.reshape(-1, block, S)
    intra = torch.cumsum(onehot, 1)                 # inclusive in block
    block_tot = intra[:, -1, :]                     # (nb, S)
    base = torch.cumsum(block_tot, 0) - block_tot   # exclusive block base
    ranks = (base[:, None, :] + intra - onehot).reshape(-1, S)[:N]
    my_rank = torch.gather(ranks, 1, ids[:, None])[:, 0]
    tickets = u32.add(state.ticket[ids], my_rank)
    admitted = mask & (_sdist(state.grant[ids], tickets) > 0)
    new_ticket = u32.add(state.ticket, block_tot.sum(0))
    return state._replace(ticket=new_ticket), tickets, admitted


def post_batch_multi(state: MultiSemaState, counts) -> MultiSemaState:
    c = u32.u32(counts, device=state.grant.device)
    return state._replace(grant=u32.add(state.grant, c))


# -- per-segment reductions and ticket order -----------------------------------


def segment_counts(ids: torch.Tensor, mask: torch.Tensor, num_segments: int,
                   dtype=torch.int64) -> torch.Tensor:
    """Per-segment count of mask-true rows (a ``scatter_add_`` into a
    fixed-size buffer).  The default int64 result is a u32 carrier, as
    the reference's default ``uint32``."""
    return torch.zeros(num_segments, dtype=dtype,
                       device=ids.device).scatter_add_(
        0, ids.to(torch.int64), mask.to(dtype))


def bucket_histogram(buckets: torch.Tensor, mask: torch.Tensor,
                     table_size: int) -> torch.Tensor:
    """Waiting-array occupancy histogram: how many long-term waiters
    observe each TWAHash bucket.  Returns (table_size,) i32."""
    return segment_counts(buckets, mask, table_size, dtype=torch.int32)


def ticket_order(sema_ids: torch.Tensor, tickets: torch.Tensor,
                 num_semas: int) -> torch.Tensor:
    """Stable permutation putting every semaphore's rows in wrap-safe
    ticket order: the key is the signed ticket distance from the
    semaphore's first-seen ticket.  Shared by `live_fifo_rank` and the
    QoS kernel wrapper, which must sort identically."""
    n = tickets.shape[0]
    dev = tickets.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    ids = sema_ids.to(torch.int64)
    first_row = torch.full((num_semas,), n, dtype=torch.int64,
                           device=dev).scatter_reduce_(
        0, ids, torch.arange(n, device=dev), reduce="amin")
    ref = tickets[first_row.clamp(0, n - 1)]
    key = _sdist(tickets, ref[ids])
    return torch.argsort(key, stable=True)


def live_fifo_rank(sema_ids: torch.Tensor, tickets: torch.Tensor,
                   alive: torch.Tensor, num_semas: int) -> torch.Tensor:
    """Rank of each row among the *alive* rows of its semaphore, in ticket
    order (dead rows are transparent); dead rows get rank N.  A per-tenant
    exclusive prefix count over the ticket-ordered rows — the same
    integers as the reference's blocked one-hot prefix."""
    n = tickets.shape[0]
    dev = tickets.device
    order = ticket_order(sema_ids, tickets, num_semas)
    ids_s = sema_ids.to(torch.int64)[order]
    alive_s = alive[order]
    onehot = ((ids_s[:, None] == torch.arange(num_semas, device=dev)[None])
              & alive_s[:, None]).to(torch.int32)
    ranks = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
    my = ranks.gather(1, ids_s[:, None])[:, 0]
    rank = torch.zeros(n, dtype=torch.int32, device=dev).scatter_(0, order, my)
    return torch.where(alive, rank, n)


def live_fifo_rank_pairwise(sema_ids: torch.Tensor, tickets: torch.Tensor,
                            alive: torch.Tensor) -> torch.Tensor:
    """O(N²) pairwise form of :func:`live_fifo_rank` — the equivalence
    oracle and the benchmark baseline."""
    n = tickets.shape[0]
    same = sema_ids[:, None] == sema_ids[None, :]
    before = _sdist(tickets[:, None], tickets[None, :]) > 0
    rank = (same & before & alive[None, :]).to(torch.int32).sum(
        1, dtype=torch.int32)
    return torch.where(alive, rank, n)
