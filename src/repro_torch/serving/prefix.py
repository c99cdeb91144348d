"""Prompt-prefix cache on tensors — the port of ``repro.serving.prefix``,
the hash index behind refcounted block sharing.

* **Weak entries.**  An entry is ``(key, block id, generation)``, live iff
  the pool's per-block ``gen`` still equals the recorded one; freeing a
  block bumps its ``gen`` (`core.functional.pool_release`), so the cache
  holds no reference and never resurrects a reused block.
* **Content by hash.**  Keys are two independent FNV-1a u32 chains over
  the tokens (:func:`prompt_hashes`, on the host at submit); the
  ``(2, W+1)`` table rides the request as data and is never re-hashed on
  the device.  u32 keys and generations are u32 carriers (int64 tensors,
  `core.u32`).
* **Direct-mapped.**  ``E`` entries (a power of two), home ``key & (E−1)``;
  a colliding registration overwrites (the last writer wins).  A slot
  that completes prefill publishes one entry per full block and, for a
  partial tail block, one full-prompt entry with its ``filled`` count.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..core.functional import scatter_set
from ..device import resolve_device

# two independent FNV-1a chains — 64 bits of content identity
_OFF1, _PRIME1 = 0x811C9DC5, 0x01000193
_OFF2, _PRIME2 = 0x9E3779B9, 0x85EBCA6B
_M32 = 0xFFFFFFFF


class PrefixCache(NamedTuple):
    """Direct-mapped weak prefix index (all fields length E).  ``bid < 0``
    marks an empty entry; ``filled`` is the number of valid tokens in the
    block (``BS`` for a full-block entry, the tail length for a tail
    entry)."""

    key: torch.Tensor     # (E,) u32 — FNV chain 1 at the covered length
    key2: torch.Tensor    # (E,) u32 — FNV chain 2 (collision guard)
    bid: torch.Tensor     # (E,) i32 — block id (-1 = empty)
    gen: torch.Tensor     # (E,) u32 — pool.gen[bid] at registration
    filled: torch.Tensor  # (E,) i32 — valid tokens in the block


def make_prefix_cache(entries: int, device=None) -> PrefixCache:
    """An empty cache of ``entries`` (a power of two) on ``device``.
    ``None`` means the card, as everywhere in the port; CPU callers pass
    ``"cpu"``."""
    assert entries > 0 and (entries & (entries - 1)) == 0, \
        "prefix cache entries must be a power of two (key & (E-1) homes)"
    dev = resolve_device(device, "make_prefix_cache")
    z = dict(dtype=torch.int64, device=dev)
    return PrefixCache(
        key=torch.zeros(entries, **z), key2=torch.zeros(entries, **z),
        bid=torch.full((entries,), -1, dtype=torch.int32, device=dev),
        gen=torch.zeros(entries, **z),
        filled=torch.zeros(entries, dtype=torch.int32, device=dev))


def prompt_hashes(prompt: Sequence[int], block_size: int,
                  width: int) -> list[list[int]]:
    """Host-side hashing at submit: column ``j < width`` holds the chain
    values after ``(j+1)·BS`` tokens (the key of full block ``j``), column
    ``width`` the full-prompt values (the tail key); unreached boundaries
    stay 0."""
    h1, h2 = _OFF1, _OFF2
    row1, row2 = [0] * (width + 1), [0] * (width + 1)
    for i, t in enumerate(prompt):
        t = int(t) & _M32
        h1 = ((h1 ^ t) * _PRIME1) & _M32
        h2 = ((h2 ^ t) * _PRIME2) & _M32
        if (i + 1) % block_size == 0 and (i + 1) // block_size <= width:
            row1[(i + 1) // block_size - 1] = h1
            row2[(i + 1) // block_size - 1] = h2
    row1[width], row2[width] = h1, h2
    return [row1, row2]


def cache_lookup(cache: PrefixCache, pool, ph: torch.Tensor,
                 plen: torch.Tensor, block_size: int):
    """Longest-prefix probe for a batch of prompts.  ``ph``: (B, 2, W+1)
    u32 hash tables; ``plen``: (B,) prompt lengths.  Returns ``c`` (B,)
    matched full blocks (the longest unbroken chain from block 0), ``bids``
    (B, W) their ids (-1 beyond ``c``), ``tail_bid`` (B,) the shared tail
    block (-1 = no tail hit) and ``cov`` (B,) covered tokens (``c·BS`` or
    ``plen``), all int32."""
    E = cache.key.shape[0]
    NB = pool.gen.shape[0]
    W = ph.shape[2] - 1
    plen = plen.to(torch.int32)
    n_full = torch.clamp(plen // block_size, max=W)
    tail_len = plen - n_full * block_size

    def probe(k1, k2):
        idx = k1 & (E - 1)
        bid = cache.bid[idx]
        ok = ((bid >= 0) & (cache.key[idx] == k1) & (cache.key2[idx] == k2)
              & (pool.gen[torch.clamp(bid, 0, NB - 1).to(torch.int64)]
                 == cache.gen[idx]))
        return ok, bid, cache.filled[idx]

    ok_j, bid_j, fill_j = probe(ph[:, 0, :W], ph[:, 1, :W])  # (B, W)
    j = torch.arange(W, dtype=torch.int32, device=ph.device)[None, :]
    hit = ok_j & (fill_j == block_size) & (j < n_full[:, None])
    # longest unbroken chain from block 0
    c = torch.cumprod(hit.to(torch.int32), dim=1).sum(1, dtype=torch.int32)
    bids = torch.where(j < c[:, None], bid_j, -1)
    ok_t, bid_t, fill_t = probe(ph[:, 0, W], ph[:, 1, W])
    tail_hit = ok_t & (c == n_full) & (tail_len > 0) & (fill_t == tail_len)
    tail_bid = torch.where(tail_hit, bid_t, -1)
    cov = torch.where(tail_hit, plen, c * block_size)
    return c, bids, tail_bid, cov


def cache_register(cache: PrefixCache, pool, ph: torch.Tensor,
                   plen: torch.Tensor, tbl: torch.Tensor,
                   completed: torch.Tensor, block_size: int) -> PrefixCache:
    """Publish the prefixes of the slots flagged in ``completed`` (S,):
    one entry per full block (``filled = BS``) plus, for a partial tail
    block, one full-prompt entry (``filled = tail``).  Entries apply in
    (slot, boundary) order and the last valid writer of each home wins.

    The reference finds the winners with a pairwise "a later valid entry
    hits my home" sweep, O(N²) in N = S·(W+1).  Here each home takes the
    largest flat index of its valid entries (one ``scatter_reduce`` amax
    into an (E,) buffer) and an entry wins iff it is that index: the same
    function in O(N).  Identity on an empty mask."""
    E = cache.key.shape[0]
    NB = pool.gen.shape[0]
    W = ph.shape[2] - 1
    MB = tbl.shape[1]
    dev = tbl.device
    plen = plen.to(torch.int32)
    n_full = torch.clamp(plen // block_size, max=W)            # (S,)
    tail_len = plen - n_full * block_size
    j = torch.arange(W + 1, dtype=torch.int32, device=dev)[None, :]
    is_tail = j == W
    valid = completed[:, None] & (
        (j < n_full[:, None]) | (is_tail & (tail_len[:, None] > 0)))
    # a tail entry points at block n_full (the partially filled block)
    blk_ix = torch.where(is_tail, torch.clamp(n_full[:, None], max=MB - 1),
                         torch.clamp(j, max=MB - 1))
    bid = tbl.gather(1, blk_ix.to(torch.int64))                # (S, W+1)
    valid = (valid & (bid >= 0)).reshape(-1)
    k1 = ph[:, 0, :].reshape(-1)
    k2 = ph[:, 1, :].reshape(-1)
    bid = bid.reshape(-1)
    filled = torch.where(is_tail, tail_len[:, None],
                         block_size).to(torch.int32).reshape(-1)
    gen = pool.gen[torch.clamp(bid, 0, NB - 1).to(torch.int64)]
    idx = k1 & (E - 1)
    flat = torch.arange(idx.shape[0], device=dev)
    last = torch.full((E,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, idx, torch.where(valid, flat, -1), reduce="amax")
    win = valid & (last[idx] == flat)
    tgt = torch.where(win, idx, E)
    return PrefixCache(
        key=scatter_set(cache.key, tgt, k1),
        key2=scatter_set(cache.key2, tgt, k2),
        bid=scatter_set(cache.bid, tgt, bid),
        gen=scatter_set(cache.gen, tgt, gen),
        filled=scatter_set(cache.filled, tgt, filled))


def cache_clear(cache: PrefixCache) -> PrefixCache:
    """Drop every entry."""
    return cache._replace(bid=torch.full_like(cache.bid, -1))
