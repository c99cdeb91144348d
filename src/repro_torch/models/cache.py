"""Decode-time KV caches — the port of ``repro.models.cache`` for the
attention blocks (full and rolling sliding-window buffers).

A cache is a dict ``{"k", "v": (B, C, KV, hd), "pos": (B, C) int32 (-1 =
empty), "ptr": int32 write cursor}``.  The writes here go IN PLACE into
the caller's tensors (the reference returns new arrays; the port saves
the copy of the whole cache a functional update costs each decode step)
and return the same dict, the cursor advanced in place.  No write syncs with
the host: the cursor stays a device tensor and indexes through
``index_copy_``.

Not ported: the reference's shard_map ring write (``ring_write=True``,
a sequence-sharded cache) and the recurrent-state makers (mLSTM, sLSTM,
RG-LRU; ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import torch


def make_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype, device=None):
    """Zeroed K/V, every position empty, the scalar cursor at 0 (every
    row writes the same ring slot each step; per-row raggedness lives in
    ``pos``)."""
    z = dict(dtype=dtype, device=device)
    return {
        "k": torch.zeros((batch, capacity, n_kv, head_dim), **z),
        "v": torch.zeros((batch, capacity, n_kv, head_dim), **z),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
        "ptr": torch.zeros((), dtype=torch.int32, device=device),
    }


def kv_cache_write_prefill(cache, k, v, positions):
    """Bulk write a prefix: k/v (B, S, KV, hd), positions (B, S).  The
    whole cache is overwritten: S < C leaves zeros and -1 past the
    prefix; S > C keeps the last C tokens (sliding-window prefill)."""
    S = positions.shape[1]
    C = cache["k"].shape[1]
    n = min(S, C)
    for name, src in (("k", k), ("v", v), ("pos", positions)):
        dst = cache[name]
        dst[:, :n] = src[:, S - n:].to(dst.dtype)
        if n < C:
            dst[:, n:] = -1 if name == "pos" else 0
    cache["ptr"].add_(S)
    return cache


def kv_cache_append(cache, k, v, positions):
    """Append one token per row (decode): k/v (B, 1, KV, hd), positions
    (B, 1).  Every row writes ring slot ``ptr mod C`` — the reference's
    one-hot ``ring_write=False`` result, written as one slot."""
    C = cache["k"].shape[1]
    slot = (cache["ptr"] % C).to(torch.int64).reshape(1)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(1, slot, positions.to(torch.int32))
    cache["ptr"].add_(1)
    return cache
