"""Decode-time state — the port of ``repro.models.cache``: KV caches for
the attention blocks (full and rolling sliding-window buffers) and the
recurrent states of the mLSTM, sLSTM and RG-LRU blocks.

A cache is a dict ``{"k", "v": (B, C, KV, hd), "pos": (B, C) int32 (-1 =
empty), "ptr": int32 write cursor}``.  The writes here go IN PLACE into
the caller's tensors (the reference returns new arrays; the port saves
the copy of the whole cache a functional update costs each decode step)
and return the same dict, the cursor advanced in place.  No write syncs with
the host: the cursor stays a device tensor and indexes through
``index_copy_``.

A recurrent state has the reference's keys, shapes and dtypes; its block
copies the new state into these tensors in place (`models.transformer`).

Under a mesh a cache is DTensors laid out by `parallel.sharding.
cache_pspecs` (rows over the batch axes; the sequence over the ``seq_kv``
axes, the rows of a shard index ``data``-major under ``("data",
"model")``, as JAX's ``P(("data", "model"))``; else the KV heads over
``model``), and every write goes into each rank's local tensors: the
prefill writes the ring slots a rank holds, and the append is the port of
the reference's owning-shard write (``ring_write=True``,
``_ring_write_sharded``): the rank whose rows hold ``slot = ptr mod C``
writes ``slot − offset`` in place, the others write their own row back,
and the cursor stays replicated.  The cache it leaves equals the one-hot
write of the whole cache (``ring_write=False``) that the reference's
decode calls.
"""

from __future__ import annotations

import torch

from ..parallel.sharding import _shard_offset, is_dtensor, local_rows


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


def _local_new(cache, x):
    """The rank's part of a new K/V block ``x`` (B, S, KV, hd; a DTensor
    or a whole plain tensor) for a DTensor cache: its rows and KV heads as
    the cache places them, every sequence position."""
    from torch.distributed.tensor import DTensor, Replicate

    ck = cache["k"]
    pl = [Replicate() if p.is_shard(1) else p for p in ck.placements]
    if not is_dtensor(x):
        x = DTensor.from_local(x, ck.device_mesh,
                               [Replicate()] * ck.device_mesh.ndim,
                               run_check=False)
    return x.redistribute(ck.device_mesh, pl).to_local()


def prefill_shard(rows: dict, k, v, positions, offset: int, capacity: int):
    """`kv_cache_write_prefill` on one shard of a ring's sequence: ``rows``
    ``{"k", "v", "pos"}`` the shard's tensors (B, n, …), which hold ring
    slots ``offset .. offset + n − 1`` of ``capacity``; k/v (B, S, KV, hd)
    and positions (B, S) the shard's rows of the new tokens, every
    position.  Slot s takes token s (S ≤ C; empty past S) or the token
    t ≡ s mod C of the last C (S > C): the single-device layout."""
    S, C, n = positions.shape[1], capacity, rows["k"].shape[1]
    s = torch.arange(offset, offset + n, device=rows["k"].device)
    tok = S - C + torch.remainder(s - (S - C), C) if S > C else s
    keep = tok < S
    tok = torch.clamp(tok, max=S - 1)
    for name, src in (("k", k), ("v", v), ("pos", positions)):
        dst = rows[name]
        mask = keep.reshape((1, n) + (1,) * (dst.dim() - 2))
        dst.copy_(torch.where(mask, src.index_select(1, tok).to(dst.dtype),
                              -1 if name == "pos" else 0))


def split_cache(caches, shards: int):
    """A copy of ``caches`` whose ring caches hold their sequence as
    ``shards`` runs on one device, each run contiguous as a rank's
    sequence shard is: ``k``/``v`` (…, M, B, C/M, KV, hd), ``pos`` (…, M,
    B, C/M), the rows of run r being slots r·C/M …; the cursor and the
    recurrent states copied as they are.  The model writes such a cache
    run by run (`prefill_shard`, `ring_write_shard`) and merges the runs'
    decode attention (`parallel.shard_attention.sharded_decode_attention`):
    the meshed decode's arithmetic in one process."""
    if isinstance(caches, list):
        return [split_cache(c, shards) for c in caches]
    if "k" not in caches or not isinstance(caches["k"], torch.Tensor):
        return {n: (split_cache(c, shards) if isinstance(c, (dict, list))
                    else c.clone()) for n, c in caches.items()}

    def runs(x, d):  # (…, B, C, …) → (…, M, B, C/M, …), d the C axis
        C = x.shape[d]
        if C % shards:
            raise ValueError(f"a ring of {C} slots does not split "
                             f"{shards} ways")
        y = x.unflatten(d, (shards, C // shards))  # M at d − 1, then n
        return y.movedim(d - 1, d - 2).contiguous()

    return {"k": runs(caches["k"], -3), "v": runs(caches["v"], -3),
            "pos": runs(caches["pos"], -1), "ptr": caches["ptr"].clone()}


def _held_runs(cache, k, v, positions):
    """For a sharded ring — a DTensor cache (this rank's rows) or a split
    cache (its M runs) — the runs of the sequence this process holds as
    ``(rows, offset)``, the new tokens' part for them (their batch rows
    and KV heads) and the ring's capacity; None for a whole cache."""
    ck = cache["k"]
    if is_dtensor(ck):
        rows = {n: cache[n].to_local() for n in ("k", "v", "pos")}
        return ([(rows, _shard_offset(ck, 1))], _local_new(cache, k),
                _local_new(cache, v), local_rows(positions, ck), ck.shape[1])
    if ck.dim() == 5:  # a split cache
        M, n = ck.shape[0], ck.shape[2]
        return ([({x: cache[x][r] for x in ("k", "v", "pos")}, r * n)
                 for r in range(M)], k, v, positions, M * n)
    return None


def kv_cache_write_prefill(cache, k, v, positions):
    """Bulk write a prefix into an empty cache: k/v (B, S, KV, hd),
    positions (B, S).  The whole cache is overwritten: S < C leaves zeros
    and -1 past the prefix; S > C keeps the last C tokens (sliding-window
    prefill), token t in ring slot t mod C — the slot that
    `kv_cache_append` writes at cursor t — so the first append after the
    prefill overwrites the oldest token.  The reference writes those C
    tokens in slots 0..C−1, where an append then overwrites a key still
    inside the window unless C divides S (ROADMAP queue 3); the two
    layouts agree when it does.  A DTensor cache (under a mesh) is
    written rank by rank, a split cache run by run (`prefill_shard`)."""
    held = _held_runs(cache, k, v, positions)
    if held is not None:
        runs, k, v, pos, C = held
        for rows, off in runs:
            prefill_shard(rows, k, v, pos, off, C)
        cache["ptr"].add_(positions.shape[1])
        return cache
    S = positions.shape[1]
    C = cache["k"].shape[1]
    n = min(S, C)
    shift = S % C if S > C else 0
    for name, src in (("k", k), ("v", v), ("pos", positions)):
        dst = cache[name]
        dst[:, :n] = torch.roll(src[:, S - n:], shift, 1).to(dst.dtype)
        if n < C:
            dst[:, n:] = -1 if name == "pos" else 0
    cache["ptr"].add_(S)
    return cache


def ring_write_shard(rows: dict, k, v, positions, ptr, offset: int,
                     capacity: int):
    """`kv_cache_append` on one shard of a ring's sequence — the
    reference's owning-shard write (``_ring_write_sharded``): ``rows``
    ``{"k", "v", "pos"}`` the shard's tensors, which hold ring slots
    ``offset ..`` of ``capacity``; k/v (B, 1, KV, hd), positions (B, 1)
    the shard's rows of the new token; ``ptr`` the replicated cursor.
    The shard reads one slot of its rows, keeps it or takes the new token
    as it owns ``slot = ptr mod C`` or not, and writes that slot back:
    O(token) traffic, no host sync.  The cursor is not advanced."""
    n = rows["k"].shape[1]
    local = ptr % capacity - offset
    owned = (local >= 0) & (local < n)
    li = torch.clamp(local, 0, n - 1).to(torch.int64).reshape(1)
    for name, new in (("k", k), ("v", v), ("pos", positions)):
        dst = rows[name]
        cur = dst.index_select(1, li)
        dst.index_copy_(1, li, torch.where(owned, new.to(dst.dtype), cur))


def kv_cache_append(cache, k, v, positions):
    """Append one token per row (decode): k/v (B, 1, KV, hd), positions
    (B, 1).  Every row writes ring slot ``ptr mod C`` — the reference's
    one-hot ``ring_write=False`` result, written as one slot; a DTensor
    cache by its owning shard, a split cache by its owning run
    (`ring_write_shard`)."""
    held = _held_runs(cache, k, v, positions)
    if held is not None:
        runs, k, v, pos, C = held
        ptr = cache["ptr"]
        ptr = ptr.to_local() if is_dtensor(ptr) else ptr
        for rows, off in runs:
            ring_write_shard(rows, k, v, pos, ptr, off, C)
        cache["ptr"].add_(1)
        return cache
    C = cache["k"].shape[1]
    slot = (cache["ptr"] % C).to(torch.int64).reshape(1)
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(1, slot, positions.to(torch.int32))
    cache["ptr"].add_(1)
    return cache


# ----------------------------------------------------- recurrent states ----


def make_mlstm_state(batch, n_heads, d_k, d_v, d_conv, conv_k=4,
                     dtype=torch.float32, conv_dtype=torch.float32,
                     device=None):
    z = dict(dtype=dtype, device=device)
    return {
        "C": torch.zeros((batch, n_heads, d_k, d_v), **z),  # matrix memory
        "n": torch.zeros((batch, n_heads, d_k), **z),       # normalizer
        "m": torch.zeros((batch, n_heads), **z),            # stabilizer
        "conv": torch.zeros((batch, conv_k - 1, d_conv), dtype=conv_dtype,
                            device=device),                 # causal-conv tail
    }


def make_slstm_state(batch, n_heads, head_dim, dtype=torch.float32,
                     device=None):
    return {k: torch.zeros((batch, n_heads, head_dim), dtype=dtype,
                           device=device) for k in ("c", "n", "h", "m")}


def make_rglru_state(batch, width, conv_k=4, dtype=torch.float32,
                     conv_dtype=torch.float32, device=None):
    return {
        "h": torch.zeros((batch, width), dtype=dtype, device=device),
        "conv": torch.zeros((batch, conv_k - 1, width), dtype=conv_dtype,
                            device=device),                 # causal-conv tail
    }
