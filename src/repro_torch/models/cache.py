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

Not ported: the reference's shard_map ring write (``ring_write=True``,
a sequence-sharded cache); `kv_cache_append` refuses a DTensor cache
whose ``seq_kv`` rule names an axis of the active mesh, where that write
would be needed.
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
    """Bulk write a prefix into an empty cache: k/v (B, S, KV, hd),
    positions (B, S).  The whole cache is overwritten: S < C leaves zeros
    and -1 past the prefix; S > C keeps the last C tokens (sliding-window
    prefill), token t in ring slot t mod C — the slot that
    `kv_cache_append` writes at cursor t — so the first append after the
    prefill overwrites the oldest token.  The reference writes those C
    tokens in slots 0..C−1, where an append then overwrites a key still
    inside the window unless C divides S (ROADMAP queue 3); the two
    layouts agree when it does."""
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


def _refuse_sharded_ring(cache) -> None:
    """The reference's ring-write rule: a sequence-sharded cache (the
    ``seq_kv`` rule naming an axis of the active mesh) needs the per-shard
    write, which the meshed decode step will bring."""
    from ..parallel.sharding import current_rules, is_dtensor, mesh_axes

    if not is_dtensor(cache["k"]):
        return
    rule = current_rules().get("seq_kv")
    rule = (rule,) if isinstance(rule, str) else (rule or ())
    if any(a in mesh_axes() for a in rule):
        raise NotImplementedError(
            "kv_cache_append: the sequence-sharded ring write (the meshed "
            "decode step) is not ported")


def kv_cache_append(cache, k, v, positions):
    """Append one token per row (decode): k/v (B, 1, KV, hd), positions
    (B, 1).  Every row writes ring slot ``ptr mod C`` — the reference's
    one-hot ``ring_write=False`` result, written as one slot."""
    _refuse_sharded_ring(cache)
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
