"""Dispatch for the port's kernels.

A wrapper here takes the plain PyTorch version for a tensor that lies on
the CPU, and the hand-written CUDA kernel for a tensor on the card — it
launches the kernel or raises; nothing falls back.  The attention
wrappers route on the dtype: f32 to the f32 kernel, bf16 to its bf16
instantiation; any other dtype raises (nothing is cast).  Launch counters
(`launch_counts`) count kernel launches only.
"""

from __future__ import annotations

import torch

from ..admission.functional_qos import qos_round as _qos_round_plain
from ..core.functional import next_pow2 as _next_pow2
from . import build
from . import decode_attention as _decode_attention
from . import flash_attention as _flash_attention
from . import paged_decode as _paged_decode
from . import paged_prefill as _paged_prefill
from . import qos_admission as _qos_admission
from . import sema_batch as _sema_batch
from .ref import paged_decode_ref, paged_prefill_ref, qos_round_scan_ref


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return dict(build.LAUNCHES)


def flash_routes() -> dict:
    """The bf16 flash launches since the last reset by route: ``wgmma``
    (csrc/flash_attention_sm90.cu) and ``mma_sync``
    (csrc/flash_attention.cu); they sum to ``flash_attention_bf16``."""
    return dict(_flash_attention.ROUTES)


def reset_launch_counts() -> None:
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0
    for k in _flash_attention.ROUTES:
        _flash_attention.ROUTES[k] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def sema_batch(ticket, grant, bucket_seq, requests, post_n, salt):
    """Batched TWA take + post + wake for a vector of requests.  Returns
    ``(ticket', grant', bucket_seq', tickets, admitted, bucket, woken)``
    (plain version: `ref.sema_batch_ref`, bit-equal)."""
    if _on_cpu(bucket_seq):
        return _sema_batch.sema_batch_plain(ticket, grant, bucket_seq,
                                            requests, post_n, salt)
    return _sema_batch.sema_batch(ticket, grant, bucket_seq, requests,
                                  post_n, salt)


def decode_attention(q, k, v, kv_pos, q_pos, *, window: int = 0,
                     return_lse: bool = False):
    """One query token per row over a dense, possibly rolling KV cache
    masked by the stored positions (plain version:
    `ref.single_query_attention`).  q (B, H, hd) → (B, H, hd) in q's
    dtype; with ``return_lse`` → (out, lse (B, H)), out f32 (a partial
    for `lse_merge`) and lse = −inf where a row sees no key."""
    if _on_cpu(q):
        return _decode_attention.decode_attention_plain(
            q, k, v, kv_pos, q_pos, window=window, return_lse=return_lse)
    return _decode_attention.decode_attention(q, k, v, kv_pos, q_pos,
                                              window=window,
                                              return_lse=return_lse)


def flash_attention(q, k, v, *, window: int = 0):
    """Blockwise causal (optionally sliding-window) GQA attention
    forward, query i and key j at positions i and j (plain version:
    `ref.blockwise_attention`).  q (B, Sq, H, hd) → same, in q's
    dtype."""
    if _on_cpu(q):
        return _flash_attention.flash_attention_plain(q, k, v, window=window)
    return _flash_attention.flash_attention(q, k, v, window=window)


def paged_decode(q, k_pool, v_pool, block_tbl, lens):
    """Ragged flash-decode over the block-paged KV pool (plain version:
    `ref.paged_decode_ref`)."""
    if _on_cpu(q):
        return paged_decode_ref(q, k_pool, v_pool, block_tbl, lens)
    return _paged_decode.paged_decode(q, k_pool, v_pool, block_tbl, lens)


def paged_prefill(q, k_chunk, v_chunk, k_pool, v_pool, block_tbl, off, lens):
    """Ragged chunked prefill over the block-paged KV pool: writes the
    chunk K/V into the slots' blocks and attends each chunk row over the
    prior tokens and the chunk causally.  Returns ``(out, k_pool',
    v_pool')``: on the card the kernel updates the pools in place and
    returns them; on the CPU the plain version (`ref.paged_prefill_ref`)
    returns new pools."""
    if _on_cpu(q):
        return paged_prefill_ref(q, k_chunk, v_chunk, k_pool, v_pool,
                                 block_tbl, off, lens)
    return _paged_prefill.paged_prefill(q, k_chunk, v_chunk, k_pool, v_pool,
                                        block_tbl, off, lens)


def _pad_backlog(tenant_ids, tickets, alive, deadlines, block_n: int):
    """Pad a backlog to the next power of two ≥ block_n with dead rows
    (never admitted, expired or counted), so a draining backlog touches
    log₂ shapes on the CPU path; a backlog already at that size passes
    unchanged.  The card path takes N as it comes: dead rows change no
    result."""
    n = tenant_ids.shape[0]
    pad = max(block_n, _next_pow2(n)) - n
    ids = tenant_ids.to(torch.int32)
    tks = tickets.to(torch.int64)
    alv = alive.to(torch.bool)
    dls = deadlines.to(torch.float32)
    if pad == 0:
        return ids, tks, alv, dls
    z = dict(device=ids.device)
    return (torch.cat([ids, torch.zeros(pad, dtype=torch.int32, **z)]),
            torch.cat([tks, torch.zeros(pad, dtype=torch.int64, **z)]),
            torch.cat([alv, torch.zeros(pad, dtype=torch.bool, **z)]),
            torch.cat([dls, torch.full((pad,), torch.inf,
                                       dtype=torch.float32, **z)]))


def qos_round(state, tenant_ids, tickets, alive, deadlines, now, free_units,
              *, max_units: int, block_n: int = 256):
    """Fused multi-tenant QoS admission round (expire → weighted replenish
    → FCFS admit → reclaim).  On the card one kernel launch over the
    rows as they come (`qos_admission.qos_round_fused`: i32 tenant ids,
    i64 tickets, bool alive, f32 deadlines; any N and any number of
    tenants, past one CTA's limits after a torch presort); on the CPU the
    plain round over the backlog padded to a power of two ≥
    ``block_n``."""
    if not _on_cpu(tenant_ids):
        return _qos_admission.qos_round_fused(
            state, tenant_ids, tickets, alive, deadlines, now, free_units,
            max_units=max_units)
    n = tenant_ids.shape[0]
    ids, tks, alv, dls = _pad_backlog(tenant_ids, tickets, alive, deadlines,
                                      block_n)
    st, adm, exp, left = _qos_round_plain(state, ids, tks, alv, dls, now,
                                          free_units, max_units)
    return st, adm[:n], exp[:n], left


def qos_round_scan(state, tenant_ids, tickets, alive, deadlines, nows,
                   free_units, released, *, max_units: int,
                   block_n: int = 256):
    """K fused admission rounds.  Returns ``(state', admit_round (N,),
    expire_round (N,), free')``; on the CPU over the padded backlog."""
    if not _on_cpu(tenant_ids):
        return _qos_admission.qos_round_scan(
            state, tenant_ids, tickets, alive, deadlines, nows, free_units,
            released, max_units=max_units)
    n = tenant_ids.shape[0]
    ids, tks, alv, dls = _pad_backlog(tenant_ids, tickets, alive, deadlines,
                                      block_n)
    r = qos_round_scan_ref(state, ids, tks, alv, dls, nows, free_units,
                           released, max_units)
    return r["state"], r["admit_round"][:n], r["expire_round"][:n], r["free"]
