"""Dispatch for the port's kernels.

A wrapper here takes the plain PyTorch version for a tensor that lies on
the CPU, and the hand-written CUDA kernel for a tensor on the card — it
launches the kernel or raises; nothing falls back.  Launch counters
(`launch_counts`) count kernel launches only.
"""

from __future__ import annotations

import torch

from ..admission.functional_qos import qos_round as _qos_round_plain
from ..core.functional import next_pow2 as _next_pow2
from . import build
from . import paged_decode as _paged_decode
from . import qos_admission as _qos_admission
from .ref import paged_decode_ref, qos_round_scan_ref


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset."""
    return dict(build.LAUNCHES)


def reset_launch_counts() -> None:
    for k in build.LAUNCHES:
        build.LAUNCHES[k] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def paged_decode(q, k_pool, v_pool, block_tbl, lens):
    """Ragged flash-decode over the block-paged KV pool (plain version:
    `ref.paged_decode_ref`)."""
    if _on_cpu(q):
        return paged_decode_ref(q, k_pool, v_pool, block_tbl, lens)
    return _paged_decode.paged_decode(q, k_pool, v_pool, block_tbl, lens)


def _pad_backlog(tenant_ids, tickets, alive, deadlines, block_n: int):
    """Pad a backlog to the next power of two ≥ block_n with dead rows
    (never admitted, expired or counted), so a draining backlog touches
    log₂ shapes; a backlog already at that size passes unchanged."""
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
    → FCFS admit → reclaim) over the power-of-two padded backlog."""
    n = tenant_ids.shape[0]
    ids, tks, alv, dls = _pad_backlog(tenant_ids, tickets, alive, deadlines,
                                      block_n)
    if _on_cpu(ids):
        st, adm, exp, left = _qos_round_plain(state, ids, tks, alv, dls, now,
                                              free_units, max_units)
    else:
        st, adm, exp, left = _qos_admission.qos_round_fused(
            state, ids, tks, alv, dls, now, free_units, max_units=max_units)
    return st, adm[:n], exp[:n], left


def qos_round_scan(state, tenant_ids, tickets, alive, deadlines, nows,
                   free_units, released, *, max_units: int,
                   block_n: int = 256):
    """K fused admission rounds.  Returns ``(state', admit_round[:n],
    expire_round[:n], free')``."""
    n = tenant_ids.shape[0]
    ids, tks, alv, dls = _pad_backlog(tenant_ids, tickets, alive, deadlines,
                                      block_n)
    if _on_cpu(ids):
        r = qos_round_scan_ref(state, ids, tks, alv, dls, nows, free_units,
                               released, max_units)
        st, ar, er, free = r["state"], r["admit_round"], r["expire_round"], \
            r["free"]
    else:
        st, ar, er, free = _qos_admission.qos_round_scan(
            state, ids, tks, alv, dls, nows, free_units, released,
            max_units=max_units)
    return st, ar[:n], er[:n], free

