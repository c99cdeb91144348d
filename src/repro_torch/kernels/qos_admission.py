"""The fused multi-tenant QoS admission round as a CUDA kernel
(``csrc/qos_admission.cu``) — the port of the TPU kernel
``repro.kernels.qos_admission.qos_round_fused``.

Up to `MAX_ROWS` rows and `MAX_TENANTS` tenants, one launch of one block
does the whole round from the caller's tensors as they lie: the
wrap-safe per-tenant ticket order (computed in the kernel, order-free),
expiry, live depth, the closed-form stride replenish, the waiting-array
poke, the FCFS admit and the reclaim, with ``admitted``/``expired``
written in the caller's row order and the state counters as int64 u32
carriers.  The wrapper's host work is the checks, one allocation that
every output is a view of, and one ``ctypes`` call bound once: no torch
operation runs on the card around the launch.

Past either limit the round takes the large path: the wrapper sorts the
rows by `core.functional.ticket_order` with torch (the reference's
wrapper does the same in XLA outside its kernel), and one block of the
large kernel sweeps the sorted rows with its per-tenant arrays in a
workspace cut from the same allocation (CPU twin:
`ref.qos_round_large_ref`).  Plain version: :func:`qos_round_plain`
(`admission.functional_qos.qos_round`), which both paths match bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..admission.functional_qos import qos_round as qos_round_plain
from ..core.functional import ticket_order
from . import build

__all__ = ["qos_round_fused", "qos_round_scan", "qos_round_plain",
           "large_path"]

# the one-CTA kernel's limits; past either, the large path
MAX_TENANTS = 256
MAX_ROWS = 16384   # the CTA's 128 KB of sort keys
_WARPS = 32        # the large kernel's row chunks (csrc: kWarps)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"qos_round_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                             _I, _P, _P, _F, _P, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P],
        "qos_round_large_launch": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                                   _P, _P, _I, _P, _P, _F, _P, _I, _I, _I, _P,
                                   _P, _P, _P, _P, _P, _P]}
_I64, _I32, _F32, _BOOL = torch.int64, torch.int32, torch.float32, torch.bool
_lib = None         # the loaded library, bound at the first call


def _bad(state, rows, now, free_units, max_units) -> ValueError:
    parts = ", ".join(
        f"{n} {tuple(t.shape)} {t.dtype} on {t.device}"
        f"{'' if t.is_contiguous() else ' (strided)'}"
        for n, t in (*rows, *((f"state.{f}", getattr(state, f))
                              for f in state._fields),
                     *((n, x) for n, x in (("now", now),
                                           ("free_units", free_units))
                       if isinstance(x, torch.Tensor))))
    return ValueError(
        "qos_round_fused wants, contiguous on one CUDA device: tenant_ids "
        "(N,) i32, tickets (N,) i64, alive (N,) bool, deadlines (N,) f32; "
        "state counters (S,) i64 with S >= 1, weight/vpass (S,) f32, "
        "bucket_seq (T,) i64 with T a power of two, salt one i64; now one "
        "f32 and free_units one i32 (or Python numbers); max_units >= 1 "
        f"(got {max_units}); got {parts}")


def large_path(n_rows: int, n_tenants: int) -> bool:
    """Whether a round of ``n_rows`` rows and ``n_tenants`` tenants takes
    the large path (past the one-CTA kernel's `MAX_ROWS` or
    `MAX_TENANTS`)."""
    return n_rows > MAX_ROWS or n_tenants > MAX_TENANTS


def _order(tenant_ids, tickets, S: int) -> torch.Tensor:
    """The rows' wrap-safe per-tenant ticket order, the large kernel's
    input: `core.functional.ticket_order`, with a row whose tenant id
    lies outside [0, S) (never live, as in the one-CTA kernel) given a
    tenant of its own."""
    ids = torch.where((tenant_ids >= 0) & (tenant_ids < S), tenant_ids, S)
    return ticket_order(ids, tickets, S + 1)


def qos_round_fused(state, tenant_ids, tickets, alive, deadlines, now,
                    free_units, *, max_units: int):
    """One admission round on the card.  ``tenant_ids`` (N,) i32,
    ``tickets`` (N,) u32 carriers (i64), ``alive`` (N,) bool,
    ``deadlines`` (N,) f32, all on one CUDA device with ``state``; ``now``
    (f32) and ``free_units`` (i32) are one-element device tensors or
    Python numbers.  Any N and any number of tenants: past `MAX_ROWS`
    rows or `MAX_TENANTS` tenants the large path.  Returns ``(state',
    admitted, expired, leftover)`` like `functional_qos.qos_round`; the
    new state's fields, the masks and the leftover are views of one
    buffer."""
    return _round(state, tenant_ids, tickets, alive, deadlines, now,
                  free_units, max_units, None)


def _round(state, tenant_ids, tickets, alive, deadlines, now, free_units,
           max_units: int, order):
    """`qos_round_fused`, with the large path's ticket ``order`` given
    (the scan sorts its rows once) or None (sorted here when needed)."""
    global _lib
    dev = tenant_ids.device
    N = tenant_ids.shape[0]
    S = state.ticket.shape[0]
    T = state.bucket_seq.shape[0]
    di = dev.index
    rows = (("tenant_ids", tenant_ids), ("tickets", tickets),
            ("alive", alive), ("deadlines", deadlines))
    ok = (dev.type == "cuda" and S >= 1 and T > 0 and not T & (T - 1)
          and max_units >= 1 and state.salt.numel() == 1)
    if ok:
        for t, dt, n in ((tenant_ids, _I32, N), (tickets, _I64, N),
                         (alive, _BOOL, N), (deadlines, _F32, N),
                         (state.ticket, _I64, S), (state.grant, _I64, S),
                         (state.consumed, _I64, S), (state.dead, _I64, S),
                         (state.weight, _F32, S), (state.vpass, _F32, S),
                         (state.bucket_seq, _I64, T)):
            if (t.dtype != dt or t.shape != (n,) or t.get_device() != di
                    or not t.is_contiguous()):
                ok = False
                break
        for x, dt in ((now, _F32), (free_units, _I32), (state.salt, _I64)):
            if isinstance(x, torch.Tensor) and (
                    x.dtype != dt or x.numel() != 1 or x.get_device() != di):
                ok = False
    if not ok:
        raise _bad(state, rows, now, free_units, max_units)
    if _lib is None:
        _lib = build.load("qos_admission", _SIG)
    large = large_path(N, S)
    if large and order is None:
        order = _order(tenant_ids, tickets, S)

    # one buffer: grant', consumed', dead', bucket_seq' (i64), vpass'
    # (f32), the leftover (i32), admitted, expired (bool), and on the large
    # path its workspace (i32); the outputs are `as_strided` views of it
    # (the cheapest view on the host)
    nu, nv = 3 * S + T, S
    m0 = 8 * nu + 4 * nv + 4
    ws = -(-(m0 + 2 * N) // 8) * 8
    size = ws + 8 * -(-((_WARPS + 9) * S + T) // 2) if large else ws
    buf = torch.empty(size, dtype=_BOOL, device=dev)
    base = buf.data_ptr()
    now_t = isinstance(now, torch.Tensor)
    free_t = isinstance(free_units, torch.Tensor)
    state_args = (
        state.ticket.data_ptr(), state.grant.data_ptr(),
        state.consumed.data_ptr(), state.dead.data_ptr(),
        state.weight.data_ptr(), state.vpass.data_ptr(),
        state.bucket_seq.data_ptr(), T, state.salt.data_ptr(),
        now.data_ptr() if now_t else None, 0.0 if now_t else float(now),
        free_units.data_ptr() if free_t else None,
        0 if free_t else int(free_units), S, max_units, base, base + 8 * nu,
        base + 8 * nu + 4 * nv, base + m0, base + m0 + N)
    row_args = (tenant_ids.data_ptr(), tickets.data_ptr(), alive.data_ptr(),
                deadlines.data_ptr())
    stream = torch._C._cuda_getCurrentRawStream(di)
    if large:
        rc = _lib.qos_round_large_launch(*row_args, order.data_ptr(), N,
                                         *state_args, base + ws, stream)
    else:
        rc = _lib.qos_round_launch(*row_args, N, *state_args, stream)
    if rc:
        build.check(rc, "qos_round_fused")
    build.LAUNCHES["qos_round_fused"] += 1

    u = buf.view(_I64)
    one = (1,)
    new_state = state._replace(
        grant=u.as_strided((S,), one, 0),
        consumed=u.as_strided((S,), one, S),
        dead=u.as_strided((S,), one, 2 * S),
        bucket_seq=u.as_strided((T,), one, 3 * S),
        vpass=buf.view(_F32).as_strided((S,), one, 2 * nu))
    return (new_state, buf.as_strided((N,), one, m0),
            buf.as_strided((N,), one, m0 + N),
            buf.view(_I32).as_strided((), (), 2 * nu + nv))


def qos_round_scan(state, tenant_ids, tickets, alive, deadlines, nows,
                   free_units, released, *, max_units: int):
    """K kernel rounds: each round's admitted/expired rows leave the alive
    set, ``released[k]`` units join the pool before round k's replenish,
    the leftover carries; the large path sorts the rows once.  Returns
    ``(state', admit_round (N,) i32, expire_round (N,) i32, free')`` with
    -1 for rows never admitted or expired (oracle:
    `ref.qos_round_scan_ref`)."""
    N = tenant_ids.shape[0]
    S = state.ticket.shape[0]
    dev = tenant_ids.device
    admit_round = torch.full((N,), -1, dtype=_I32, device=dev)
    expire_round = torch.full((N,), -1, dtype=_I32, device=dev)
    nows = nows.to(_F32)
    released = torch.as_tensor(released, device=dev).to(_I32)
    free = (free_units.to(_I32) if isinstance(free_units, torch.Tensor)
            else torch.full((), free_units, dtype=_I32, device=dev))
    # the ticket order does not change across the rounds: sort once
    order = _order(tenant_ids, tickets, S) if large_path(N, S) else None
    for k in range(nows.shape[0]):
        state, adm, exp, free = _round(
            state, tenant_ids, tickets, alive, deadlines, nows[k],
            free + released[k], max_units, order)
        admit_round = torch.where(adm, k, admit_round)
        expire_round = torch.where(exp, k, expire_round)
        alive = alive & ~adm & ~exp
    return state, admit_round, expire_round, free
