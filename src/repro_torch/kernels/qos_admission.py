"""The fused multi-tenant QoS admission round as a CUDA kernel
(``csrc/qos_admission.cu``) — the port of the TPU kernel
``repro.kernels.qos_admission.qos_round_fused``.

One launch of one block does the whole round from the caller's tensors
as they lie: the wrap-safe per-tenant ticket order (computed in the
kernel, order-free), expiry, live depth, the closed-form stride
replenish, the waiting-array poke, the FCFS admit and the reclaim, with
``admitted``/``expired`` written in the caller's row order and the state
counters as int64 u32 carriers.  The wrapper's host work is the checks,
one allocation that every output is a view of, and one ``ctypes`` call
bound once: no torch operation runs on the card around the launch.
Plain version: :func:`qos_round_plain` (`admission.functional_qos.
qos_round`), which the kernel matches bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..admission.functional_qos import qos_round as qos_round_plain
from ..core.functional import next_pow2
from . import build

__all__ = ["qos_round_fused", "qos_round_scan", "qos_round_plain",
           "check_engine_limits"]

MAX_TENANTS = 256
MAX_ROWS = 16384   # the CTA's 128 KB of sort keys

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"qos_round_launch": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                             _I, _P, _P, _F, _P, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P]}
_I64, _I32, _F32, _BOOL = torch.int64, torch.int32, torch.float32, torch.bool
_launch = None      # the ctypes entry, bound at the first call


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
        "(N,) i32, tickets (N,) i64, alive (N,) bool, deadlines (N,) f32 "
        f"with N <= {MAX_ROWS}; state counters (S,) i64, weight/vpass (S,) "
        f"f32, bucket_seq (T,) i64 with T a power of two, salt one i64, "
        f"1 <= S <= {MAX_TENANTS}; now one f32 and free_units one i32 (or "
        f"Python numbers); max_units >= 1 (got {max_units}); got {parts}")


def check_engine_limits(device, use_kernel: bool, n_tenants: int,
                        backlog_cap: int, n_slots: int) -> None:
    """Refuse, before it runs, a QoS engine whose rounds this kernel could
    not take: on a CUDA ``device`` with ``use_kernel``, more than
    `MAX_TENANTS` tenants, or more than `MAX_ROWS` rows in the largest
    backlog the engine drains (``max(next_pow2(max(backlog_cap,
    n_slots)), 8)``).  The CPU path takes any size, as the reference
    does."""
    if torch.device(device).type != "cuda" or not use_kernel:
        return
    if n_tenants > MAX_TENANTS:
        raise ValueError(
            f"{n_tenants} tenants: the card's QoS kernel takes at most "
            f"MAX_TENANTS = {MAX_TENANTS} (use_kernel=False, or the CPU, "
            "takes any number)")
    rows = max(next_pow2(max(backlog_cap, n_slots)), 8)
    if rows > MAX_ROWS:
        raise ValueError(
            f"backlog_cap={backlog_cap} with {n_slots} slots drains "
            f"backlogs of {rows} rows: the card's QoS kernel takes at most "
            f"MAX_ROWS = {MAX_ROWS} (use_kernel=False, or the CPU, takes "
            "any backlog)")


def qos_round_fused(state, tenant_ids, tickets, alive, deadlines, now,
                    free_units, *, max_units: int):
    """One admission round on the card.  ``tenant_ids`` (N,) i32,
    ``tickets`` (N,) u32 carriers (i64), ``alive`` (N,) bool,
    ``deadlines`` (N,) f32, all on one CUDA device with ``state``; ``now``
    (f32) and ``free_units`` (i32) are one-element device tensors or
    Python numbers.  Returns ``(state', admitted, expired, leftover)``
    like `functional_qos.qos_round`; the new state's fields, the masks
    and the leftover are views of one buffer."""
    global _launch
    dev = tenant_ids.device
    N = tenant_ids.shape[0]
    S = state.ticket.shape[0]
    T = state.bucket_seq.shape[0]
    di = dev.index
    rows = (("tenant_ids", tenant_ids), ("tickets", tickets),
            ("alive", alive), ("deadlines", deadlines))
    ok = (dev.type == "cuda" and 1 <= S <= MAX_TENANTS and N <= MAX_ROWS
          and T > 0 and not T & (T - 1) and max_units >= 1
          and state.salt.numel() == 1)
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
    if _launch is None:
        _launch = build.load("qos_admission", _SIG).qos_round_launch

    # one buffer: grant', consumed', dead', bucket_seq' (i64), vpass'
    # (f32), the leftover (i32), admitted, expired (bool); the outputs are
    # `as_strided` views of it (the cheapest view on the host)
    nu, nv = 3 * S + T, S
    m0 = 8 * nu + 4 * nv + 4
    buf = torch.empty(-(-(m0 + 2 * N) // 8) * 8, dtype=_BOOL, device=dev)
    base = buf.data_ptr()
    now_t = isinstance(now, torch.Tensor)
    free_t = isinstance(free_units, torch.Tensor)
    rc = _launch(
        tenant_ids.data_ptr(), tickets.data_ptr(), alive.data_ptr(),
        deadlines.data_ptr(), N, state.ticket.data_ptr(),
        state.grant.data_ptr(), state.consumed.data_ptr(),
        state.dead.data_ptr(), state.weight.data_ptr(),
        state.vpass.data_ptr(), state.bucket_seq.data_ptr(), T,
        state.salt.data_ptr(), now.data_ptr() if now_t else None,
        0.0 if now_t else float(now),
        free_units.data_ptr() if free_t else None,
        0 if free_t else int(free_units), S, max_units, base, base + 8 * nu,
        base + 8 * nu + 4 * nv, base + m0, base + m0 + N,
        torch._C._cuda_getCurrentRawStream(di))
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
    the leftover carries.  Returns ``(state', admit_round (N,) i32,
    expire_round (N,) i32, free')`` with -1 for rows never admitted or
    expired (oracle: `ref.qos_round_scan_ref`)."""
    N = tenant_ids.shape[0]
    dev = tenant_ids.device
    admit_round = torch.full((N,), -1, dtype=_I32, device=dev)
    expire_round = torch.full((N,), -1, dtype=_I32, device=dev)
    nows = nows.to(_F32)
    released = torch.as_tensor(released, device=dev).to(_I32)
    free = (free_units.to(_I32) if isinstance(free_units, torch.Tensor)
            else torch.full((), free_units, dtype=_I32, device=dev))
    for k in range(nows.shape[0]):
        state, adm, exp, free = qos_round_fused(
            state, tenant_ids, tickets, alive, deadlines, nows[k],
            free + released[k], max_units=max_units)
        admit_round = torch.where(adm, k, admit_round)
        expire_round = torch.where(exp, k, expire_round)
        alive = alive & ~adm & ~exp
    return state, admit_round, expire_round, free
