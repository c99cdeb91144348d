"""The fused multi-tenant QoS admission round as a CUDA kernel
(``csrc/qos_admission.cu``) — the port of the TPU kernel
``repro.kernels.qos_admission.qos_round_fused``.

The wrapper keeps the data prep in torch, as the JAX wrapper keeps it in
XLA: the wrap-safe per-tenant ticket order (a stable argsort shared with
the plain rank path) and the scatter of the row masks back to the caller's
order.  Everything else — expiry, live depth, the closed-form stride
replenish, the waiting-array poke, the FCFS admit and the reclaim — is one
launch of one block.  Plain version: :func:`qos_round_plain`
(`admission.functional_qos.qos_round`), which the kernel matches bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..admission.functional_qos import qos_round as qos_round_plain
from ..core import u32
from ..core.functional import ticket_order
from . import build

__all__ = ["qos_round_fused", "qos_round_scan", "qos_round_plain"]

MAX_TENANTS = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"qos_round_launch": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                             _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P]}


def _scalar(x, dtype, dev) -> torch.Tensor:
    """A (1,) device buffer holding ``x`` — a view for a tensor already
    there, a fill kernel (no host copy) for a Python number."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).reshape(1).contiguous()
    return torch.full((1,), x, dtype=dtype, device=dev)


def qos_round_fused(state, tenant_ids, tickets, alive, deadlines, now,
                    free_units, *, max_units: int):
    """One admission round on the card.  ``tenant_ids`` (N,) i32,
    ``tickets`` (N,) u32 carrier, ``alive`` (N,) bool, ``deadlines`` (N,)
    f32, all on one CUDA device with ``state``; ``now`` and ``free_units``
    are device scalars or Python numbers.  Returns ``(state', admitted,
    expired, leftover)`` like `functional_qos.qos_round`."""
    dev = tenant_ids.device
    if dev.type != "cuda":
        raise ValueError(f"qos_round_fused runs on a CUDA device, got {dev}")
    N = tenant_ids.shape[0]
    S = state.ticket.shape[0]
    T = state.bucket_seq.shape[0]
    for name, t, dt in (("tenant_ids", tenant_ids, torch.int32),
                        ("tickets", tickets, torch.int64),
                        ("alive", alive, torch.bool),
                        ("deadlines", deadlines, torch.float32)):
        if t.device != dev or t.dtype != dt or t.shape != (N,):
            raise ValueError(f"{name}: want ({N},) {dt} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    for name in ("ticket", "grant", "consumed", "dead", "weight", "vpass"):
        t = getattr(state, name)
        if t.device != dev or t.shape != (S,):
            raise ValueError(f"state.{name}: want ({S},) on {dev}")
    if not 1 <= S <= MAX_TENANTS or T & (T - 1) or max_units < 1:
        raise ValueError(f"need 1 <= tenants <= {MAX_TENANTS}, a power-of-"
                         f"two table and max_units >= 1 (got {S}, {T}, "
                         f"{max_units})")

    order = ticket_order(tenant_ids, tickets, S)
    ids_s = tenant_ids[order].contiguous()
    alive_s = alive[order].contiguous()
    dl_s = deadlines[order].contiguous()
    bits = [u32.to_bits32(getattr(state, f)).contiguous()
            for f in ("ticket", "grant", "consumed", "dead")]
    weight = state.weight.to(torch.float32).contiguous()
    vpass = state.vpass.to(torch.float32).contiguous()
    seq = u32.to_bits32(state.bucket_seq).contiguous()
    salt = u32.to_bits32(state.salt).reshape(1).contiguous()
    now_b = _scalar(now, torch.float32, dev)
    free_b = _scalar(free_units, torch.int32, dev)

    adm_s = torch.empty(N, dtype=torch.bool, device=dev)
    exp_s = torch.empty(N, dtype=torch.bool, device=dev)
    out_u = torch.empty((3, S), dtype=torch.int32, device=dev)
    vpass_o = torch.empty(S, dtype=torch.float32, device=dev)
    seq_o = torch.empty(T, dtype=torch.int32, device=dev)
    left = torch.empty(1, dtype=torch.int32, device=dev)

    lib = build.load("qos_admission", _SIG)
    rc = lib.qos_round_launch(
        ids_s.data_ptr(), alive_s.data_ptr(), dl_s.data_ptr(), N,
        *[b.data_ptr() for b in bits], weight.data_ptr(), vpass.data_ptr(),
        seq.data_ptr(), T, salt.data_ptr(), now_b.data_ptr(),
        free_b.data_ptr(), S, max_units, adm_s.data_ptr(), exp_s.data_ptr(),
        out_u[0].data_ptr(), out_u[1].data_ptr(), out_u[2].data_ptr(),
        vpass_o.data_ptr(), seq_o.data_ptr(), left.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "qos_round_fused")
    build.LAUNCHES["qos_round_fused"] += 1

    admitted = torch.empty_like(adm_s).scatter_(0, order, adm_s)
    expired = torch.empty_like(exp_s).scatter_(0, order, exp_s)
    new_state = state._replace(
        grant=u32.from_bits32(out_u[0]), consumed=u32.from_bits32(out_u[1]),
        dead=u32.from_bits32(out_u[2]), vpass=vpass_o,
        bucket_seq=u32.from_bits32(seq_o))
    return new_state, admitted, expired, left[0]


def qos_round_scan(state, tenant_ids, tickets, alive, deadlines, nows,
                   free_units, released, *, max_units: int):
    """K kernel rounds: each round's admitted/expired rows leave the alive
    set, ``released[k]`` units join the pool before round k's replenish,
    the leftover carries.  Returns ``(state', admit_round (N,) i32,
    expire_round (N,) i32, free')`` with -1 for rows never admitted or
    expired (oracle: `ref.qos_round_scan_ref`)."""
    N = tenant_ids.shape[0]
    dev = tenant_ids.device
    admit_round = torch.full((N,), -1, dtype=torch.int32, device=dev)
    expire_round = torch.full((N,), -1, dtype=torch.int32, device=dev)
    free = _scalar(free_units, torch.int32, dev)[0]
    for k in range(nows.shape[0]):
        state, adm, exp, free = qos_round_fused(
            state, tenant_ids, tickets, alive, deadlines, nows[k],
            free + released[k], max_units=max_units)
        admit_round = torch.where(adm, k, admit_round)
        expire_round = torch.where(exp, k, expire_round)
        alive = alive & ~adm & ~exp
    return state, admit_round, expire_round, free
