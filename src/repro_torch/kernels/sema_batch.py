"""The batched TWA semaphore pass (take + post + wake) as a CUDA kernel
(``csrc/sema_batch.cu``) — the port of the TPU kernel
``repro.kernels.sema_batch.sema_batch``.

One block of 1024 threads ranks the requesting rows with warp ballots,
carries the ticket base across tiles, and bumps the waiting array's
enabled buckets in closed form (stride 17 is a unit mod T).  Plain
version: :func:`sema_batch_plain` (`kernels.ref.sema_batch_ref`), which
the kernel matches bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import u32
from . import build
from .ref import sema_batch_ref

__all__ = ["sema_batch", "sema_batch_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"sema_batch_launch": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                              _P]}


def _u32_scalar(x, dev) -> torch.Tensor:
    """A (1,) u32 carrier on ``dev`` — a view for a tensor already there,
    a fill (no host copy) for a Python int."""
    if isinstance(x, torch.Tensor):
        return (x.to(torch.int64) & u32.MASK32).reshape(1)
    return torch.full((1,), int(x) & u32.MASK32, dtype=torch.int64,
                      device=dev)


def sema_batch_plain(ticket, grant, bucket_seq, requests, post_n, salt):
    """`ref.sema_batch_ref` in the kernel's return order."""
    r = sema_batch_ref(ticket, grant, bucket_seq, requests, post_n, salt)
    return (r["ticket"], r["grant"], r["bucket_seq"], r["tickets"],
            r["admitted"], r["bucket"], r["woken"])


def sema_batch(ticket, grant, bucket_seq, requests, post_n, salt):
    """One pass on the card.  ``ticket``/``grant``/``post_n``/``salt``:
    u32 carriers (0-dim tensors on the device, or ints); ``bucket_seq``
    (T,) u32 carriers, T a power of two; ``requests`` (N,) bool, on one
    CUDA device.  Returns ``(ticket', grant', bucket_seq', tickets (N,)
    u32, admitted (N,) bool, bucket (N,) i32, woken (N,) bool)`` — the
    JAX wrapper's order; no host sync."""
    dev = bucket_seq.device
    if dev.type != "cuda":
        raise ValueError(f"sema_batch runs on a CUDA device, got {dev}")
    T = bucket_seq.shape[0]
    N = requests.shape[0]
    if bucket_seq.dim() != 1 or T < 1 or T & (T - 1):
        raise ValueError(f"bucket_seq: want (T,) with T a power of two, got "
                         f"{tuple(bucket_seq.shape)}")
    if (requests.device != dev or requests.dtype != torch.bool
            or requests.dim() != 1):
        raise ValueError(f"requests: want (N,) bool on {dev}, got "
                         f"{tuple(requests.shape)} {requests.dtype} on "
                         f"{requests.device}")
    scal = torch.cat([_u32_scalar(x, dev)
                      for x in (ticket, grant, post_n, salt)])
    if scal.device != dev:
        raise ValueError(f"the scalars must lie on {dev}")
    scal = u32.to_bits32(scal).contiguous()
    seq = u32.to_bits32(bucket_seq).contiguous()
    req = requests.contiguous()
    tickets = torch.empty(N, dtype=torch.int32, device=dev)
    admitted = torch.empty(N, dtype=torch.bool, device=dev)
    bucket = torch.empty(N, dtype=torch.int32, device=dev)
    woken = torch.empty(N, dtype=torch.bool, device=dev)
    scal_o = torch.empty(2, dtype=torch.int32, device=dev)
    seq_o = torch.empty(T, dtype=torch.int32, device=dev)
    lib = build.load("sema_batch", _SIG)
    rc = lib.sema_batch_launch(
        req.data_ptr(), N, scal.data_ptr(), seq.data_ptr(), T,
        tickets.data_ptr(), admitted.data_ptr(), bucket.data_ptr(),
        woken.data_ptr(), scal_o.data_ptr(), seq_o.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "sema_batch")
    build.LAUNCHES["sema_batch"] += 1
    so = u32.from_bits32(scal_o)
    return (so[0], so[1], u32.from_bits32(seq_o), u32.from_bits32(tickets),
            admitted, bucket, woken)
