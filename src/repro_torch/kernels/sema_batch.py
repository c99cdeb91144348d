"""The batched TWA semaphore pass (take + post + wake) as a CUDA kernel
(``csrc/sema_batch.cu``) — the port of the TPU kernel
``repro.kernels.sema_batch.sema_batch``.

One block of 1024 threads ranks the requesting rows with warp ballots,
carries the ticket base across tiles, and bumps the waiting array's
enabled buckets in closed form (stride 17 is a unit mod T).  It reads the
caller's u32 carriers as they lie and writes every output, in the dtype
the caller gets, into one buffer: the wrapper's host work is the checks,
one ``torch.empty`` and one ``ctypes`` call bound once, and the outputs
are ``as_strided`` views of that buffer.  Plain version:
:func:`sema_batch_plain` (`kernels.ref.sema_batch_ref`), which the kernel
matches bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.u32 import MASK32
from . import build
from .ref import sema_batch_ref

__all__ = ["sema_batch", "sema_batch_plain"]

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIG = {"sema_batch_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _U, _U, _U, _U,
                              _P, _P]}
_I64, _I32, _BOOL = torch.int64, torch.int32, torch.bool
_launch = None      # the ctypes entry, bound at the first call


def sema_batch_plain(ticket, grant, bucket_seq, requests, post_n, salt):
    """`ref.sema_batch_ref` in the kernel's return order."""
    r = sema_batch_ref(ticket, grant, bucket_seq, requests, post_n, salt)
    return (r["ticket"], r["grant"], r["bucket_seq"], r["tickets"],
            r["admitted"], r["bucket"], r["woken"])


def _bad(what: str, x) -> ValueError:
    got = (f"{tuple(x.shape)} {x.dtype} on {x.device}"
           f"{'' if x.is_contiguous() else ' (strided)'}"
           if isinstance(x, torch.Tensor) else repr(x))
    return ValueError(f"sema_batch: {what}; got {got}")


def sema_batch(ticket, grant, bucket_seq, requests, post_n, salt):
    """One pass on the card.  ``ticket``/``grant``/``post_n``/``salt``:
    u32 carriers, each a one-element int64 tensor on the device (read
    there) or a Python int; ``bucket_seq`` (T,) int64 u32 carriers,
    T a power of two; ``requests`` (N,) bool; all contiguous on one CUDA
    device.  Returns ``(ticket', grant', bucket_seq', tickets
    (N,), admitted (N,) bool, bucket (N,) i32, woken (N,) bool)`` — the
    JAX wrapper's order, the carriers int64 as the plain version gives
    them, all views of one buffer; no host sync."""
    global _launch
    dev = bucket_seq.device
    di = dev.index
    if (dev.type != "cuda" or bucket_seq.dim() != 1
            or bucket_seq.dtype != _I64
            or not bucket_seq.is_contiguous()):
        raise _bad("want bucket_seq (T,) int64 carriers, contiguous on a "
                   "CUDA device", bucket_seq)
    T = bucket_seq.shape[0]
    if T < 1 or T & (T - 1):
        raise _bad("want T a power of two", bucket_seq)
    if (requests.dtype != _BOOL or requests.dim() != 1
            or requests.get_device() != di or not requests.is_contiguous()):
        raise _bad(f"want requests (N,) bool, contiguous on {dev}", requests)
    N = requests.shape[0]
    ptr, val = [], []
    for name, x in (("ticket", ticket), ("grant", grant),
                    ("post_n", post_n), ("salt", salt)):
        if isinstance(x, torch.Tensor):
            if x.dtype != _I64 or x.numel() != 1 or x.get_device() != di:
                raise _bad(f"want {name} a one-element int64 tensor on "
                           f"{dev}, or an int", x)
            ptr.append(x.data_ptr())
            val.append(0)
        else:
            ptr.append(None)
            val.append(int(x) & MASK32)
    if _launch is None:
        _launch = build.load("sema_batch", _SIG).sema_batch_launch

    # one buffer: ticket', grant', bucket_seq' (T), tickets (N) as int64,
    # the buckets (N) as int32, then admitted and woken (N bools each)
    n64 = 2 + T + N
    m0 = 8 * n64 + 4 * N
    buf = torch.empty(-(-(m0 + 2 * N) // 8) * 8, dtype=_BOOL, device=dev)
    rc = _launch(requests.data_ptr(), N, bucket_seq.data_ptr(), T, *ptr,
                 *val, buf.data_ptr(), torch._C._cuda_getCurrentRawStream(di))
    if rc:
        build.check(rc, "sema_batch")
    build.LAUNCHES["sema_batch"] += 1
    u = buf.view(_I64)
    one = (1,)
    return (u.as_strided((), (), 0), u.as_strided((), (), 1),
            u.as_strided((T,), one, 2), u.as_strided((N,), one, 2 + T),
            buf.as_strided((N,), one, m0),
            buf.view(_I32).as_strided((N,), one, 2 * n64),
            buf.as_strided((N,), one, m0 + N))
