"""Unsigned 32-bit counter arithmetic on int64 tensors.

The reference keeps tickets, grants, ``bucket_seq``, salts and hashes as
``uint32`` and leans on wrap-around arithmetic.  PyTorch's ``torch.uint32``
has no add, compare or shift on the CPU, and ``int32`` compares signed and
shifts arithmetically, so the port carries every such value as an
``int64`` tensor holding a number in ``[0, 2³²)``.  Every operation that can
leave that range goes through this module and is masked back into it, so
the values equal the reference's ``uint32`` bit for bit across the 2³² wrap.

Rule of the port: an ``int64`` tensor in engine or semaphore state is a u32
carrier; counts, indices and signed distances are ``int32``.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = (1 << 32) - 1
_HALF = 1 << 31


def u32(x, device=None) -> torch.Tensor:
    """A u32 carrier from a Python int, numpy array (any integer dtype,
    ``uint32`` included) or tensor, reduced mod 2³²."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(np.asarray(a, np.int64) & MASK32, device=device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """A u32 carrier as a numpy ``uint32`` array."""
    return x.detach().cpu().numpy().astype(np.uint32)


def add(a, b):
    return (a + b) & MASK32


def sub(a, b):
    return (a - b) & MASK32


def mul(a, k):
    """``a · k mod 2³²`` for a u32 carrier ``a`` and a u32 ``k`` (tensor or
    int).  The product is split in 16-bit halves of ``k`` so no partial
    product leaves int64 (a plain ``a · k`` can reach 2⁶⁴)."""
    lo = a * (k & 0xFFFF)
    hi = ((a * ((k >> 16) & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def sdist(a, b) -> torch.Tensor:
    """Signed distance ``a − b`` under the u32 wrap, as int32 — the
    reference's ``(a - b).astype(int32)``."""
    return (((a - b + _HALF) & MASK32) - _HALF).to(torch.int32)


def to_bits32(a: torch.Tensor) -> torch.Tensor:
    """The same 32 bits as an int32 tensor (for a kernel that reads the
    buffer as ``uint32_t``)."""
    return (((a + _HALF) & MASK32) - _HALF).to(torch.int32)


def from_bits32(t: torch.Tensor) -> torch.Tensor:
    """An int32 (or uint32-bits) buffer back to a u32 carrier."""
    return t.to(torch.int64) & MASK32
