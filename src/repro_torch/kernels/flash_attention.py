"""Blockwise causal (optionally sliding-window) attention forward (GQA) as a CUDA
kernel (``csrc/flash_attention.cu``) — the port of the TPU kernel
``repro.kernels.flash_attention.flash_attention_fwd``.

One CTA per (batch, kv head, tile of Br query positions) carries the G
heads of the kv head as m16 tiles, one warp each, takes S = QKᵀ and
O += PV on the TF32 tensor cores at f32 accuracy (3xTF32 ``mma.sync``),
keeps the online softmax in registers, double-buffers the 32-key K/V
tiles with ``cp.async`` and skips the tiles the mask empties; the
launcher picks Br from G, hd and Sq.  Plain version:
:func:`flash_attention_plain` (`ref.blockwise_attention` at positions
0..S−1; oracle `ref.mha_ref`; the kernel's arithmetic on the CPU:
``blockwise_attention(..., einsum=ref.einsum_3xtf32)``); the two agree
within 2e-5.  Causal only: the port's one caller, the model's prefill,
is causal.  The wrapper's host work is one allocation, the checks the
kernel cannot run without and one ``ctypes`` call bound once.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import blockwise_attention

__all__ = ["flash_attention", "flash_attention_plain"]

MAX_HD = 256   # the widest head whose one-position tile fits shared memory

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"flash_attention_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, ctypes.c_float, _P]}
_F32 = torch.float32
_launch = None      # the ctypes entry, bound at the first call


def flash_attention_plain(q, k, v, *, window: int = 0):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) through
    `blockwise_attention`, query i and key j at positions i and j."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    qp = torch.arange(Sq, dtype=torch.int32, device=q.device).expand(B, Sq)
    kp = torch.arange(Sk, dtype=torch.int32, device=q.device).expand(B, Sk)
    return blockwise_attention(q, k, v, qp, kp, window=window)


def _bad(q, k, v):
    parts = ", ".join(f"{n} {tuple(t.shape)} {t.dtype} on {t.device}"
                      f"{'' if t.is_contiguous() else ' (strided)'}"
                      for n, t in (("q", q), ("k", k), ("v", v)))
    return ValueError("flash_attention wants contiguous q (B, Sq, H, hd) and "
                      "k/v (B, Sk, KV, hd) f32 on one CUDA device, H % KV == "
                      f"0 and hd <= {MAX_HD}; got {parts}")


def flash_attention(q, k, v, *, window: int = 0):
    """q: (B, Sq, H, hd) f32; k/v: (B, Sk, KV, hd) f32; all contiguous on
    one CUDA device.  Query i sees key j iff j < Sk and i ≥ j, and
    i − j < ``window`` when window > 0.  Returns
    (B, Sq, H, hd) f32; no host sync."""
    global _launch
    dev = q.device
    if q.dim() != 4 or k.dim() != 4:
        raise _bad(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (dev.type != "cuda" or k.device != dev or v.device != dev
            or q.dtype != _F32 or k.dtype != _F32 or v.dtype != _F32
            or k.shape != (B, Sk, KV, hd) or v.shape != k.shape
            or not (q.is_contiguous() and k.is_contiguous()
                    and v.is_contiguous())
            or KV < 1 or H % KV or not 1 <= hd <= MAX_HD):
        raise _bad(q, k, v)
    if _launch is None:
        _launch = build.load("flash_attention", _SIG).flash_attention_launch
    out = torch.empty_like(q)
    rc = _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                 Sq, Sk, H, KV, hd, int(window), 1.0 / math.sqrt(hd),
                 torch._C._cuda_getCurrentRawStream(dev.index))
    if rc:
        build.check(rc, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out
