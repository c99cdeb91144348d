"""Blockwise causal (optionally sliding-window) attention forward (GQA) as a CUDA
kernel (``csrc/flash_attention.cu``) — the port of the TPU kernel
``repro.kernels.flash_attention.flash_attention_fwd``.

One CTA per (batch, kv head, tile of Br query positions) carries the G
heads of the kv head, stages 32-key K/V tiles in shared memory and
skips the tiles the mask empties; the launcher picks Br from G, hd and
Sq.  Plain version:
:func:`flash_attention_plain` (`ref.blockwise_attention` at positions
0..S−1; oracle `ref.mha_ref`); the two agree to f32 rounding.  Causal
only: the port's one caller, the model's prefill, is causal.
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


def flash_attention_plain(q, k, v, *, window: int = 0):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) through
    `blockwise_attention`, query i and key j at positions i and j."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    qp = torch.arange(Sq, dtype=torch.int32, device=q.device).expand(B, Sq)
    kp = torch.arange(Sk, dtype=torch.int32, device=q.device).expand(B, Sk)
    return blockwise_attention(q, k, v, qp, kp, window=window)


def flash_attention(q, k, v, *, window: int = 0):
    """q: (B, Sq, H, hd) f32; k/v: (B, Sk, KV, hd) f32; all contiguous on
    one CUDA device.  Query i sees key j iff j < Sk and i ≥ j, and
    i − j < ``window`` when window > 0.  Returns
    (B, Sq, H, hd) f32; no host sync."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on a CUDA device, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("want q (B, Sq, H, hd) and k/v (B, Sk, KV, hd)")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q, (B, Sq, H, hd)),
                           ("k", k, (B, Sk, KV, hd)),
                           ("v", v, (B, Sk, KV, hd))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {shape} float32 on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if KV < 1 or H % KV or not 1 <= hd <= MAX_HD:
        raise ValueError(f"need H % KV == 0 and hd <= {MAX_HD} (got H={H}, "
                         f"KV={KV}, hd={hd})")
    out = torch.empty_like(q)
    lib = build.load("flash_attention", _SIG)
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, hd, int(window), 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out
