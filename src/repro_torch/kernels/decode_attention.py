"""Single-token decode attention over a dense (possibly rolling) KV cache
as a CUDA kernel (``csrc/decode_attention.cu``) — the port of the TPU
kernel ``repro.kernels.decode_attention.decode_attention``.

One CTA per (row, kv head) carries the G query heads of the group and
walks the cache in 64-row tiles; the mask comes from the stored
positions (-1 = empty) and the window.  Plain version:
:func:`decode_attention_plain` (`ref.single_query_attention`; oracle
`ref.decode_attention_ref`); the two agree to f32 rounding.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import single_query_attention

__all__ = ["decode_attention", "decode_attention_plain"]

MAX_G = 16
MAX_HD = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"decode_attention_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, ctypes.c_float, _P]}


def decode_attention_plain(q, k, v, kv_pos, q_pos, *, window: int = 0):
    """q (B, H, hd) → (B, H, hd) through `single_query_attention`."""
    return single_query_attention(q[:, None], k, v, q_pos[:, None], kv_pos,
                                  window=window)[:, 0]


def decode_attention(q, k, v, kv_pos, q_pos, *, window: int = 0):
    """q: (B, H, hd) f32; k/v: (B, C, KV, hd) f32; kv_pos: (B, C) i32
    (-1 = empty); q_pos: (B,) i32; all contiguous on one CUDA device.
    Returns (B, H, hd) f32; no host sync."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on a CUDA device, got {dev}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("want q (B, H, hd) and k/v (B, C, KV, hd)")
    B, H, hd = q.shape
    C, KV = k.shape[1], k.shape[2]
    for name, t, dt, shape in (
            ("q", q, torch.float32, (B, H, hd)),
            ("k", k, torch.float32, (B, C, KV, hd)),
            ("v", v, torch.float32, (B, C, KV, hd)),
            ("kv_pos", kv_pos, torch.int32, (B, C)),
            ("q_pos", q_pos, torch.int32, (B,))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {shape} {dt} on {dev},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
    if H % KV or H // KV > MAX_G or not 1 <= hd <= MAX_HD:
        raise ValueError(f"need H % KV == 0, H/KV <= {MAX_G} and hd <= "
                         f"{MAX_HD} (got H={H}, KV={KV}, hd={hd})")
    out = torch.empty_like(q)
    lib = build.load("decode_attention", _SIG)
    rc = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
        q_pos.data_ptr(), out.data_ptr(), B, C, H, KV, hd, int(window),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "decode_attention")
    build.LAUNCHES["decode_attention"] += 1
    return out
