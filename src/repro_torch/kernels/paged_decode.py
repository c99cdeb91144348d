"""Ragged flash-decode over the block-paged KV pool as a CUDA kernel
(``csrc/paged_decode.cu``) — the port of the TPU kernel
``repro.kernels.paged_decode.paged_decode``.

One CTA per (slot, kv head) walks the slot's block table up to
``cdiv(len, BS)`` blocks, so attention bytes follow the live tokens, not
the table width.  Plain version: :func:`paged_decode_plain`
(`kernels.ref.paged_decode_ref`); the two agree to f32 rounding (the sums
run in another order).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import paged_decode_ref as paged_decode_plain

__all__ = ["paged_decode", "paged_decode_plain"]

MAX_G = 16
MAX_HD = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"paged_decode_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, ctypes.c_float, _P]}


def paged_decode(q, k_pool, v_pool, block_tbl, lens):
    """q: (S, H, hd) f32; k_pool/v_pool: (NB, BS, KV, hd) f32; block_tbl:
    (S, MB) i32 (-1 = unallocated); lens: (S,) i32 valid tokens per slot.
    All contiguous on one CUDA device.  Returns (S, H, hd) f32."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_decode runs on a CUDA device, got {dev}")
    if q.dim() != 3 or k_pool.dim() != 4 or block_tbl.dim() != 2:
        raise ValueError("want q (S, H, hd), pools (NB, BS, KV, hd), "
                         "block_tbl (S, MB)")
    S, H, hd = q.shape
    NB, BS, KV, hd_k = k_pool.shape
    MB = block_tbl.shape[1]
    for name, t, dt, shape in (
            ("q", q, torch.float32, (S, H, hd)),
            ("k_pool", k_pool, torch.float32, (NB, BS, KV, hd)),
            ("v_pool", v_pool, torch.float32, (NB, BS, KV, hd)),
            ("block_tbl", block_tbl, torch.int32, (S, MB)),
            ("lens", lens, torch.int32, (S,))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {shape} {dt} on {dev},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
    if H % KV or H // KV > MAX_G or not 1 <= hd <= MAX_HD:
        raise ValueError(f"need H % KV == 0, H/KV <= {MAX_G} and hd <= "
                         f"{MAX_HD} (got H={H}, KV={KV}, hd={hd})")
    out = torch.empty_like(q)
    lib = build.load("paged_decode", _SIG)
    rc = lib.paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tbl.data_ptr(), lens.data_ptr(), out.data_ptr(), S, H, KV, hd,
        BS, MB, 1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "paged_decode")
    build.LAUNCHES["paged_decode"] += 1
    return out
