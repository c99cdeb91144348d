"""Ragged chunked prefill over the block-paged KV pool as a CUDA kernel
(``csrc/paged_prefill.cu``) — the port of the TPU kernel
``repro.kernels.paged_prefill.paged_prefill``.

One launch serves every slot's chunk of the round: it writes the chunk
K/V into the slots' pool blocks (in place) and computes causal-in-chunk
plus full-prior attention for the chunk queries.  One CTA per (slot, kv
head, tile of up to 16 query rows).  Plain version:
:func:`paged_prefill_plain` (`kernels.ref.paged_prefill_ref`): the pools
agree bit for bit, the outputs to f32 rounding.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import paged_prefill_ref as paged_prefill_plain

__all__ = ["paged_prefill", "paged_prefill_plain"]

MAX_G = 16
MAX_HD = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"paged_prefill_launch": [_P] * 9 + [_I] * 7 + [ctypes.c_float, _P]}


def paged_prefill(q, k_chunk, v_chunk, k_pool, v_pool, block_tbl, off, lens):
    """q: (S, CT, H, hd) f32; k_chunk/v_chunk: (S, CT, KV, hd) f32;
    k_pool/v_pool: (NB, BS, KV, hd) f32, written IN PLACE; block_tbl:
    (S, MB) i32 (-1 = unallocated); off/lens: (S,) i32 chunk start and
    length (lens ≤ CT; rows past CT do not exist).  All contiguous on one
    CUDA device.  Returns ``(out (S, CT, H, hd), k_pool, v_pool)`` — the
    pools are the tensors passed in."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_prefill runs on a CUDA device, got {dev}")
    if q.dim() != 4 or k_pool.dim() != 4 or block_tbl.dim() != 2:
        raise ValueError("want q (S, CT, H, hd), pools (NB, BS, KV, hd), "
                         "block_tbl (S, MB)")
    S, CT, H, hd = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = block_tbl.shape[1]
    for name, t, dt, shape in (
            ("q", q, torch.float32, (S, CT, H, hd)),
            ("k_chunk", k_chunk, torch.float32, (S, CT, KV, hd)),
            ("v_chunk", v_chunk, torch.float32, (S, CT, KV, hd)),
            ("k_pool", k_pool, torch.float32, (NB, BS, KV, hd)),
            ("v_pool", v_pool, torch.float32, (NB, BS, KV, hd)),
            ("block_tbl", block_tbl, torch.int32, (S, MB)),
            ("off", off, torch.int32, (S,)),
            ("lens", lens, torch.int32, (S,))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {shape} {dt} on {dev},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
    if H % KV or H // KV > MAX_G or not 1 <= hd <= MAX_HD:
        raise ValueError(f"need H % KV == 0, H/KV <= {MAX_G} and hd <= "
                         f"{MAX_HD} (got H={H}, KV={KV}, hd={hd})")
    out = torch.empty_like(q)
    lib = build.load("paged_prefill", _SIG)
    rc = lib.paged_prefill_launch(
        q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tbl.data_ptr(),
        off.data_ptr(), lens.data_ptr(), out.data_ptr(), S, CT, H, KV, hd,
        BS, MB, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "paged_prefill")
    build.LAUNCHES["paged_prefill"] += 1
    return out, k_pool, v_pool
