"""Ragged flash-decode over the block-paged KV pool as a CUDA kernel
(``csrc/paged_decode.cu``) — the port of the TPU kernel
``repro.kernels.paged_decode.paged_decode``.

Split-K over one wave: the unit of work is a live pool block of a (slot,
kv head), ``block_costs`` of them per pair; the launch's ``grid`` CTAs
(the SMs times the CTAs an SM holds) each take an equal share of the
round's blocks (`split_plan`: the cut the kernel makes on the card from
``lens``), and the last CTA of a (slot, kv head) cut in pieces merges
their partials with log-sum-exp weights.  Attention bytes follow the live
tokens, and the launch lasts as long as an even share of them, not as
long as the longest slot.  Plain version: :func:`paged_decode_plain`
(`kernels.ref.paged_decode_ref`; the split arithmetic:
`ref.paged_decode_split_ref`); the two agree to f32 rounding.

The wrapper's host work is the checks, one allocation (the output and the
partials' workspace share it) and one ``ctypes`` call bound once.  The
merge's arrival counters are one int32 array per device and stream
(`build.arrival_counters`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .paged_prefill import split_plan as _cut
from .ref import paged_decode_ref as paged_decode_plain

__all__ = ["paged_decode", "paged_decode_plain", "block_costs",
           "split_plan"]

MAX_G = 16
MAX_HD = 1024
KEY_ROWS = 8        # keys a ring slot holds at most (csrc kMaxKT)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"paged_decode_launch": [_P] * 8 + [_I] * 7
        + [ctypes.c_float, _I, _P],
        "paged_decode_grid": [_I] * 6 + [_P]}
_F32, _I32 = torch.float32, torch.int32
_launch = None      # the ctypes entry, bound at the first call
_grid = None        # the grid query, bound with it
_plans = {}         # (device index, H, KV, hd, BS, MB) -> (KT, grid)


def block_costs(lens, KV: int, BS: int, MB: int) -> list:
    """Each (slot, kv head) pair's live blocks, pair s·KV + h:
    ``min(cdiv(len, BS), MB)``, 0 for an idle slot.  ``lens``: a sequence
    of ints."""
    return [min(-(-int(n) // BS), MB) if int(n) > 0 else 0
            for n in lens for _ in range(KV)]


def split_plan(lens, KV: int, BS: int, MB: int, grid: int) -> list:
    """The cut the kernel makes: the W = Σ `block_costs` live blocks, pair
    after pair, shared among ``grid`` CTAs, CTA b taking [⌊bW/grid⌋,
    ⌊(b+1)W/grid⌋) — every CTA the same number of blocks give or take
    one.  Returns the pieces ``(pair, k0, k1, cta, slot)`` in order:
    blocks [k0, k1) of the pair on CTA ``cta``; ``slot`` is where a cut
    pair's partial goes in that CTA's workspace (0: the pair began before
    the CTA's range, 1: it began inside it), None for a pair whole on one
    CTA (`paged_prefill.split_plan` over these costs)."""
    return _cut(block_costs(lens, KV, BS, MB), grid)


def _plan(di: int, H: int, KV: int, hd: int, BS: int, MB: int) -> tuple:
    """``(KT, grid)``: key tiles of KT rows (``BS`` rounded up to a power
    of two, at most `KEY_ROWS`, halved until the CTA fits) and one wave
    of CTAs at that size."""
    key = (di, H, KV, hd, BS, MB)
    plan = _plans.get(key)
    if plan is None:
        kt = min(KEY_ROWS, 1 << (BS - 1).bit_length())
        g = ctypes.c_int(0)
        while kt >= 1:
            build.check(_grid(H, KV, hd, BS, MB, kt, ctypes.byref(g)),
                        "paged_decode_grid")
            if g.value > 0:
                break
            kt //= 2
        if g.value < 1:
            raise ValueError(f"paged_decode: H={H}, KV={KV}, hd={hd} and "
                             f"MB={MB} do not fit one CTA's shared memory")
        plan = _plans[key] = (kt, g.value)
    return plan


def paged_decode(q, k_pool, v_pool, block_tbl, lens):
    """q: (S, H, hd) f32; k_pool/v_pool: (NB, BS, KV, hd) f32; block_tbl:
    (S, MB) i32 (-1 = unallocated); lens: (S,) i32 valid tokens per slot.
    All contiguous on one CUDA device.  Returns (S, H, hd) f32; no host
    sync."""
    global _launch, _grid
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_decode runs on a CUDA device, got {dev}")
    if q.dim() != 3 or k_pool.dim() != 4 or block_tbl.dim() != 2:
        raise ValueError("want q (S, H, hd), pools (NB, BS, KV, hd), "
                         "block_tbl (S, MB)")
    S, H, hd = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = block_tbl.shape[1]
    di = dev.index
    for name, t, dt, shape in (
            ("q", q, _F32, (S, H, hd)),
            ("k_pool", k_pool, _F32, (NB, BS, KV, hd)),
            ("v_pool", v_pool, _F32, (NB, BS, KV, hd)),
            ("block_tbl", block_tbl, _I32, (S, MB)),
            ("lens", lens, _I32, (S,))):
        if (t.dtype != dt or t.shape != shape or t.get_device() != di
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {shape} {dt} on {dev},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
    if H % KV or H // KV > MAX_G or not 1 <= hd <= MAX_HD:
        raise ValueError(f"need H % KV == 0, H/KV <= {MAX_G} and hd <= "
                         f"{MAX_HD} (got H={H}, KV={KV}, hd={hd})")
    if _launch is None:
        lib = build.load("paged_decode", _SIG)
        _launch, _grid = lib.paged_decode_launch, lib.paged_decode_grid
    kt, grid = _plan(di, H, KV, hd, BS, MB)
    stream = torch._C._cuda_getCurrentRawStream(di)
    counters = build.arrival_counters("paged_decode", dev, stream, S * KV)
    # the output (padded to 16 bytes), then 2 grid partials of G rows of
    # hd4 floats and their (m, l)
    G, hd4 = H // KV, -(-hd // 4) * 4
    n_out = -(-S * H * hd // 4) * 4
    buf = torch.empty(n_out + 2 * grid * G * (hd4 + 2), dtype=_F32,
                      device=dev)
    rc = _launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tbl.data_ptr(), lens.data_ptr(), buf.data_ptr(),
        buf.data_ptr() + 4 * n_out, counters.data_ptr(), S, H, KV, hd, BS,
        MB, kt, 1.0 / math.sqrt(hd), grid, stream)
    if rc:
        build.check(rc, "paged_decode")
    build.LAUNCHES["paged_decode"] += 1
    return buf.as_strided((S, H, hd), (H * hd, hd, 1))
