"""Ragged chunked prefill over the block-paged KV pool as a CUDA kernel
(``csrc/paged_prefill.cu``) — the port of the TPU kernel
``repro.kernels.paged_prefill.paged_prefill``.

One launch serves every slot's chunk of the round: it writes the chunk
K/V into the slots' pool blocks (in place) and computes causal-in-chunk
plus full-prior attention for the chunk queries.  Split-K over one wave:
a tile is (slot, kv head, up to 16 query rows), its cost the 16-key tiles
its rows see; the launch's ``grid`` CTAs (the SMs times the CTAs an SM
holds) each take an equal share of the round's key tiles
(`split_plan`: the cut the kernel makes on the card from ``off`` and
``lens``), and the last CTA of a tile cut in pieces merges their partials
with log-sum-exp weights.  Both products run on the TF32 tensor cores at
f32 accuracy (3xTF32).  Plain version: :func:`paged_prefill_plain`
(`kernels.ref.paged_prefill_ref`; the split arithmetic:
`ref.paged_prefill_split_ref`): the pools agree bit for bit, the outputs
to f32 rounding.

The wrapper's host work is the checks, one allocation (the output and the
partials' workspace, 2 grid 16 hd floats, share it) and one ``ctypes``
call bound once.  The merge's arrival counters are one int32 array per
device and stream (`build.arrival_counters`): each launch leaves them
zero.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import paged_prefill_ref as paged_prefill_plain

__all__ = ["paged_prefill", "paged_prefill_plain", "split_plan",
           "tile_costs"]

MAX_G = 16
MAX_HD = 1024
KEY_TILE = 16        # keys a CTA holds in shared memory at a time

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"paged_prefill_launch": [_P] * 11 + [_I] * 7
        + [ctypes.c_float, _I, _P],
        "paged_prefill_grid": [_I, _I, _I, _P]}
_F32, _I32 = torch.float32, torch.int32
_lib = None         # the loaded library, bound at the first call
_grids = {}         # (device index, S, hd, MB) -> CTAs of one wave


def tile_costs(off, lens, CT: int, H: int, KV: int, BS: int, MB: int):
    """Each tile's cost as the kernel counts it, in its order (slot, kv
    head, tile of R = min(16 // G, CT) chunk rows): the 16-key tiles its
    valid rows see (keys 0 .. off + j0 + valid rows − 1, within the
    table), 0 for a tile with no valid row.  ``off``/``lens``: sequences
    of ints.  Returns ``(costs, R)``."""
    R = min(MAX_G // (H // KV), CT)
    costs = []
    for o, n in zip(off, lens):
        n = min(int(n), CT)
        for _ in range(KV):
            for j0 in range(0, CT, R):
                nv = max(0, min(R, CT - j0, n - j0))
                kend = min(int(o) + j0 + nv, MB * BS)
                costs.append(-(-kend // KEY_TILE) if nv else 0)
    return costs, R


def split_plan(costs, grid: int) -> list:
    """The cut the kernel makes: the W = Σ costs key tiles, tile after
    tile, are shared among ``grid`` CTAs, CTA b taking [⌊bW/grid⌋,
    ⌊(b+1)W/grid⌋) — one wave, every CTA the same number of key tiles
    give or take one.  Returns the pieces ``(tile, k0, k1, cta, slot)``
    in order: key tiles [k0, k1) of the tile on CTA ``cta``; ``slot`` is
    where a cut tile's partial goes in that CTA's workspace (0: the tile
    began before the CTA's range, 1: it began inside it), None for a
    tile whole on one CTA."""
    W = sum(costs)
    pieces, P = [], 0
    for t, c in enumerate(costs):
        if c:
            # the CTAs holding key tiles P and P + c - 1; those between
            # with an empty range (W < grid) hold nothing
            b0 = ((P + 1) * grid + W - 1) // W - 1
            b1 = ((P + c) * grid + W - 1) // W - 1
            cut = [b for b in range(b0, b1 + 1)
                   if b * W // grid < (b + 1) * W // grid]
            for b in cut:
                lo, hi = b * W // grid, (b + 1) * W // grid
                k0, k1 = max(P, lo) - P, min(P + c, hi) - P
                slot = None if len(cut) == 1 else (0 if P < lo else 1)
                pieces.append((t, k0, k1, b, slot))
        P += c
    return pieces


def paged_prefill(q, k_chunk, v_chunk, k_pool, v_pool, block_tbl, off, lens):
    """q: (S, CT, H, hd) f32; k_chunk/v_chunk: (S, CT, KV, hd) f32;
    k_pool/v_pool: (NB, BS, KV, hd) f32, written IN PLACE; block_tbl:
    (S, MB) i32 (-1 = unallocated); off/lens: (S,) i32 chunk start and
    length (lens ≤ CT; rows past CT do not exist).  All contiguous on one
    CUDA device.  Returns ``(out (S, CT, H, hd), k_pool, v_pool)`` — the
    pools are the tensors passed in; no host sync."""
    global _lib
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_prefill runs on a CUDA device, got {dev}")
    if q.dim() != 4 or k_pool.dim() != 4 or block_tbl.dim() != 2:
        raise ValueError("want q (S, CT, H, hd), pools (NB, BS, KV, hd), "
                         "block_tbl (S, MB)")
    S, CT, H, hd = q.shape
    NB, BS, KV, _ = k_pool.shape
    MB = block_tbl.shape[1]
    di = dev.index
    for name, t, dt, shape in (
            ("q", q, _F32, (S, CT, H, hd)),
            ("k_chunk", k_chunk, _F32, (S, CT, KV, hd)),
            ("v_chunk", v_chunk, _F32, (S, CT, KV, hd)),
            ("k_pool", k_pool, _F32, (NB, BS, KV, hd)),
            ("v_pool", v_pool, _F32, (NB, BS, KV, hd)),
            ("block_tbl", block_tbl, _I32, (S, MB)),
            ("off", off, _I32, (S,)),
            ("lens", lens, _I32, (S,))):
        if (t.dtype != dt or t.shape != shape or t.get_device() != di
                or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous {shape} {dt} on {dev},"
                             f" got {tuple(t.shape)} {t.dtype} on {t.device}")
    if H % KV or H // KV > MAX_G or not 1 <= hd <= MAX_HD:
        raise ValueError(f"need H % KV == 0, H/KV <= {MAX_G} and hd <= "
                         f"{MAX_HD} (got H={H}, KV={KV}, hd={hd})")
    if _lib is None:
        _lib = build.load("paged_prefill", _SIG)
    key = (di, S, hd, MB)
    grid = _grids.get(key)
    if grid is None:
        g = ctypes.c_int(0)
        build.check(_lib.paged_prefill_grid(S, hd, MB, ctypes.byref(g)),
                    "paged_prefill_grid")
        if g.value < 1:
            raise ValueError(f"paged_prefill: S={S} slots, hd={hd} and MB={MB}"
                             " do not fit one CTA's shared memory")
        grid = _grids[key] = g.value
    R = min(MAX_G // (H // KV), CT)
    n_tiles = S * KV * -(-CT // R)
    stream = torch._C._cuda_getCurrentRawStream(di)
    counters = build.arrival_counters("paged_prefill", dev, stream, n_tiles)
    n_out = S * CT * H * hd
    ws = 2 * grid * MAX_G * (hd + 2)
    buf = torch.empty(n_out + ws, dtype=_F32, device=dev)
    rc = _lib.paged_prefill_launch(
        q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tbl.data_ptr(),
        off.data_ptr(), lens.data_ptr(), buf.data_ptr(),
        buf.data_ptr() + 4 * n_out, counters.data_ptr(), S, CT, H, KV, hd,
        BS, MB, 1.0 / math.sqrt(hd), grid, stream)
    if rc:
        build.check(rc, "paged_prefill")
    build.LAUNCHES["paged_prefill"] += 1
    return buf.as_strided((S, CT, H, hd), (CT * H * hd, H * hd, hd, 1)), \
        k_pool, v_pool
