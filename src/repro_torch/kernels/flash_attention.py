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

On bf16 tensors :func:`flash_attention` launches the same kernel's
bf16 instantiation (the reference's production dtype): one ``mma.sync``
m16n8k16 bf16 product where the f32 path takes three, 64-key tiles, up
to 128 query rows a CTA, fragments by ``ldmatrix`` (V's by
``ldmatrix.trans``), P rounded to bf16 into P·V, the output in bf16.
Its plain version is the same `flash_attention_plain` on bf16 tensors
(P rounded as the reference rounds it); the two agree within a few bf16
ulps of each output row's largest magnitude.

At the head widths of the repo's published configs (hd 64, 128, 256)
the bf16 path launches Hopper's own kernel instead
(``csrc/flash_attention_sm90.cu``): TMA tile loads by a producer warp,
``wgmma`` products in two consumer warpgroups whose softmax overlaps the
tensor cores, all G heads of a kv head for 128 // G positions a CTA.  It
computes the same function.  `wgmma_route` decides from the shapes and
the tensors' alignment alone which kernel a call takes; both count as
``flash_attention_bf16`` launches, and `ROUTES` counts each route apart.
A failed build or launch of either raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import blockwise_attention

__all__ = ["flash_attention", "flash_attention_bf16",
           "flash_attention_plain", "wgmma_route", "ROUTES"]

MAX_HD = 256   # the widest head whose one-position tile fits shared memory
WGMMA_HD = (64, 128, 256)   # the head widths of the wgmma kernel
WGMMA_MAX_G = 128           # query heads a kv head: one position a CTA
# bf16 launches by route: the wgmma kernel, or csrc/flash_attention.cu's
# mma.sync instantiation (every other head width, unaligned tensors)
ROUTES = {"wgmma": 0, "mma_sync": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
# dtype -> (the ctypes entry's name, its launch counter)
_ENTRY = {torch.float32: ("flash_attention_launch", "flash_attention"),
          torch.bfloat16: ("flash_attention_bf16_launch",
                           "flash_attention_bf16")}
_SIG = {"flash_attention": {"flash_attention_launch": _ARGS,
                            "flash_attention_bf16_launch": _ARGS},
        "flash_attention_sm90": {"flash_attention_wgmma_launch": _ARGS}}
_launch = {}        # dtype or "wgmma" -> the ctypes entry, bound at first


def flash_attention_plain(q, k, v, *, window: int = 0):
    """q (B, Sq, H, hd), k/v (B, Sk, KV, hd) through
    `blockwise_attention`, query i and key j at positions i and j."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    qp = torch.arange(Sq, dtype=torch.int32, device=q.device).expand(B, Sq)
    kp = torch.arange(Sk, dtype=torch.int32, device=q.device).expand(B, Sk)
    return blockwise_attention(q, k, v, qp, kp, window=window)


def _bad(q, k, v, dtype):
    parts = ", ".join(f"{n} {tuple(t.shape)} {t.dtype} on {t.device}"
                      f"{'' if t.is_contiguous() else ' (strided)'}"
                      for n, t in (("q", q), ("k", k), ("v", v)))
    return ValueError(f"{_ENTRY[dtype][1]} wants "
                      "contiguous q (B, Sq, H, hd) and k/v (B, Sk, KV, hd) "
                      f"{dtype} on one CUDA device, H % KV == 0 and hd <= "
                      f"{MAX_HD}; got {parts}")


def wgmma_route(q, k, v) -> bool:
    """Whether bf16 q (B, Sq, H, hd), k/v (B, Sk, KV, hd) take the wgmma
    kernel: hd one of `WGMMA_HD`, 1 <= H / KV <= `WGMMA_MAX_G`, no empty
    dimension, every tensor 16-byte aligned (TMA's rule).  Shapes and
    addresses only; any device."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    return (q.dtype == torch.bfloat16 and hd in WGMMA_HD and KV >= 1
            and H % KV == 0 and 1 <= H // KV <= WGMMA_MAX_G
            and min(B, Sq, Sk) >= 1
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def _run(q, k, v, window: int, dtype):
    """The kernel's ``dtype`` instantiation on q, k, v of that dtype; a
    dtype with no instantiation raises."""
    if dtype not in _ENTRY:
        raise TypeError(f"flash_attention on the card takes f32 or bf16, "
                        f"got {dtype}")
    dev = q.device
    if q.dim() != 4 or k.dim() != 4:
        raise _bad(q, k, v, dtype)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (dev.type != "cuda" or k.device != dev or v.device != dev
            or q.dtype != dtype or k.dtype != dtype or v.dtype != dtype
            or k.shape != (B, Sk, KV, hd) or v.shape != k.shape
            or not (q.is_contiguous() and k.is_contiguous()
                    and v.is_contiguous())
            or KV < 1 or H % KV or not 1 <= hd <= MAX_HD):
        raise _bad(q, k, v, dtype)
    route = ("wgmma" if dtype == torch.bfloat16 and wgmma_route(q, k, v)
             else "mma_sync" if dtype == torch.bfloat16 else None)
    key = "wgmma" if route == "wgmma" else dtype
    fn = _launch.get(key)
    if fn is None:
        lib, entry = (("flash_attention_sm90", "flash_attention_wgmma_launch")
                      if route == "wgmma"
                      else ("flash_attention", _ENTRY[dtype][0]))
        fn = _launch[key] = getattr(build.load(lib, _SIG[lib]), entry)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, hd, int(window), 1.0 / math.sqrt(hd),
            torch._C._cuda_getCurrentRawStream(dev.index))
    name = _ENTRY[dtype][1]
    if rc:
        build.check(rc, f"{name} ({route or 'f32'})")
    build.LAUNCHES[name] += 1
    if route:
        ROUTES[route] += 1
    return out


def flash_attention(q, k, v, *, window: int = 0):
    """q: (B, Sq, H, hd) f32 or bf16; k/v: (B, Sk, KV, hd) of q's dtype;
    all contiguous on one CUDA device.  Query i sees key j iff j < Sk and
    i ≥ j, and i − j < ``window`` when window > 0.  Returns
    (B, Sq, H, hd) in q's dtype from the kernel's instantiation for it
    (bf16: f32 softmax and sums, P rounded to bf16 into P·V); any other
    dtype raises TypeError.  No host sync."""
    return _run(q, k, v, window, q.dtype)


def flash_attention_bf16(q, k, v, *, window: int = 0):
    """`flash_attention` that takes bf16 only."""
    return _run(q, k, v, window, torch.bfloat16)
