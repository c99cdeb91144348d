"""Single-token decode attention over a dense (possibly rolling) KV cache
as a CUDA kernel (``csrc/decode_attention.cu``) — the port of the TPU
kernel ``repro.kernels.decode_attention.decode_attention``.

Split-K in one launch: ``B·KV·nsplit`` CTAs each take a run of cache
rows (`split_plan`), and the last CTA of each (row, kv head) merges the
runs' partials with log-sum-exp weights; the mask comes from the stored
positions (-1 = empty) and the window.  Plain version:
:func:`decode_attention_plain` (`ref.single_query_attention`; oracle
`ref.decode_attention_ref`; the split arithmetic:
`ref.decode_attention_split_ref`); the two agree to f32 rounding.
With ``return_lse=True`` the launch also writes each (row, head)'s
log-sum-exp ``m + log l`` of its visible scores (−inf where it sees no
key), for merging the outputs of a cache's sequence shards
(`parallel.shard_attention`).

On bf16 tensors `decode_attention` launches the kernel's bf16
instantiation (the reference's production dtype: bf16 q/k/v, f32
softmax and sums, P rounded to bf16 before P·V, the output in bf16 — in
f32 with ``return_lse``, a partial to be merged and rounded once), its
products on the tensor cores (``decode_tc_kernel``) where hd is a
multiple of 16 up to 128; its plain version is the same
`decode_attention_plain` on bf16 tensors, within a few bf16 ulps of each
output row's largest magnitude (both round P, against running maxima
taken at different points).

The wrapper's host work is kept to one allocation (the output and the
partials' workspace share it), the checks the kernel cannot run without,
and one ``ctypes`` call bound once.  The merge's arrival counters are
one int32 array per device and stream (`build.arrival_counters`): each
launch leaves them zero.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import single_query_attention

__all__ = ["decode_attention", "decode_attention_bf16",
           "decode_attention_plain", "split_plan"]

MAX_G = 16
MAX_HD = 1024
MIN_SPLIT_ROWS = 32   # cache rows a split takes at least

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _I, _I, _P]
_SIG = {"decode_attention_launch": _ARGS,
        "decode_attention_bf16_launch": _ARGS}
# dtype -> (the ctypes entry's name, its launch counter)
_ENTRY = {torch.float32: ("decode_attention_launch", "decode_attention"),
          torch.bfloat16: ("decode_attention_bf16_launch",
                           "decode_attention_bf16")}
_F32, _I32 = torch.float32, torch.int32
_launch = {}        # dtype -> the ctypes entry, bound at its first call
_sms = {}           # device index -> streaming multiprocessors
_plans = {}         # (B, C, KV, SMs) -> (nsplit, rows per split)


def split_plan(B: int, C: int, KV: int, sms: int) -> tuple:
    """``(nsplit, R)``: the cache's C rows cut into ``nsplit`` runs of R
    (the last ragged, none empty), so that the ``B·KV·nsplit`` CTAs fill
    about one wave of ``sms`` with at least `MIN_SPLIT_ROWS` rows each."""
    target = max(1, sms // max(1, B * KV))
    R = max(MIN_SPLIT_ROWS, -(-C // target))
    return max(1, -(-C // R)), R


def decode_attention_plain(q, k, v, kv_pos, q_pos, *, window: int = 0,
                           return_lse: bool = False):
    """q (B, H, hd) → (B, H, hd) through `single_query_attention`; with
    ``return_lse`` also the (B, H) log-sum-exp."""
    out = single_query_attention(q[:, None], k, v, q_pos[:, None], kv_pos,
                                 window=window, return_lse=return_lse)
    if return_lse:
        return out[0][:, 0], out[1]
    return out[:, 0]


def _bad(q, k, v, kv_pos, q_pos, dtype):
    parts = ", ".join(f"{n} {tuple(t.shape)} {t.dtype} on {t.device}"
                      f"{'' if t.is_contiguous() else ' (strided)'}"
                      for n, t in (("q", q), ("k", k), ("v", v),
                                   ("kv_pos", kv_pos), ("q_pos", q_pos)))
    return ValueError(f"{_ENTRY[dtype][1]} wants contiguous q (B, H, hd) "
                      f"and k/v (B, C, KV, hd) {dtype}, kv_pos (B, C) i32, "
                      "q_pos (B,) i32 on one CUDA device, H % KV == 0, "
                      f"H/KV <= {MAX_G}, hd <= {MAX_HD}; got {parts}")


def _setup(i: int, dtype) -> int:
    """Bind the ``dtype`` entry point and learn device ``i``'s SM
    count."""
    if dtype not in _launch:
        _launch[dtype] = getattr(build.load("decode_attention", _SIG),
                                 _ENTRY[dtype][0])
    _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


def decode_attention(q, k, v, kv_pos, q_pos, *, window: int = 0,
                     return_lse: bool = False):
    """q: (B, H, hd) f32 or bf16; k/v: (B, C, KV, hd) of q's dtype;
    kv_pos: (B, C) i32 (-1 = empty); q_pos: (B,) i32; all contiguous on
    one CUDA device.  Returns (B, H, hd) in q's dtype from the kernel's
    instantiation for it, and with ``return_lse`` also the (B, H) f32
    log-sum-exp (the output then f32: a bf16 partial is rounded once,
    after `parallel.shard_attention.lse_merge`); any other dtype raises
    TypeError.  No host sync."""
    return _run(q, k, v, kv_pos, q_pos, window, return_lse, q.dtype)


def decode_attention_bf16(q, k, v, kv_pos, q_pos, *, window: int = 0,
                          return_lse: bool = False):
    """`decode_attention` that takes bf16 only."""
    return _run(q, k, v, kv_pos, q_pos, window, return_lse, torch.bfloat16)


def _run(q, k, v, kv_pos, q_pos, window, return_lse, dtype):
    """The kernel's ``dtype`` instantiation on q, k, v of that dtype; a
    dtype with no instantiation raises."""
    if dtype not in _ENTRY:
        raise TypeError(f"decode_attention on the card takes f32 or bf16, "
                        f"got {dtype}")
    dev = q.device
    if q.dim() != 3 or k.dim() != 4:
        raise _bad(q, k, v, kv_pos, q_pos, dtype)
    B, H, hd = q.shape
    C, KV = k.shape[1], k.shape[2]
    if (dev.type != "cuda" or k.device != dev or v.device != dev
            or kv_pos.device != dev or q_pos.device != dev
            or q.dtype != dtype or k.dtype != dtype or v.dtype != dtype
            or kv_pos.dtype != _I32 or q_pos.dtype != _I32
            or k.shape != (B, C, KV, hd) or v.shape != k.shape
            or kv_pos.shape != (B, C) or q_pos.shape != (B,)
            or not (q.is_contiguous() and k.is_contiguous()
                    and v.is_contiguous() and kv_pos.is_contiguous()
                    and q_pos.is_contiguous())
            or KV < 1 or H % KV or H // KV > MAX_G or not 1 <= hd <= MAX_HD):
        raise _bad(q, k, v, kv_pos, q_pos, dtype)
    di = dev.index
    sms = _sms.get(di)
    fn = _launch.get(dtype)
    if sms is None or fn is None:
        sms = _setup(di, dtype)
        fn = _launch[dtype]
    stream = torch._C._cuda_getCurrentRawStream(di)
    counters = build.arrival_counters("decode_attention", dev, stream,
                                      B * KV)
    key = (B, C, KV, sms)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = split_plan(*key)
    nsplit, R = plan
    # one f32 buffer: the output (in 32-bit words: a bf16 output takes
    # half of them), the log-sum-exp, the partials' workspace
    n_out = B * H * hd
    out_f32 = dtype == _F32 or return_lse
    w_out = n_out if out_f32 else (n_out + 1) // 2
    n_lse = B * H if return_lse else 0
    ws = B * H * nsplit * (hd + 2) if nsplit > 1 else 0
    buf = torch.empty(w_out + n_lse + ws, dtype=_F32, device=dev)
    base = buf.data_ptr()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
            q_pos.data_ptr(), base, base + 4 * w_out if return_lse else None,
            base + 4 * (w_out + n_lse), counters.data_ptr(), B, C, H, KV, hd,
            int(window), 1.0 / math.sqrt(hd), nsplit, R, stream)
    name = _ENTRY[dtype][1]
    if rc:
        build.check(rc, name)
    build.LAUNCHES[name] += 1
    out = (buf if out_f32 else buf.view(dtype)).as_strided(
        (B, H, hd), (H * hd, hd, 1))
    if return_lse:
        return out, buf.as_strided((B, H), (H, 1), w_out)
    return out
