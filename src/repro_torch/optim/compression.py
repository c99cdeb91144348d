"""Int8 error-feedback gradient compression for the scarce inter-pod
links — the port of ``repro.optim.compression`` over a process group.

The multi-pod gradient reduction is hierarchical: each pod reduces its
gradients in full precision on its own (data, model) ranks, and only the
exchange across pods is quantized:

    absmax    = all_reduce_max(blockmax(g_local + e), pod)   # tiny f32
    q         = round((g_local + e) / scale)                 # int8 range
    q_sum     = all_reduce_sum(q, pod)                       # integers
    g_global  = q_sum · scale / n_pods
    e'        = (g_local + e) − q · scale                    # stays local

The shared (max-reduced) scale makes the integer sum exact:
Σ qᵢ·s == (Σ qᵢ)·s.  Error feedback re-injects each step's quantization
error into the next, so compression noise does not accumulate into the
trajectory (EF-SGD).

The integer sum rides in int32: neither gloo nor NCCL sums int16.  For
≤ 256 shards the sum is the same integers as the reference's int16 one
(127 · 256 < 2¹⁵), so ``g_sum`` is bit-equal to it — but the wire is then
4 bytes a value, no saving over f32.  Sending the int8 payload (and
summing it on the receiving side) is later work.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

BLOCK = 256  # per-block scale granularity (flattened)


def _blocked(x):
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK), \
        flat.numel()


def _f32_recip(c: float) -> float:
    """1/c rounded to f32 (a Python float that an f32 tensor takes
    exactly)."""
    return float(torch.tensor(1.0 / c, dtype=torch.float32))


def compress_psum(g, residual, group, n_shards: int):
    """Error-feedback int8-range sum of one leaf over ``group`` (the
    ``n_shards`` ranks that hold this leaf's pod-local gradient, one a
    pod; every rank of the group calls it).  ``g`` and ``residual`` are
    plain tensors of one shape.  Returns (g_mean f32 — the mean over the
    shards, new_residual f32)."""
    x = g.float() + residual
    blocks, n = _blocked(x)
    absmax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    # the reference's ``absmax / 127.0`` and ``g_sum / n_shards`` as XLA
    # compiles them: a multiply by the f32 reciprocal of the constant
    scale = torch.clamp(absmax * _f32_recip(127.0), min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127)
    # x − q·scale with one rounding, as XLA fuses the reference's into an
    # FMA: the f64 product and difference are exact (q has 8 bits, scale
    # and x 24, and |x − q·scale| ≤ scale/2)
    local_dq = (q.double() * scale.double()).reshape(-1)[:n].reshape(g.shape)
    new_residual = (x.double() - local_dq).float()
    q_sum = q.to(torch.int32)  # exact: |Σ q| ≤ 127 · n_shards
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    g_sum = (q_sum.float() * scale).reshape(-1)[:n].reshape(g.shape)
    return g_sum * _f32_recip(n_shards), new_residual


def init_residuals(params, n_pods: int = 0):
    """Zero f32 residuals shaped like ``params``; with ``n_pods`` each
    leaf gains a leading pod axis, one residual a pod (each pod keeps
    its own error feedback)."""
    from .adamw import tree_map

    lead = (n_pods,) if n_pods else ()
    return tree_map(lambda p: torch.zeros(lead + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)
