"""Attention on each rank's shard under a mesh: what GSPMD derives for the
reference's attention when its activations and caches are sharded
(``repro.models.layers.single_query_attention``'s flash-decode contract,
``blockwise_attention`` on head shards), written out for the port's
kernels.

A DTensor cannot enter a ``ctypes`` kernel, so each function here takes
the rank's local tensors (``to_local()``), runs the kernel (its plain
version on the CPU, `kernels.ops`) and wraps the result back as a DTensor
with the placements it has.

  lse_merge(outs, lses)       the log-sum-exp merge of M partials of one
                              query over M disjoint key sets;
  sharded_decode_attention    the decode kernel with ``return_lse`` on
                              the rank's rows of the cache (or on each run
                              of a split cache), an all-gather of the
                              (B, H, hd + 1) partials over the
                              sequence-sharding mesh dimensions, the merge;
  mesh_decode_attention       the model's decode attention over a DTensor
                              cache (sequence-, batch- or head-sharded);
  mesh_prefill_attention      the flash kernel on the rank's (batch,
                              heads) shard of the queries, with the KV
                              heads those queries use;
  mesh_train_attention        the plain blockwise attention on the same
                              shard under autograd (training): the
                              gradients flow back to the sharded q, k
                              and v through the DTensor wrappers.

Gathering the partials and merging them on every rank gives every rank
the same arithmetic (and the same result), and lets one process emulate
M shards through the same `lse_merge`: a split cache
(`models.cache.split_cache`) holds a ring's sequence as M runs on one
device, each run contiguous as a rank's shard is, and the model's decode
over it merges the M runs' partials.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.ref import blockwise_attention
from .sharding import _shard_offset, local_rows


def lse_merge(outs, lses):
    """``Σ_r e^{lse_r − L} out_r`` with ``L = log Σ_r e^{lse_r}``:
    ``outs`` (M, ..., hd) normalised partial outputs, ``lses`` (M, ...)
    their log-sum-exps (−inf for a partial that saw no key).  Where no
    partial saw a key the result is 0, as the whole-cache kernel gives."""
    L = torch.logsumexp(lses, 0)
    L = torch.where(torch.isfinite(L), L, 0.0)
    w = torch.where(torch.isfinite(lses), torch.exp(lses - L), 0.0)
    return (w[..., None] * outs).sum(0)


def sharded_decode_attention(q, k, v, kv_pos, q_pos, *, window: int = 0,
                             groups=()):
    """Decode attention of q (B, H, hd) over a cache whose sequence rows
    are split into shards: ``k``/``v`` (B, n, KV, hd) and ``kv_pos``
    (B, n) are this rank's rows, or (M, B, n, KV, hd) and (M, B, n) M
    runs of rows that this process holds (a split cache,
    `models.cache.split_cache`); the ranks of ``groups`` (process groups,
    major first: shard index = Σ coordinate × the sizes after it) hold
    the others.  Each run goes through the decode kernel with its
    log-sum-exp, the partials are all-gathered and merged by
    `lse_merge`; one run and no ``groups`` is the kernel's output alone.
    Returns (B, H, hd)."""
    if k.dim() == 4 and not groups:
        return ops.decode_attention(q, k, v, kv_pos, q_pos, window=window)
    runs = zip(k, v, kv_pos) if k.dim() == 5 else [(k, v, kv_pos)]
    part = torch.stack([torch.cat([o, lse[..., None]], -1) for o, lse in (
        ops.decode_attention(q, kr, vr, pr, q_pos, window=window,
                             return_lse=True) for kr, vr, pr in runs)])
    if groups:
        import torch.distributed as dist

        for g in reversed(groups):  # minor first: the major lands outside
            got = part.new_empty((dist.get_world_size(g) * part.shape[0],)
                                 + part.shape[1:])
            dist.all_gather_into_tensor(got, part.contiguous(), group=g)
            part = got
    # the partials went to f32 beside their log-sum-exps
    return lse_merge(part[..., :-1], part[..., -1]).to(q.dtype)


def mesh_decode_attention(q, cache, positions, *, window: int = 0):
    """The model's decode attention under a mesh: q (B, 1, H, hd) a
    DTensor, ``cache`` a ring cache of DTensors (already appended),
    ``positions`` (B, 1).  The queries are laid out as the cache is —
    rows as its rows, heads as its KV heads, whole over the mesh
    dimensions that split its sequence (and over any other) — each rank
    attends over its rows of the cache, and the partials of the sequence
    shards merge (`sharded_decode_attention`).  Returns (B, 1, H, hd),
    placed as the queries were laid out."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    ck = cache["k"]
    mesh = ck.device_mesh
    q_pl = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2)
            else Replicate() for p in ck.placements]
    seq = [m for m, p in enumerate(ck.placements) if p.is_shard(1)]
    ql = q.redistribute(mesh, q_pl).to_local()[:, 0].contiguous()
    pos = local_rows(positions, ck)[:, 0].to(torch.int32).contiguous()
    out = sharded_decode_attention(
        ql, ck.to_local(), cache["v"].to_local(), cache["pos"].to_local(),
        pos, window=window, groups=[mesh.get_group(m) for m in seq])
    return DTensor.from_local(out[:, None], mesh, q_pl, run_check=False)


def _kv_heads_for(kl, h0: int, n_q: int, group: int):
    """The KV heads of ``kl`` (B, S, KV, hd; every head) that query heads
    ``h0 .. h0 + n_q − 1`` use under GQA groups of ``group``: a run of
    whole groups, the one head a run inside a group shares, else one KV
    head per query head."""
    if n_q % group == 0 and h0 % group == 0:
        return kl[:, :, h0 // group:(h0 + n_q) // group]
    if h0 // group == (h0 + n_q - 1) // group:
        return kl[:, :, h0 // group:h0 // group + 1]
    idx = torch.arange(h0, h0 + n_q, device=kl.device) // group
    return kl.index_select(2, idx)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: a
    local gradient wrapped back into a DTensor gets global strides
    derived from its own, and DTensor's backward of the projections
    before the attention views them as contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local_qkv(q, k, v):
    """The rank's (batch, heads) shard of q (B, S, H, hd) and the same
    rows of k/v (B, S, KV, hd) with the KV heads its query heads use
    (taken locally where k is split over heads as q is, else gathered
    over the heads), as local tensors that pass gradients back to the
    DTensors: a KV head gathered over a mesh dimension that splits the
    query heads gets a part of its gradient from each rank there
    (``Partial``).  Returns (q laid out as its shard, q, k, v local)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    q_pl = [p if (p.is_shard(0) or p.is_shard(2)) else Replicate()
            for p in q.placements]
    qd = q.redistribute(mesh, q_pl)
    local = _ContiguousGrad.apply
    ql = local(qd.to_local())
    if list(k.placements) == q_pl:
        return qd, ql, local(k.to_local()), local(v.to_local())
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in q_pl]
    grads = [Partial() if p.is_shard(2) else r for p, r in zip(q_pl, rows)]
    h0, group = _shard_offset(qd, 2), q.shape[2] // k.shape[2]
    kl, vl = (_kv_heads_for(local(t.redistribute(mesh, rows).to_local(
        grad_placements=grads)), h0, ql.shape[2], group) for t in (k, v))
    return qd, ql, kl, vl


def mesh_prefill_attention(q, k, v, *, window: int = 0):
    """The flash kernel on each rank's (batch, heads) shard
    (`_local_qkv`): q (B, S, H, hd), k/v (B, S, KV, hd) DTensors.
    Returns (B, S, H, hd) placed as the rank's queries."""
    from torch.distributed.tensor import DTensor

    qd, ql, kl, vl = _local_qkv(q, k, v)
    ctx = ops.flash_attention(ql.contiguous(), kl.contiguous(),
                              vl.contiguous(), window=window)
    return DTensor.from_local(ctx, qd.device_mesh, qd.placements,
                              run_check=False)


def mesh_train_attention(q, k, v, positions, *, window: int = 0,
                         kv_block: int = 1024):
    """Training attention on each rank's (batch, heads) shard: the plain
    `kernels.ref.blockwise_attention` (each KV block checkpointed) on
    the local tensors of `_local_qkv`, under autograd.  q (B, S, H, hd),
    k/v (B, S, KV, hd) DTensors, ``positions`` (B, S) the query and key
    positions (a DTensor or a tensor every rank holds whole).  No
    product runs on a DTensor, so DTensor's lowering of the attention's
    einsums (which flattens a sharded head dimension on some torch
    versions) is never asked for.  Returns (B, S, H, hd) placed as the
    rank's queries; its gradient reaches q, k and v as DTensors."""
    from torch.distributed.tensor import DTensor

    qd, ql, kl, vl = _local_qkv(q, k, v)
    pos = local_rows(positions, qd)
    ctx = blockwise_attention(ql, kl, vl, pos, pos, window=window,
                              kv_block=kv_block)
    # contiguous, as the kernels' outputs are: DTensor derives the global
    # strides from the local ones, and the heads' reshape that follows
    # must be a view of them
    return DTensor.from_local(ctx.contiguous(), qd.device_mesh,
                              qd.placements, run_check=False)
