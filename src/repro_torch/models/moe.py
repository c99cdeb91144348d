"""Mixture-of-Experts FFN with semaphore-based capacity admission — the
port of ``repro.models.moe``.

Fine-grained MoE (DeepSeekMoE style): optional shared experts (always on)
plus E routed experts with top-k routing.  Expert capacity is the paper's
batched ticket semaphore (`core.functional.take_batch_multi`): every
(token, routed expert) assignment takes from its expert's semaphore,
whose grant is preloaded to the capacity; the ticket is the token's slot
in the expert buffer, so token order (FCFS) decides which assignments
overflow.  Overflowing assignments are dropped (the residual path) and
counted in ``overflow_frac``.

The tokens split into G dispatch groups, the reference's G = pod × data
(reduced until it divides the token count) under an active mesh and 1 on
one device, each with its own semaphores and buffers (G, E_pad, cap, D):
per-group FCFS capacity, the gshard semantics.  Under a mesh (DTensor
activations) a group whose tokens are one batch shard's is admitted,
dispatched and combined where its tokens lie, on plain local tensors;
only the buffers cross to DTensor, sharded (G→batch, E→experts) as the
reference's constraint points say, so the expert products run on each
rank's experts and the combine gathers the outputs over ``model``.
Groups that do not match the batch shards are worked on whole on every
rank.  Dropped writes go to one sink row past the E_pad·cap
buffer rows that is cut off, in place of the reference's out-of-range
``mode="drop"`` index; the combine gathers each token's k assignments
and sums them in rank order, so a decode step gives the same result
every time.  No step reads the device from the host: the capacity comes
from shapes.  The expert products are plain matrix products, as in the
reference (no Pallas kernel there).
"""

from __future__ import annotations

import torch

from ..core.functional import make_multi_sema, take_batch_multi
from ..parallel.sharding import constrain, is_dtensor, mesh_axes
from .layers import _normal, silu


def init_moe(generator, d_model, n_experts, d_expert, top_k, n_shared,
             d_shared, dtype, n_experts_pad: int = 0, device=None):
    std = d_model ** -0.5
    ep = max(n_experts, n_experts_pad)  # EP padding (configs.base)

    def n(shape, s, dt=dtype):
        return _normal(generator, shape, s, dt, device)

    p = {
        "router": n((d_model, n_experts), std, torch.float32),
        "wi": n((ep, d_model, d_expert), std),
        "wg": n((ep, d_model, d_expert), std),
        "wo": n((ep, d_expert, d_model), d_expert ** -0.5),
    }
    if n_shared > 0:
        p["shared"] = {
            "wi": n((d_model, d_shared), std),
            "wg": n((d_model, d_shared), std),
            "wo": n((d_shared, d_model), d_shared ** -0.5),
        }
    return p


def capacity_of(n_tokens: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    """Buffer slots per expert for one group of ``n_tokens`` tokens (the
    reference's formula, Python's ``round`` included)."""
    return int(max(top_k, round(n_tokens * top_k / n_experts
                                * capacity_factor)))


def route(p, xt, top_k: int):
    """Router logits (N, E) f32, probabilities, and the top-k gates
    (renormalised) with their expert ids (N, k), largest first."""
    logits = torch.einsum("nd,de->ne", xt.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return logits, probs, gate_vals, gate_idx


def admit(flat_e, n_experts: int, capacity: int):
    """FCFS admission of the (G, M) assignments ``flat_e`` (row order =
    token order) through one multi-semaphore per group, each grant
    preloaded to ``capacity``.  Returns (tickets (G, M) u32 carriers,
    admitted (G, M) bool)."""
    dev = flat_e.device
    tickets, admitted = [], []
    for e_g in flat_e:
        sema = make_multi_sema(torch.full((n_experts,), capacity,
                                          dtype=torch.int64, device=dev),
                               device=dev)
        _, t, a = take_batch_multi(sema, e_g,
                                   torch.ones_like(e_g, dtype=torch.bool))
        tickets.append(t)
        admitted.append(a)
    return torch.stack(tickets), torch.stack(admitted)


def dispatch(xt, flat_e, tickets, admitted, n_experts_pad: int,
             capacity: int, top_k: int):
    """Each admitted (token, expert) assignment's token row to its
    expert's buffer slot (the ticket); the rest to one sink row, cut off.
    Returns (buf (G, E_pad, cap, D), dest (G, M): each assignment's flat
    buffer row, E_pad·cap — the sink — where dropped)."""
    G = flat_e.shape[0]
    Ng, D = xt.shape[0] // G, xt.shape[1]
    sink = n_experts_pad * capacity
    dest = torch.where(admitted, flat_e * capacity + tickets.to(torch.int64),
                       sink)
    tok_idx = torch.arange(Ng * top_k, device=xt.device) // top_k
    xg = xt.reshape(G, Ng, D)
    buf = xt.new_zeros((G, sink + 1, D))
    for g in range(G):
        buf[g].index_copy_(0, dest[g], xg[g][tok_idx])
    return buf[:, :sink].reshape(G, n_experts_pad, capacity, D), dest


def experts(p, buf):
    """The routed experts' SwiGLU over their buffers (G, E_pad, cap, D)."""
    h = (silu(torch.einsum("gecd,edf->gecf", buf, p["wg"]))
         * torch.einsum("gecd,edf->gecf", buf, p["wi"]))
    h = constrain(h, "batch", "experts")
    return constrain(torch.einsum("gecf,efd->gecd", h, p["wo"]),
                     "batch", "experts")


def _routed_sharded(p, xt, gate_vals, gate_idx, G: int, E: int,
                    capacity: int, top_k: int):
    """The routed experts for DTensor tokens ``xt`` (N, D): admission,
    dispatch and combine on plain tensors — each rank's own group when
    the G groups are the batch shards (``xt`` sharded over its rows G
    ways, replicated otherwise), else all G groups on every rank — and
    the expert products on the DTensor buffers.  Returns (out (N, D),
    admitted (G, M)) as DTensors."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = xt.device_mesh
    pl = list(xt.placements)
    n_shards = 1
    for m, q in enumerate(pl):
        if q.is_shard(0):
            n_shards *= mesh.size(m)
    local = (n_shards == G and all(q.is_shard(0) or q.is_replicate()
                                   for q in pl))
    if local:
        grp_pl, Gl = pl, 1
        xl, gv, gi = xt.to_local(), gate_vals.to_local(), gate_idx.to_local()
    else:
        grp_pl, Gl = [Replicate()] * mesh.ndim, G
        xl, gv, gi = (xt.full_tensor(), gate_vals.full_tensor(),
                      gate_idx.full_tensor())
    flat_e = gi.reshape(Gl, -1)
    tickets, admitted = admit(flat_e, E, capacity)
    buf, dest = dispatch(xl, flat_e, tickets, admitted, p["wi"].shape[0],
                         capacity, top_k)
    buf = constrain(DTensor.from_local(buf, mesh, grp_pl, run_check=False),
                    "batch", "experts")
    out_buf = experts(p, buf).redistribute(mesh, grp_pl).to_local()
    out = combine(out_buf, dest, gv, admitted, top_k)
    return (DTensor.from_local(out, mesh, grp_pl, run_check=False),
            DTensor.from_local(admitted, mesh, grp_pl, run_check=False))


def combine(out_buf, dest, gate_vals, admitted, top_k: int):
    """Each assignment's expert output gathered by its buffer row (the
    sink row is zeros), weighted by its gate (0 where dropped), and each
    token's k assignments summed in rank order.  Returns (N, D)."""
    G, D = out_buf.shape[0], out_buf.shape[-1]
    out_flat = torch.cat([out_buf.reshape(G, -1, D),
                          out_buf.new_zeros((G, 1, D))], dim=1)
    gv = gate_vals.reshape(G, -1, 1) * admitted[..., None]
    per_assign = (torch.gather(out_flat, 1,
                               dest[..., None].expand(-1, -1, D))
                  * gv.to(out_buf.dtype))
    return per_assign.reshape(G, -1, top_k, D).sum(2).reshape(-1, D)


def shared_experts(p, xt):
    sh = p["shared"]
    hs = (silu(torch.einsum("nd,df->nf", xt, sh["wg"]))
          * torch.einsum("nd,df->nf", xt, sh["wi"]))
    return torch.einsum("nf,fd->nd", hs, sh["wo"])


def _expert_fraction(gate_idx, E: int, probs):
    """Each expert's share of the tokens that picked it (any rank): the
    one-hot counts of ``gate_idx`` (N, k) over N.  For a DTensor the
    counts are taken on each rank's rows and summed over the mesh
    dimensions that shard them."""
    if not is_dtensor(gate_idx):
        return torch.zeros_like(probs).scatter_(1, gate_idx, 1.0).mean(0)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    loc = gate_idx.to_local()
    cnt = torch.zeros((loc.shape[0], E), dtype=torch.float32,
                      device=loc.device).scatter_(1, loc, 1.0).sum(0)
    pl = [Partial() if p.is_shard(0) else Replicate()
          for p in gate_idx.placements]
    return DTensor.from_local(cnt, gate_idx.device_mesh, pl,
                              run_check=False) / gate_idx.shape[0]


def aux_losses(logits, probs, gate_idx, admitted, top_k: int,
               router_z_weight: float) -> dict:
    """Switch-style load balance (E · Σ_e f_e · P_e / k), the router
    z-loss and the semaphore's overflow share, as 0-dim f32 tensors."""
    E = probs.shape[-1]
    me = _expert_fraction(gate_idx, E, probs)
    ce = probs.mean(0)
    return {
        "lb_loss": E * torch.sum(me * ce) / top_k,
        "z_loss": router_z_weight * torch.mean(
            torch.logsumexp(logits, dim=-1) ** 2),
        "overflow_frac": 1.0 - admitted.float().mean(),
    }


def moe_forward(p, x, *, top_k: int, capacity_factor: float = 1.25,
                router_z_weight: float = 1e-3):
    """x: (B, S, D) → (out (B, S, D), aux ``{"lb_loss", "z_loss",
    "overflow_frac"}`` as 0-dim f32 tensors)."""
    B, S, D = x.shape
    E = p["router"].shape[-1]
    N = B * S
    xt = x.reshape(N, D)
    logits, probs, gate_vals, gate_idx = route(p, xt, top_k)

    axes = mesh_axes()
    G = axes.get("pod", 1) * axes.get("data", 1)
    while N % G:
        G -= 1
    capacity = capacity_of(N // G, top_k, E, capacity_factor)
    if is_dtensor(xt):
        out, admitted = _routed_sharded(p, xt, gate_vals, gate_idx, G, E,
                                        capacity, top_k)
    else:
        # semaphore admission: one take per (token, expert) assignment,
        # row order == token order; the ticket is the buffer slot
        flat_e = gate_idx.reshape(G, -1)
        tickets, admitted = admit(flat_e, E, capacity)
        buf, dest = dispatch(xt, flat_e, tickets, admitted, p["wi"].shape[0],
                             capacity, top_k)
        buf = constrain(buf, "batch", "experts")
        out = combine(experts(p, buf), dest, gate_vals, admitted, top_k)
    if "shared" in p:
        out = out + shared_experts(p, xt)
    aux = aux_losses(logits, probs, gate_idx, admitted, top_k,
                     router_z_weight)
    return out.reshape(B, S, D), aux
