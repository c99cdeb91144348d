"""Collective traffic, per-device FLOPs and the roofline of one step — the
port of ``repro.launch.hlo_analysis``.

Torch has no HLO.  What stands in for XLA's compiled program here is the
step itself, run once eagerly on the port's fake production mesh
(`launch.dryrun`: a ``fake`` process group, fake tensors that allocate
nothing) under `DeviceCounter`, a dispatch mode that sees every op one
rank runs:

  collectives  every collective the step dispatches: the functional
               ones DTensor's redistributions issue
               (``_c10d_functional.all_gather_into_tensor``,
               ``reduce_scatter_tensor``, ``all_reduce``,
               ``all_to_all_single``) and the plain ``c10d`` ones the
               port calls itself (`optim.compression.compress_psum`'s
               all-reduces, `parallel.shard_attention`'s all-gather of
               decode partials); any other op of a collective
               namespace raises, so none goes uncounted.  Each is
               recorded with its kind, its bytes, its group's size and
               the mesh dimension(s) its group spans — the group
               matched against ``mesh.get_group(dim)``, or, for a group
               over several dimensions, the reference's composite
               labels (``model+``, ``data+pod``, ``all``).  Wire bytes a
               device follow the reference's ring model
               (`ring_wire_bytes`):

                   all-gather          out · (n−1)/n
                   reduce-scatter      out · (n−1)    (out: the shard)
                   all-reduce          2 · bytes · (n−1)/n
                   all-to-all          bytes · (n−1)/n
                   collective-permute  bytes

  FLOPs        the operations of the ops on each rank's LOCAL tensors,
               through ``torch.utils.flop_counter.flop_registry``: not
               the DTensor-level op (whose shapes are global), nor the
               sharding propagator's shape inference on global shapes
               (``FlopCounterMode`` alone counts one of them, so it
               gives the whole mesh's product, not a device's).
  bytes        the bytes each local op reads and writes (views
               excluded): what eager torch moves, one kernel an op, with
               no fusion — the counterpart of XLA's ``bytes accessed``,
               an upper bound beside `analytic_hbm_bytes`.

Unlike XLA's cost analysis, which counts a while loop's body once, eager
torch runs every iteration, so every iteration is counted.

The roofline prices the terms on an NVIDIA H100 SXM5 80GB at 700 W
(datasheet values) with one bandwidth for each mesh axis: ``model`` is
the 8 GPUs of one node on NVLink 4, ``data`` crosses the nodes of a
cluster on NDR InfiniBand, ``pod`` crosses clusters (`launch.mesh`).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch

# ------------------------------------------------------------ collectives ---

RING_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
              "collective-permute")


def ring_wire_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Bytes one device sends over the ring for a collective of ``kind``
    over a group of ``n`` whose result (``out_bytes``) is what the
    reference's HLO shape gives: the gathered tensor, the scattered
    shard, the reduced tensor, the exchanged one."""
    frac = (n - 1) / n
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "all-reduce":
        return 2 * out_bytes * frac
    if kind == "all-to-all":
        return out_bytes * frac
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclass
class CollectiveStats:
    ops: int = 0
    wire_bytes_per_chip: float = 0.0
    by_kind: dict = field(default_factory=lambda: defaultdict(float))
    by_axis: dict = field(default_factory=lambda: defaultdict(float))
    details: list = field(default_factory=list)
    # wire bytes by "kind@axis" (the port's addition)
    by_kind_axis: dict = field(default_factory=lambda: defaultdict(float))

    def add(self, kind: str, out_bytes: float, n: int, axis: str,
            keep_details: int = 40) -> None:
        if n <= 1:
            return  # degenerate, as the reference skips it
        wire = ring_wire_bytes(kind, out_bytes, n)
        self.ops += 1
        self.wire_bytes_per_chip += wire
        self.by_kind[kind] += wire
        self.by_axis[axis] += wire
        self.by_kind_axis[f"{kind}@{axis}"] += wire
        if len(self.details) < keep_details:
            self.details.append({"kind": kind, "bytes": out_bytes,
                                 "group_n": n, "axis": axis, "wire": wire})

    def as_dict(self) -> dict:
        return {"ops": self.ops,
                "wire_bytes_per_chip": self.wire_bytes_per_chip,
                "by_kind": dict(self.by_kind), "by_axis": dict(self.by_axis),
                "by_kind_axis": dict(self.by_kind_axis),
                "top": sorted(self.details, key=lambda d: -d["wire"])[:12]}


# the collectives the port issues: DTensor's functional ones and the
# plain ``c10d`` ones it calls itself (`optim.compression.compress_psum`,
# `parallel.shard_attention`'s all-gather of decode partials)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d._allgather_base_": "all-gather",
    "c10d.allreduce_": "all-reduce",
}
# namespaces of collectives: an op there that is neither a known
# collective nor a wait raises (`DeviceCounter`), so none goes uncounted
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional",
                          "_c10d_functional_autograd")


def _tensor_bytes(x) -> float:
    from torch.utils._pytree import tree_leaves

    return float(sum(t.numel() * t.element_size() for t in tree_leaves(x)
                     if isinstance(t, torch.Tensor)))


def _group_of(args):
    """The process group a collective's arguments name: a boxed
    ``ProcessGroup`` (the ``c10d`` ops) or a group name (the functional
    ones)."""
    from torch._C._distributed_c10d import (ProcessGroup,
                                             _resolve_process_group)

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a)
            except RuntimeError:
                continue
    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a)
    raise ValueError("no process group among the collective's arguments")


_COMPOSITE = {frozenset({"data", "model"}): "model+",
              frozenset({"pod", "data"}): "data+pod",
              frozenset({"pod", "data", "model"}): "all"}


def mesh_index(mesh) -> dict:
    """What `axis_label` reads of ``mesh``, taken once outside any
    dispatch mode: its dimension names, each dimension's group name and
    every rank's coordinate."""
    if mesh is None:
        return {"names": [], "groups": [], "coords": {}}
    import numpy as np
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    names = list(mesh.mesh_dim_names or ())
    with unset_fake_temporarily():
        grid = np.asarray(mesh.mesh.tolist())
    coords = {int(r): idx for idx, r in np.ndenumerate(grid)}
    return {"names": names,
            "groups": [mesh.get_group(d).group_name
                       for d in range(len(names))],
            "coords": coords}


def axis_label(group, index: dict) -> str:
    """The mesh dimension ``group`` runs over (``index`` from
    `mesh_index`): its name where ``group`` is ``mesh.get_group(dim)``;
    for a group over several dimensions the reference's composite label
    (``model+`` for data and model, ``data+pod``, ``all``; ``mixed``
    otherwise); ``self`` for one rank; ``other`` for a group outside the
    mesh."""
    import torch.distributed as dist

    if group.size() <= 1:
        return "self"
    names = index["names"]
    for name, gname in zip(names, index["groups"]):
        if gname == group.group_name:
            return name
    coords = [index["coords"].get(r)
              for r in dist.get_process_group_ranks(group)]
    if not names or None in coords:
        return "other"
    spanned = frozenset(names[d] for d in range(len(names))
                        if len({c[d] for c in coords}) > 1)
    if len(spanned) == 1:
        return next(iter(spanned))
    return _COMPOSITE.get(spanned, "mixed")


# --------------------------------------------------------------- counting ---


def _metadata_entries() -> list:
    """(owner, attribute) of each function of DTensor that works on
    placements and shapes only, by the names this torch has: the entries
    into its sharding propagation (the cached one is bound on the
    propagator at its creation; the shape inference on global shapes)
    and a ``_StridedShard``'s shard size and offsets (which torch reads
    from an ``arange`` by ``tolist``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor import placement_types

    prop = DTensor._op_dispatcher.sharding_propagator
    out = [(prop, "propagate_op_sharding")] if (
        "propagate_op_sharding" in vars(prop)) else []
    out += [(ShardingPropagator, name) for name in (
        "propagate_op_sharding_non_cached",
        "_propagate_tensor_meta_non_cached") if hasattr(ShardingPropagator,
                                                        name)]
    if not out:
        raise RuntimeError("no sharding propagation entry the counter knows")
    strided = getattr(placement_types, "_StridedShard", None)
    if hasattr(strided, "local_shard_size_and_offset"):
        out.append((strided, "local_shard_size_and_offset"))
    return out


class DeviceCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts what one rank does under it: ``flops`` (the local ops'
    operations, by ``flop_registry``), ``flops_by_op``, ``bytes`` (the
    bytes each local op reads and writes, views excluded) and
    ``collectives`` (a `CollectiveStats`, each op labelled by the
    dimension of ``mesh`` it runs over, `axis_label`).

    It hands every op on a DTensor on (``NotImplemented``), so DTensor
    dispatches it and the local ops come back here.  While DTensor works
    on placements and shapes only (`_metadata_entries`: its sharding
    propagation, whose shape inference runs ops on global-shaped fake
    tensors of its own) nothing is counted, and an active fake-tensor
    mode is set aside: that arithmetic needs real tensors.  Works on
    real or fake tensors."""

    def __init__(self, mesh=None, keep_details: int = 40):
        super().__init__()
        self.index = mesh_index(mesh)
        self.keep_details = keep_details
        self.flops = 0.0
        self.flops_by_op: dict = defaultdict(float)
        self.bytes = 0.0
        self.collectives = CollectiveStats()
        self._metadata = 0
        self._kinds = {}
        for name, kind in _COLLECTIVE_OPS.items():
            ns, op = name.split(".")
            self._kinds[getattr(getattr(torch.ops, ns), op)] = kind
        # ops that alias or wait, moving no bytes
        self._no_traffic = {torch.ops.aten._unsafe_view,
                            torch.ops._c10d_functional.wait_tensor}
        # in-place writes of indexed rows: they read and write the rows
        # (the source, the index), not the whole destination
        aten = torch.ops.aten
        self._indexed_writes = {aten.index_copy_, aten.index_put_,
                                aten._index_put_impl_, aten.scatter_,
                                aten.index_add_}
        self._restore = []

    def __enter__(self):
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        for owner, name in _metadata_entries():
            orig = getattr(owner, name)

            def wrapped(*a, _orig=orig, **k):
                self._metadata += 1
                try:
                    with unset_fake_temporarily():
                        return _orig(*a, **k)
                finally:
                    self._metadata -= 1

            setattr(owner, name, wrapped)
            self._restore.append((owner, name, orig))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            while self._restore:
                owner, name, orig = self._restore.pop()
                setattr(owner, name, orig)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs))):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._metadata:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[str(packet)] += f
        kind = self._kinds.get(packet)
        if kind is not None:
            functional = "functional" in packet._qualified_op_name
            group = _group_of(args)
            nbytes = _tensor_bytes(out if functional else args[0])
            self.collectives.add(kind, nbytes, group.size(),
                                 axis_label(group, self.index),
                                 self.keep_details)
        elif (func.namespace in _COLLECTIVE_NAMESPACES
              and packet not in self._no_traffic):
            raise NotImplementedError(
                f"{packet._qualified_op_name}: a collective the counter "
                "does not know")
        elif packet in self._indexed_writes:  # the rows, not the tensor
            self.bytes += 2 * _tensor_bytes((args[1:], kwargs))
        elif not (func.is_view or packet in self._no_traffic
                  or func.namespace == "prim"):
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


# ---------------------------------------------------------------- roofline --

# NVIDIA H100 SXM5 80GB at its 700 W limit (datasheet; dense rates).
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BW = 3.35e12        # B/s, HBM3
NVLINK_BW = 450e9       # B/s a GPU, a direction (NVLink 4, 18 links)
IB_BW = 50e9            # B/s a GPU (one NDR 400 Gb/s rail)
POD_BW = 25e9           # B/s a GPU across clusters: ASSUMED (no datasheet;
                        # the NDR rail through a 2:1 oversubscribed spine)
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": POD_BW,
           # a group over several dimensions runs at its slowest link
           "model+": IB_BW, "data+pod": POD_BW, "all": POD_BW,
           "mixed": POD_BW, "other": POD_BW}


def analytic_hbm_bytes(cfg, shape, axes: dict, accum: int = 1) -> float:
    """Per-device HBM traffic model for one step — the reference's
    formula, term for term (P at 2 bytes a parameter: the step's
    parameters are bf16):

      weights   train: 2·(P/tp)·A; serve: P/tp
      optimizer train: 8·(P·4B)/(tp·dp)
      carries   train: 6·L·tokens_dev·d·2B; prefill: 2·L·tokens_dev·d·2B
      attention the KV stream, n_q_blocks × local KV bytes a layer
                (flash: scores stay on chip); decode 3× the local cache
                (attention read + ring write), prefill + one write
      moe       expert buffers 4·tokens·k·(d+d_e)·2B / ep_shards
    """
    tp = axes.get("model", 1)
    dp = axes.get("data", 1) * axes.get("pod", 1)
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    P = cfg.param_count() * 2  # bf16
    total = 0.0
    if shape.kind == "train":
        tokens_chip = B * S / dp
        total += 2 * (P / tp) * accum
        total += 8 * (P * 2) / (tp * dp)
        total += 6 * L * tokens_chip * d * 2
    elif shape.kind == "prefill":
        tokens_chip = B * S / dp
        total += P / tp
        total += 2 * L * tokens_chip * d * 2
    else:  # decode
        total += P / tp
        tokens_chip = B / dp

    n_attn = sum(1 for b in cfg.blocks if b.kind in ("attn", "moe"))
    kv_row_bytes = 2 * cfg.n_kv_heads * cfg.hd * 2  # k+v bf16 per token
    if n_attn:
        if shape.kind == "decode":
            for b in cfg.blocks:
                if b.kind not in ("attn", "moe"):
                    continue
                ctx = min(S, b.window) if b.window else S
                local = (B / dp) * (ctx / tp) * kv_row_bytes
                total += 3 * local
        else:
            nq = max(1, S // 512)
            mult = 3.0 if shape.kind == "train" else 1.0
            for b in cfg.blocks:
                if b.kind not in ("attn", "moe"):
                    continue
                ctx = min(S, b.window) if b.window else S
                total += mult * (B / dp) * nq * ctx * kv_row_bytes
            if shape.kind == "prefill":
                total += (B / dp) * S * kv_row_bytes * n_attn / tp
    if cfg.n_experts:
        n_moe = sum(1 for b in cfg.blocks if b.kind == "moe")
        ep = max(cfg.n_experts, cfg.n_experts_pad)
        eshard = tp if ep % tp == 0 else 1
        tokens_chip_all = (B * (S if shape.kind != "decode" else 1)) / dp
        total += (4 * tokens_chip_all * cfg.top_k * (d + cfg.d_expert) * 2
                  * n_moe / eshard)
    return total


def roofline_terms(flops_per_chip: float, hbm_bytes_per_chip: float,
                   by_axis: dict, dtype: str = "bf16") -> dict:
    """The three times of one step on one H100: ``T_comp`` (FLOPs at the
    ``dtype`` peak), ``T_mem`` (bytes at HBM3's rate), ``T_coll`` (each
    axis's wire bytes at its own link, `AXIS_BW`, summed: no overlap
    between axes assumed), with ``T_coll_by_axis``; the bottleneck and
    the roofline fraction (compute over the largest term)."""
    t_axis = {a: b / AXIS_BW.get(a, POD_BW) for a, b in by_axis.items()
              if a != "self"}
    t_comp = flops_per_chip / PEAK_FLOPS[dtype]
    t_mem = hbm_bytes_per_chip / HBM_BW
    t_coll = sum(t_axis.values())
    terms = {"T_comp": t_comp, "T_mem": t_mem, "T_coll": t_coll,
             "T_coll_by_axis": t_axis, "dtype": dtype,
             "coll_bytes_by_axis": dict(by_axis)}
    terms["bottleneck"] = max(("T_comp", "T_mem", "T_coll"),
                              key=lambda k: terms[k])
    bound = max(t_comp, t_mem, t_coll)
    terms["roofline_fraction"] = (t_comp / bound) if bound > 0 else 0.0
    return terms
