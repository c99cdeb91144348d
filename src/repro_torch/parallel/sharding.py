"""Sharding rules — the port of ``repro.parallel.sharding`` on DTensor:
logical axis names → mesh axes, the parameter / optimizer / cache / batch
specs of every architecture, and the constraint points the model calls.

Logical activation axes: ("batch", "seq", "embed", "heads", "kv_heads",
"ffn", "experts", "vocab", "lru", "seq_kv").  Default mapping (single-pod
(data, model) mesh; multi-pod prepends "pod" onto the batch axis):

  batch   → ("pod","data")      ffn/heads/experts/vocab/lru → "model"
  embed   → None (replicated)   seq → None
  seq_kv  → "model"

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dimension (trailing ones may be left out), each ``None``, a mesh
axis name or a tuple of names (major to minor), so specs compare with
JAX's entry by entry.  `placements` turns one into DTensor placements on
a `DeviceMesh`: the tensor dimension an axis shards becomes ``Shard(d)``
on that mesh dimension; two axes on one dimension (``("pod", "data")``)
shard it in mesh order, the first major, as JAX does.

`use_mesh(mesh)` makes a mesh active (the counterpart of
``compat.set_mesh``); `mesh_axes()` reads its axis sizes.  Every spec
function also takes ``axes=`` explicitly, so that the production shapes
can be derived with no world of processes.  `constrain(x, *logical)`
redistributes a DTensor under an active mesh and is the identity
otherwise: on one device the model's constraint points cost nothing.

Parameter sharding is derived from leaf path names (wq/wk/wo/wi/...), with
optional FSDP: the first replicated dimension that the data size divides
(at least twice the data size, never a ``vocab`` leaf) is sharded over
"data" (parameters, gradients and optimizer state — ZeRO-3 style; the
optimizer state reuses the same spec).
"""

from __future__ import annotations

import contextlib
from typing import Any

# logical name → mesh axis (or tuple), for the canonical 2D/3D meshes
_DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_kv": "model",  # decode KV-sequence sharding (flash-decode analogue)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "vocab": "model",
    "lru": "model",
    "conv": None,
    "unit": None,  # stack axis — never sharded
}

_rules_stack: list[dict] = [dict(_DEFAULT_RULES)]
_mesh_stack: list = []


@contextlib.contextmanager
def axis_rules(**overrides):
    """Temporarily override logical-axis rules (step factories use this to
    retarget `batch`/`seq_kv` per mode/shape)."""
    top = dict(_rules_stack[-1])
    top.update(overrides)
    _rules_stack.append(top)
    try:
        yield
    finally:
        _rules_stack.pop()


def current_rules() -> dict:
    return _rules_stack[-1]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a `DeviceMesh` with named dimensions) the active
    mesh; ``None`` makes none active."""
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def current_mesh():
    return _mesh_stack[-1] if _mesh_stack else None


def mesh_axes(mesh=None) -> dict[str, int]:
    """``{axis name: size}`` of ``mesh`` (the active one by default), in
    mesh order; ``{}`` without one."""
    m = current_mesh() if mesh is None else mesh
    if m is None or not m.mesh_dim_names:
        return {}
    return dict(zip(m.mesh_dim_names, m.shape))


def _avail(axes):
    return mesh_axes() if axes is None else dict(axes)


def _resolve(name: str, avail: dict[str, int], dim_size: int | None = None):
    """Map one logical name to a mesh-axis entry, dropping axes that are
    missing from the mesh or that do not divide `dim_size`."""
    rule = current_rules().get(name)
    if rule is None:
        return None
    if isinstance(rule, str):
        rule = (rule,)
    picked = []
    prod = 1
    for a in rule:
        if a not in avail:
            continue
        if dim_size is not None and dim_size % (prod * avail[a]):
            continue
        picked.append(a)
        prod *= avail[a]
    if not picked:
        return None
    return tuple(picked) if len(picked) > 1 else picked[0]


def spec_for(*logical, dim_sizes=None, axes=None) -> tuple:
    """The spec for the mesh (unknown logical names replicate; mesh axes
    not present are dropped; axes that don't divide the dim are dropped
    when dim_sizes is given)."""
    avail = _avail(axes)
    out = []
    for i, name in enumerate(logical):
        ds = dim_sizes[i] if dim_sizes is not None else None
        out.append(_resolve(name, avail, ds) if name else None)
    return tuple(out)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that shards tensor dimension ``d``, ``Replicate()`` on
    the others.  Two axes on one tensor dimension shard it in mesh order
    (the first major), which is JAX's order for a tuple entry listed in
    mesh order — the only order the rules produce.  A mesh dimension of
    size 1 stays ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        ents = (entry,) if isinstance(entry, str) else tuple(entry)
        if [names.index(a) for a in ents] != sorted(names.index(a)
                                                   for a in ents):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{names}")
        for a in ents:
            # an axis of size 1 splits nothing; DTensor's view rules
            # refuse some shapes sharded over one
            if mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Shard(d)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x, *logical):
    """Redistribute DTensor ``x`` to the spec of ``logical`` on the active
    mesh (dimensions past ``logical`` replicated); the identity without an
    active mesh or for a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = spec_for(*logical, dim_sizes=x.shape[: len(logical)])
    return x.redistribute(mesh, placements(spec, mesh))


def zip_tree(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, lists and NamedTuples and
    a spec tree of the same structure (a spec — a tuple — is a leaf)."""
    if isinstance(tree, dict):
        return {k: zip_tree(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[zip_tree(fn, v, s) for v, s in zip(tree, specs)])
    if isinstance(tree, list):
        return [zip_tree(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def constrain_tree(tree, spec_tree):
    """The DTensor leaves of ``tree`` redistributed to their explicit
    specs on the active mesh; the identity without one."""
    mesh = current_mesh()
    if mesh is None:
        return tree
    return zip_tree(lambda x, s: x.redistribute(mesh, placements(s, mesh))
                    if is_dtensor(x) else x, tree, spec_tree)


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nest of dicts, lists and NamedTuples;
    the path holds dict keys, field names and indices."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# ------------------------------------------------------------------------
# parameter specs (path-name based)
# ------------------------------------------------------------------------

# leaf name → logical axes per dimension (excluding any leading stacked-unit
# axis, which is added automatically for leaves under "units").
_PARAM_AXES: dict[str, tuple[str | None, ...]] = {
    # embeddings / head
    "embed": ("vocab", "embed"),
    "head": ("embed", "vocab"),
    "final_ln": (None,),
    # attention
    "wq": ("embed", "heads", None),
    "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None),
    "wo_attn": ("heads", None, "embed"),
    "bq": ("heads", None),
    "bk": ("kv_heads", None),
    "bv": ("kv_heads", None),
    # dense mlp
    "wi": ("embed", "ffn"),
    "wg": ("embed", "ffn"),
    "wo_mlp": ("ffn", "embed"),
    # moe (leading experts dim)
    "router": ("embed", None),
    "wi_moe": ("experts", "embed", None),
    "wg_moe": ("experts", "embed", None),
    "wo_moe": ("experts", None, "embed"),
    # rg-lru temporal block
    "w_y": ("embed", "lru"),
    "w_x": ("embed", "lru"),
    "conv": (None, "lru"),
    "w_a": (None, "lru"),
    "w_i": (None, "lru"),
    "b_a": ("lru",),
    "b_i": ("lru",),
    "lam": ("lru",),
    "w_out": ("lru", "embed"),
    # xlstm (d_in plays the "lru" role)
    "w_up": ("embed", "lru"),
    "w_gate": ("embed", "lru"),
    "w_down": ("lru", "embed"),
    "wq_rnn": ("lru", None, None),
    "wk_rnn": ("lru", None, None),
    "wv_rnn": ("lru", None, None),
    "w_if": ("lru", None, None),
    "ln": (None,),
}


def _leaf_logical(path) -> tuple[str, ...] | None:
    """The logical axes of a parameter leaf from its path."""
    names = [str(k) for k in path]
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if leaf == "wo":
        if parent == "attn":
            key = "wo_attn"
        elif parent == "moe":
            key = "wo_moe"
        else:
            key = "wo_mlp"  # mlp / shared
    elif leaf in ("wi", "wg") and parent == "moe":
        key = leaf + "_moe"
    elif leaf in ("wq", "wk", "wv") and parent != "attn":
        key = leaf + "_rnn"  # mLSTM q/k/v live on the up-projected width
    elif leaf.startswith("ln") or leaf.endswith("ln"):
        key = "final_ln"
    else:
        key = leaf
    return _PARAM_AXES.get(key)


def param_pspecs(params, *, fsdp: bool = False, fsdp_axis: str = "data",
                 axes=None):
    """Specs for a parameter tree.  Leaves under 'units' get a leading
    replicated (stack) dim.  With fsdp=True, the first replicated dim
    the fsdp axis divides (and at least twice its size) is sharded over
    it."""
    avail = _avail(axes)

    def one(path, leaf):
        logical = _leaf_logical(path)
        stacked = "units" in path
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        if logical is None:
            logical = (None,) * len(shape)
        entries = [
            _resolve(ax, avail, shape[i]) if ax else None
            for i, ax in enumerate(logical[: len(shape)])
        ]
        entries += [None] * (len(shape) - len(entries))
        # Never FSDP the embedding/head: with tied embeddings the head is
        # the transpose, so a data-sharded d_model axis would make the CE
        # contract over `data` and all-reduce full-batch logits.  Vocab
        # sharding already divides these tables over `model`.
        if fsdp and fsdp_axis in avail and "vocab" not in logical:
            n = avail[fsdp_axis]
            for i, e in enumerate(entries):
                if e is None and shape[i] % n == 0 and shape[i] >= 2 * n:
                    entries[i] = fsdp_axis
                    break
        if stacked:
            entries = [None] + entries
        return tuple(entries)

    return map_with_path(one, params)


def opt_pspecs(param_specs, opt_state_proto=None):
    """Optimizer-state specs: step replicated; mu/nu/master shaped like
    params (ZeRO — they inherit the param specs, including the fsdp
    axis)."""
    from ..optim.adamw import OptState

    return OptState(step=(), mu=param_specs, nu=param_specs,
                    master=param_specs)


# ------------------------------------------------------------------------
# cache / state specs
# ------------------------------------------------------------------------


def cache_pspecs(caches: Any, axes=None):
    """Specs for decode caches/states by leaf name:
    k/v (B,C,KV,hd) → (batch, seq_kv, kv_heads?, None); pos (B,C);
    ptr (); recurrent h (B,W) → (batch, lru); conv tails (B,k,W);
    mlstm C/n/m per shape.  Leaves under 'units' carry a leading stack
    dim."""
    avail = _avail(axes)

    def one(path, leaf):
        stacked = "units" in path
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        leafname = path[-1]
        if leafname in ("k", "v"):
            entries = [
                _resolve("batch", avail, shape[0]),
                _resolve("seq_kv", avail, shape[1]),
                _resolve("kv_heads", avail, shape[2]),
                None,
            ]
            # seq_kv and kv_heads share 'model'; prefer seq_kv
            if entries[1] is not None:
                entries[2] = None
        elif leafname == "pos":
            entries = [_resolve("batch", avail, shape[0]),
                       _resolve("seq_kv", avail, shape[1])]
        elif leafname == "ptr":
            entries = []  # scalar cursor — replicated
        elif leafname == "conv":
            entries = [_resolve("batch", avail, shape[0]), None,
                       _resolve("lru", avail, shape[2])]
        elif leafname == "h" and len(shape) == 2:
            entries = [_resolve("batch", avail, shape[0]),
                       _resolve("lru", avail, shape[1])]
        else:
            # mlstm C/n/m, slstm c/n/h/m: batch-sharded, rest replicated
            entries = ([_resolve("batch", avail, shape[0])]
                       + [None] * (len(shape) - 1))
        if stacked:
            entries = [None] + entries
        return tuple(entries)

    return map_with_path(one, caches)


def batch_pspecs(batch: Any, axes=None):
    """Input-batch specs: the leading dim is batch, the rest
    replicated."""
    avail = _avail(axes)

    def one(path, leaf):
        return ((_resolve("batch", avail, leaf.shape[0]),)
                + (None,) * (len(leaf.shape) - 1))

    return map_with_path(one, batch)


def distribute(x, mesh, spec):
    """A full tensor laid out as ``spec`` on ``mesh``: each rank keeps its
    own slice of ``x`` (which every rank holds whole), with no
    communication."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, placements(spec, mesh),
                             src_data_rank=None)


def distribute_tree(tree, mesh, spec_tree):
    """`distribute` leaf by leaf."""
    return zip_tree(lambda x, s: distribute(x, mesh, s), tree, spec_tree)


# ------------------------------------------------------------------------
# sharded lookups
# ------------------------------------------------------------------------


def _shard_offset(x, dim: int) -> int:
    """Where this rank's slice of DTensor ``x`` starts along ``dim`` (an
    even split; the mesh dimensions that shard ``dim`` in mesh order, the
    first major)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    n, idx = 1, 0
    for m, p in enumerate(x.placements):
        if p.is_shard(dim):
            idx = idx * mesh.size(m) + coord[m]
            n *= mesh.size(m)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split evenly {n} ways")
    return idx * (x.shape[dim] // n)


def local_rows(x, like):
    """The rows of ``x`` (batch-major: a DTensor, or a plain tensor every
    rank holds whole) that DTensor ``like``'s local rows cover."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        pl = [p if p.is_shard(0) else Replicate() for p in like.placements]
        return x.redistribute(like.device_mesh, pl).to_local()
    lo = _shard_offset(like, 0)
    return x[lo:lo + like.to_local().shape[0]]


def embed_lookup(table, tokens):
    """``table[tokens]``.  For a DTensor table sharded over its rows (the
    ``vocab`` rule), each rank looks up the tokens its rows hold, zeros
    elsewhere, and the sum over the vocab-sharding mesh dimensions (an
    all-reduce, left ``Partial`` for the next op to settle) completes the
    lookup — what GSPMD does.  DTensor's own sharded-row lookup fails
    inside its masked partial's reduction when a reduction follows it.
    ``tokens`` may be a DTensor sharded over its batch rows or a plain
    tensor (every rank's the same)."""
    if not is_dtensor(table):
        return table[tokens.long()]
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if any(p.is_shard() and not p.is_shard(0) for p in table.placements):
        raise ValueError("embed_lookup: only the table's rows may be "
                         f"sharded, got {table.placements}")
    if is_dtensor(tokens):
        if tokens.device_mesh != mesh:
            raise ValueError("embed_lookup: tokens and table on different "
                             "meshes")
        tok_pl = list(tokens.placements)
        if any(p.is_shard() and not p.is_shard(0) for p in tok_pl):
            raise ValueError("embed_lookup: only the tokens' batch rows may "
                             f"be sharded, got {tok_pl}")
        if any(p.is_partial() for p in tok_pl):
            raise ValueError("embed_lookup: partial tokens")
        tok = tokens.to_local()
    else:
        tok_pl = [Replicate()] * mesh.ndim
        tok = tokens
    out_pl, grad_pl = [], []
    for tp, tb in zip(table.placements, tok_pl):
        rows_sharded = tp.is_shard(0)
        batch_sharded = tb.is_shard(0)
        out_pl.append(Shard(0) if batch_sharded
                      else Partial() if rows_sharded else Replicate())
        # a table dimension that sees only a batch slice gets a partial
        # gradient on each rank
        grad_pl.append(tp if not batch_sharded
                       else Partial() if not rows_sharded else None)
    if any(g is None for g in grad_pl):
        raise ValueError("embed_lookup: a mesh dimension shards both the "
                         "table's rows and the tokens' batch")
    local = table.to_local(grad_placements=grad_pl)
    lo, n = _shard_offset(table, 0), local.shape[0]
    tok = tok.long()
    hit = (tok >= lo) & (tok < lo + n)
    rows = local[torch.clamp(tok - lo, 0, n - 1)]
    rows = rows * hit[..., None].to(rows.dtype)
    return DTensor.from_local(rows, mesh, out_pl, run_check=False)


def vocab_lse_and_pick(logits, labels):
    """``(logsumexp(logits, -1), logits[..., labels])`` for DTensor logits
    whose last (vocab) dimension is sharded: each rank reduces its vocab
    slice — the max (an all-reduce MAX, outside autograd), the sum of
    exponentials and the label's logit where its rows hold it — and one
    sum all-reduce over the vocab-sharding mesh dimensions completes each;
    no rank holds a full-vocab row.  The results keep the logits' batch
    sharding.  Logits with an unsharded last dimension take the plain
    ops."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    last = logits.ndim - 1
    mesh = logits.device_mesh
    pl = list(logits.placements)
    vdims = [m for m, p in enumerate(pl) if p.is_shard(last)]
    if any(p.is_partial() for p in pl) or any(
            p.is_shard() and not (p.is_shard(0) or p.is_shard(last))
            for p in pl):
        raise ValueError(f"vocab_lse_and_pick: logits placed {pl}")
    if not vdims:
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.logsumexp(logits, dim=-1), ll
    out_pl = [Replicate() if m in vdims else p for m, p in enumerate(pl)]
    part_pl = [Partial() if m in vdims else p for m, p in enumerate(pl)]
    if is_dtensor(labels):
        lab = labels.redistribute(mesh, out_pl).to_local()
    else:
        lab = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False).redistribute(
                                     mesh, out_pl).to_local()
    loc = logits.to_local()
    with torch.no_grad():
        mx = loc.max(-1).values
        for m in vdims:
            dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=mesh.get_group(m))
    se = torch.exp(loc - mx[..., None]).sum(-1)
    se = DTensor.from_local(se, mesh, part_pl, run_check=False)
    lse = (torch.log(se.redistribute(mesh, out_pl))
           + DTensor.from_local(mx, mesh, out_pl, run_check=False))
    lo, n = _shard_offset(logits, last), loc.shape[-1]
    lab = lab.long()
    hit = (lab >= lo) & (lab < lo + n)
    pick = torch.gather(loc, -1, torch.clamp(lab - lo, 0, n - 1)[..., None])
    pick = pick[..., 0] * hit.to(loc.dtype)
    ll = DTensor.from_local(pick, mesh, part_pl,
                            run_check=False).redistribute(mesh, out_pl)
    return lse, ll
