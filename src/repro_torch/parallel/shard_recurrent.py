"""The recurrent blocks on each rank's shard under a mesh: what GSPMD
derives for the reference's RG-LRU and xLSTM blocks when their
activations are sharded, written out on local tensors, as
`parallel.shard_attention` does for the attention.

  mesh_rglru_coeffs     the RG-LRU's gate products: ``u`` (B, S, W) split
                        over ``lru`` is gathered over W (the contracted
                        dimension) and multiplied against the rank's
                        column shard of ``w_a`` / ``w_i``, so the gates
                        land split over ``lru`` as ``u`` was and no
                        product contracts a split dimension;
  on_local_rows         a time loop on each rank's batch rows: its inputs
                        laid out as the cell state is (the batch over the
                        batch axes, the rest whole; a partial sum of the
                        projections summed here), taken to local tensors,
                        the loop run there and its outputs wrapped back.

`models.transformer.block_forward` hands them to the blocks
(``coeffs=``, ``run=``) for a DTensor input, in every mode.

Every product and every time step runs on local tensors, so DTensor is
asked for no sharding strategy there (torch 2.11's has none for the
gates' product with ``u`` split along W, "redistribute from S(0) to
P(sum)"), and a loop over a long sequence dispatches plain ops, not
DTensor ones.  Under autograd the gradients reach the DTensors: a
tensor gathered over a mesh dimension passes back a ``Partial`` gradient
over it, and so does a weight used on the rank's batch rows over the
batch axes.  The projections before and after stay on DTensor.
"""

from __future__ import annotations

from ..models import rglru
from .shard_attention import _ContiguousGrad
from .sharding import is_dtensor, local_rows


def _local(t, mesh, layout, grads=None):
    """DTensor ``t`` redistributed to ``layout``, as a local tensor whose
    gradient goes back placed as ``grads`` (``layout`` by default) and
    contiguous."""
    return _ContiguousGrad.apply(t.redistribute(mesh, layout).to_local(
        grad_placements=grads))


def mesh_rglru_coeffs(p, u):
    """`models.rglru._rglru_coeffs` on each rank's shard.  ``u`` (B, S,
    W) a DTensor, the batch over the batch axes and W over the ``lru``
    mesh dimensions; ``p`` the block's DTensor parameters.  Returns
    (a, b) placed as ``u``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = u.device_mesh
    cols = [Shard(0) if pl.is_shard(0) else Shard(2) if pl.is_shard(2)
            else Replicate() for pl in u.placements]
    rows = [Shard(0) if c.is_shard(0) else Replicate() for c in cols]

    def weight(shard):
        # the rank's W columns of a weight (``shard`` names their
        # dimension); its gradient is partial over the batch axes, which
        # see a batch slice
        return ([shard if c.is_shard(2) else Replicate() for c in cols],
                [shard if c.is_shard(2) else Partial() if c.is_shard(0)
                 else Replicate() for c in cols])

    mat, vec = weight(Shard(1)), weight(Shard(0))
    lp = {k: _local(p[k], mesh, *(mat if p[k].dim() == 2 else vec))
          for k in ("w_a", "w_i", "b_a", "b_i", "lam")}
    # u whole over W: each rank's gates see only its columns of w, so
    # the gradient of the gathered u is partial over the W dimensions
    ug = _local(u, mesh, rows, [Partial() if c.is_shard(2) else r
                                for c, r in zip(cols, rows)])
    a, b = rglru._rglru_coeffs(lp, _local(u, mesh, cols), ug)
    return tuple(DTensor.from_local(t, mesh, cols, run_check=False)
                 for t in (a, b))


def on_local_rows(scan, like, weights, *inputs):
    """``scan(*weights, *inputs)`` on each rank's batch rows.  ``like``
    (B, ...) the block's DTensor input, whose batch placements the rows
    follow; every DTensor in ``inputs`` (tensors and dicts of them) is
    laid out as those rows, whole over every other mesh dimension (a
    partial sum is summed), and taken to its local tensor; a plain tensor
    (every rank's the same) gives its rows.  ``weights`` go to local
    tensors whole, their gradients partial over the batch axes.  The
    tensors ``scan`` returns (a tuple of tensors and dicts of them) come
    back as DTensors laid out as the rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = like.device_mesh
    rows = [Shard(0) if pl.is_shard(0) else Replicate()
            for pl in like.placements]
    whole = [Replicate()] * mesh.ndim
    w_grads = [Partial() if r.is_shard(0) else Replicate() for r in rows]

    def tree(fn, x):
        return ({k: fn(v) for k, v in x.items()} if isinstance(x, dict)
                else fn(x))

    def take(t):
        return (_local(t, mesh, rows) if is_dtensor(t)
                else local_rows(t, like))

    ws = [_local(w, mesh, whole, w_grads) if is_dtensor(w) else w
          for w in weights]

    def wrap(t):
        # contiguous: DTensor derives the global strides from the local ones
        return DTensor.from_local(t.contiguous(), mesh, rows,
                                  run_check=False)

    out = scan(*ws, *(tree(take, x) for x in inputs))
    return tuple(tree(wrap, x) for x in out)

