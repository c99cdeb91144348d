"""Elastic scaling: re-mesh and re-shard on a membership change — the port
of ``repro.runtime.elastic`` on ``torch.distributed``.

Protocol (driven by the training loop):
  1. the coordinator's epoch bumps (join/leave/failure detected);
  2. every surviving rank finishes (or abandons) its in-flight step and
     enters the failure-aware barrier for the new epoch;
  3. the trainer rebuilds the mesh over the surviving ranks (dp shrinks or
     grows; tp is fixed by the model), re-derives the specs and restores
     the last complete checkpoint with the new layout — checkpoints hold
     every leaf logically unsharded (`checkpoint.manager`), so re-sharding
     is each rank keeping its slices of the new specs;
  4. the data loader re-shards its index space — the deterministic
     per-index corpus makes the stream continue exactly.

The world of processes stays as it was: `build_mesh` covers the first
``n_data × n_model`` ranks, every rank takes part in making its groups,
and a rank outside the mesh (``in_mesh`` false) sits the steps out.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..checkpoint.manager import CheckpointManager
from ..launch.mesh import make_mesh
from ..parallel import steps as steps_lib


@dataclass
class ElasticPlan:
    epoch: int
    n_data: int
    n_model: int
    global_batch: int


def plan_for_membership(n_alive_hosts: int, devices_per_host: int,
                        n_model: int, global_batch: int,
                        epoch: int) -> ElasticPlan:
    """dp extent = alive devices / tp; the batch stays constant
    (gradient accumulation picks up the slack) as long as dp divides
    it."""
    total = n_alive_hosts * devices_per_host
    n_data = max(1, total // n_model)
    while global_batch % n_data:
        n_data -= 1
    return ElasticPlan(epoch=epoch, n_data=n_data, n_model=n_model,
                       global_batch=global_batch)


def build_mesh(plan: ElasticPlan, device=None):
    """The (data, model) mesh of ``plan`` over the first ranks of the
    world (every rank must call it)."""
    return make_mesh((plan.n_data, plan.n_model), ("data", "model"), device)


def in_mesh(mesh) -> bool:
    """Whether this rank holds a place in ``mesh``."""
    return mesh.get_coordinate() is not None


def reshard_state(state, sc, mesh):
    """A restored (full, unsharded) train state laid out by the specs of
    the new mesh; a rank outside the mesh gets ``None``."""
    if not in_mesh(mesh):
        return None
    return steps_lib.distribute_state(state, sc, mesh)


def _whole(proto):
    """``proto`` with each DTensor leaf as an empty plain tensor of its
    dtype on its local device: a proto that restores whole leaves."""
    import torch

    from ..checkpoint.manager import _is_dtensor

    def one(x):
        if _is_dtensor(x):
            return torch.empty(0, dtype=x.dtype, device=x.device)
        return x

    if isinstance(proto, dict):
        return {k: _whole(v) for k, v in proto.items()}
    if isinstance(proto, tuple) and hasattr(proto, "_fields"):
        return type(proto)(*[_whole(v) for v in proto])
    if isinstance(proto, (list, tuple)):
        return type(proto)(_whole(v) for v in proto)
    return one(proto)


def resume_elastic(ckpt: CheckpointManager, proto_state, sc,
                   plan: ElasticPlan, device=None):
    """Restore the latest complete checkpoint (every leaf whole, on the
    device of ``proto_state``'s leaves) and reshard it onto the plan's
    mesh.  Returns (state, step, mesh); the state is ``None`` on a rank
    outside the mesh."""
    mesh = build_mesh(plan, device)
    restored, step = ckpt.restore(_whole(proto_state))
    return reshard_state(restored, sc, mesh), step, mesh
