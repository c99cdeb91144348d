"""Device meshes — the port of ``repro.launch.mesh`` on
``torch.distributed``: a `DeviceMesh` with named dimensions ``("pod",)
"data", "model"``.

Functions, never module-level meshes: importing this module touches no
process group.  A mesh needs the default process group of the ranks it
covers; `init_rank` starts one from a file rendezvous (``file://`` —
no fixed port, so concurrent runs cannot collide) with an explicit world
size and rank, since nothing on the machine describes a cluster.

The production deployment is an H100 one (the reference's is the TPU
v5e's 16 × 16 pods): ``model`` is the 8 GPUs of one NVLink node, ``data``
runs across the nodes of a cluster and ``pod`` across clusters —
(data 32, model 8) = 256 GPUs, or (pod 2, data 32, model 8) = 512.
`production_axes` gives those sizes without a world of processes, for
the spec derivations of `parallel.sharding`.
"""

from __future__ import annotations

import datetime
import os

import torch

from ..device import resolve_device

POD_NODES, NODE_GPUS = 32, 8


def production_axes(*, multi_pod: bool = False) -> dict[str, int]:
    """The production mesh's axis sizes (see the module docstring)."""
    axes = {"data": POD_NODES, "model": NODE_GPUS}
    return {"pod": 2, **axes} if multi_pod else axes


def mesh_device_count(*, multi_pod: bool = False) -> int:
    n = 1
    for v in production_axes(multi_pod=multi_pod).values():
        n *= v
    return n


def init_rank(rank: int, world: int, init_file: str, backend: str = "gloo",
              timeout_s: float = 300.0) -> None:
    """Join the default process group of ``world`` ranks as ``rank``,
    meeting the others at ``init_file`` (a path no earlier run used).
    gloo talks over the loopback interface unless ``GLOO_SOCKET_IFNAME``
    names another (ranks on several hosts must name theirs): the ranks
    here share one machine, which has no network to resolve its name
    on."""
    import torch.distributed as dist

    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _device_type(device) -> str:
    return torch.device(resolve_device(device, "make_dev_mesh")).type


def make_mesh(shape: tuple, names: tuple, device=None):
    """A `DeviceMesh` over the first ``prod(shape)`` ranks of the world
    (every rank must call it: the mesh's groups are made collectively; a
    rank outside the mesh gets one whose ``get_coordinate()`` is
    ``None``).  ``device=None`` means the card."""
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(_device_type(device), ranks, mesh_dim_names=names)


def make_dev_mesh(n_data: int = 2, n_model: int = 2, n_pod: int = 0,
                  device=None):
    """A small mesh ``(data, model)``, or ``(pod, data, model)`` when
    ``n_pod`` is set, over the first ranks of the world."""
    if n_pod:
        return make_mesh((n_pod, n_data, n_model), ("pod", "data", "model"),
                         device)
    return make_mesh((n_data, n_model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh (`production_axes`) over a world of
    `mesh_device_count` ranks."""
    axes = production_axes(multi_pod=multi_pod)
    return make_mesh(tuple(axes.values()), tuple(axes), device)


def local_device(mesh) -> torch.device:
    """The device this rank's shards live on: ``cpu``, or the card
    ``LOCAL_RANK`` names (``cuda:0`` when it is unset — several ranks may
    share one card over gloo)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
