"""Sharded, asynchronous, fault-tolerant checkpointing — the port of
``repro.checkpoint.manager`` in torch's own format.

Layout (works on any POSIX FS / NFS):

    <dir>/step_000123.tmp/          # written first
        shard_00000.pt              # this host's leaves (flat name → tensor)
        commit_00000                # this host's commit marker
    <dir>/step_000123/              # atomic rename when ALL hosts committed
        meta.json                   # step, hosts, time

Each shard is a flat dict of CPU tensors, one per leaf, keyed by the
leaf's path (``qos/ticket``, ``kv/pool/sema/grant``, ``model/emb``: dict
keys, NamedTuple field names and sequence indices joined by ``/``, the
reference's key paths), written with ``torch.save`` and read back with
``torch.load(..., weights_only=True)``.  The int64 carriers of u32
counters (`core.u32`) are stored as they lie, so they round-trip bit for
bit across the 2³² wrap.

* async: `save` copies every leaf into fresh host memory and returns; a
  writer thread persists it in the background;
* writer-slot admission is a TWA semaphore (`max_concurrent_io`,
  `core.twa_semaphore`): FIFO admission keeps checkpoint order under
  backlog, and its queue depth is an "FS is slow" alarm;
* atomicity: per-host shard files plus a commit marker per host; the
  rename to the final name happens only when every expected host
  committed (restore ignores ``.tmp`` directories — a torn checkpoint is
  invisible);
* restore: the newest COMPLETE step (or the one asked for), every leaf put
  back on the proto's device and dtype as fresh storage.

A tree with DTensor leaves (a train state on a mesh) is saved logically
unsharded, as the reference's manager saves a sharded state: every rank
calls `save` (each DTensor's ``full_tensor()`` is a collective), and only
rank 0 of the world writes — its manager's commit is the checkpoint's.
The caller lets the other ranks read it only after that write (a
blocking save, then a barrier).  `restore` gives a DTensor proto leaf
back with the proto's mesh and placements, each rank keeping its slice.

Several "hosts" writing into one directory are simulated by several
managers with distinct ``host_id``s.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import torch

from ..core.twa_semaphore import TWASemaphore


def path_leaves(tree, path=()):
    """``(path, leaf)`` pairs in JAX's flatten order: dict keys sorted,
    NamedTuple fields and sequence items in order (a path holds the dict
    keys, field names and indices); ``None`` and empty containers hold no
    leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in path_leaves(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for f, v in zip(tree._fields, tree)
                for pl in path_leaves(v, path + (f,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in path_leaves(v, path + (i,))]
    return [(path, tree)]


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _flatten(tree) -> dict:
    """Every leaf as a fresh contiguous CPU tensor (one copy, so a later
    in-place write to the live tree cannot reach the snapshot), keyed by
    its ``/``-joined path."""
    out = {}
    for path, leaf in path_leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"checkpoint leaf {_key(path)!r} is "
                            f"{type(leaf).__name__}, not a tensor")
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()  # collective: every rank calls it
        host = torch.empty(leaf.shape, dtype=leaf.dtype, device="cpu")
        host.copy_(leaf.detach())
        out[_key(path)] = host
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _writes(tree) -> bool:
    """Whether this process writes ``tree``: always, unless the tree holds
    DTensor leaves and this is not rank 0 of the world."""
    if not any(_is_dtensor(leaf) for _, leaf in path_leaves(tree)):
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def _unflatten_like(proto, flat: dict, path=()):
    """``proto``'s structure with each leaf taken from ``flat`` and put on
    the proto leaf's device and dtype."""
    if proto is None:
        return None
    if isinstance(proto, dict):
        return {k: _unflatten_like(v, flat, path + (k,))
                for k, v in proto.items()}
    if isinstance(proto, tuple) and hasattr(proto, "_fields"):
        return type(proto)(*[_unflatten_like(v, flat, path + (f,))
                             for f, v in zip(proto._fields, proto)])
    if isinstance(proto, (tuple, list)):
        return type(proto)(_unflatten_like(v, flat, path + (i,))
                           for i, v in enumerate(proto))
    t = flat[_key(path)]
    if _is_dtensor(proto):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.to(device=proto.device, dtype=proto.dtype),
                                 proto.device_mesh, proto.placements,
                                 src_data_rank=None)
    return t.to(device=proto.device, dtype=proto.dtype)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        *,
        host_id: int = 0,
        expected_hosts: int = 1,
        max_concurrent_io: int = 2,
        keep: int = 3,
        finalize_timeout: float = 300.0,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.expected_hosts = expected_hosts
        self.keep = keep
        # how long host 0 waits for the other hosts' commit markers before
        # giving up on publishing a step (the .tmp dir stays, invisible to
        # restore; a later save of the same step can still finalize it)
        self.finalize_timeout = float(finalize_timeout)
        # Writer-slot admission: the paper's semaphore as I/O throttle.
        self._io_slots = TWASemaphore(max_concurrent_io, waiting="futex")
        self._pending: list[threading.Thread] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------- save ----

    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Snapshot to host memory, then persist asynchronously."""
        flat = _flatten(tree)
        if not _writes(tree):
            return
        t = threading.Thread(target=self._persist, args=(step, flat),
                             daemon=True)
        with self._lock:
            self._pending.append(t)
        t.start()
        if blocking:
            t.join()

    def save_sync(self, step: int, tree) -> None:
        """Emergency path (failure signal): bypass the queue, write NOW."""
        flat = _flatten(tree)
        if _writes(tree):
            self._persist(step, flat, emergency=True)

    def _persist(self, step: int, flat: dict, emergency: bool = False) -> None:
        if not emergency:
            self._io_slots.take()  # FIFO writer slot
        try:
            tmp = self.dir / f"step_{step:09d}.tmp"
            tmp.mkdir(parents=True, exist_ok=True)
            shard = tmp / f"shard_{self.host_id:05d}.pt"
            partial = shard.with_suffix(f".{threading.get_ident()}.partial")
            try:
                with open(partial, "wb") as f:
                    torch.save(flat, f)
                os.replace(partial, shard)  # atomic per shard
                (tmp / f"commit_{self.host_id:05d}").touch()
            except FileNotFoundError:
                # a concurrent duplicate save of the same step already
                # finalized (renamed) the tmp dir — nothing left to do
                if not (self.dir / f"step_{step:09d}").exists():
                    raise
                return
            if self.host_id == 0:
                self._try_finalize(step)
        finally:
            if not emergency:
                self._io_slots.post()

    def _try_finalize(self, step: int, timeout: float | None = None) -> bool:
        tmp = self.dir / f"step_{step:09d}.tmp"
        final = self.dir / f"step_{step:09d}"
        if timeout is None:
            timeout = self.finalize_timeout
        deadline = time.time() + timeout
        while time.time() < deadline:
            if final.exists():
                return True  # a concurrent saver of the same step published
            commits = list(tmp.glob("commit_*"))
            if len(commits) >= self.expected_hosts:
                meta = {"step": step, "hosts": self.expected_hosts,
                        "time": time.time()}
                try:
                    (tmp / "meta.json").write_text(json.dumps(meta))
                    os.replace(tmp, final)  # atomic publish
                except FileNotFoundError:
                    # lost the publish race to a concurrent finalizer of
                    # the same step — the checkpoint exists either way
                    if not final.exists():
                        raise
                self._gc()
                return True
            time.sleep(0.01)
        return False

    def _gc(self):
        steps = sorted(self.complete_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    def wait(self):
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()

    # ---------------------------------------------------------- restore ----

    def complete_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if (p.is_dir() and not p.name.endswith(".tmp")
                    and (p / "meta.json").exists()):
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.complete_steps()
        return steps[-1] if steps else None

    def restore(self, proto, step: int | None = None):
        """Restore into the structure, devices and dtypes of ``proto``;
        every leaf comes back as fresh storage.  Raises when a shard is
        unreadable (a torn write).  Returns ``(tree, step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        flat: dict = {}
        for shard in sorted(d.glob("shard_*.pt")):
            flat.update(torch.load(shard, map_location="cpu",
                                   weights_only=True))
        return _unflatten_like(proto, flat), step

    def io_telemetry(self) -> dict:
        return {"writers_queued": self._io_slots.queue_depth(),
                "slots_free": self._io_slots.available()}
