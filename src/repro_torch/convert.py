"""Carry weights and semaphore state across from the JAX package as numpy
arrays.

The port never imports JAX: these functions take whatever the JAX side
hands over — ``jax.Array`` leaves or numpy arrays, anything
``np.asarray`` accepts — and build the port's tensors.  ``uint32`` leaves
become u32 carriers (int64 tensors, `core.u32`); :func:`to_numpy` maps a
port state back (int64 leaves to ``uint32``) so the two sides compare with
``==``.
"""

from __future__ import annotations

import numpy as np
import torch

from .admission.functional_qos import QoSState
from .core import u32
from .core.functional import BlockPool, SemaState
from .serving.engine_state import KVPool
from .serving.prefix import PrefixCache


def tensor(x, device=None) -> torch.Tensor:
    """One leaf: ``uint32`` → u32 carrier, anything else keeps its dtype."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return u32.u32(a, device=device)
    return torch.as_tensor(np.array(a), device=device)


def model_from_jax(model: dict, device=None) -> dict:
    """The paged-pool model dict (``emb``, ``wo``, ``kp``, ``vp``) as the
    port's float32 tensors."""
    return {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in model.items()}


def sema_from_jax(sema, device=None) -> SemaState:
    return SemaState(*[tensor(x, device) for x in sema])


def qos_from_jax(qos, device=None) -> QoSState:
    return QoSState(*[tensor(x, device) for x in qos])


def block_pool_from_jax(pool, device=None) -> BlockPool:
    return BlockPool(sema=sema_from_jax(pool.sema, device),
                     free_q=tensor(pool.free_q, device),
                     refcnt=tensor(pool.refcnt, device),
                     gen=tensor(pool.gen, device))


def prefix_cache_from_jax(cache, device=None) -> PrefixCache:
    """The weak prefix index (u32 keys and generations as carriers)."""
    return PrefixCache(*[tensor(x, device) for x in cache])


def kv_pool_from_jax(kv, device=None) -> KVPool:
    """The engine's block-paged KV state: pool, tables and (when the JAX
    state has one) the prefix cache."""
    return KVPool(pool=block_pool_from_jax(kv.pool, device),
                  tbl=tensor(kv.tbl, device),
                  cache=(prefix_cache_from_jax(kv.cache, device)
                         if kv.cache is not None else None))


def to_numpy(state) -> dict:
    """A port NamedTuple of tensors as ``{field: numpy array}`` with u32
    carriers back as ``uint32`` (nested NamedTuples — a `KVPool`'s pool
    and prefix cache — flatten to dotted names; absent parts are
    skipped)."""
    out = {}
    for name, x in zip(state._fields, state):
        if isinstance(x, tuple):
            out.update({f"{name}.{k}": v for k, v in to_numpy(x).items()})
        elif isinstance(x, torch.Tensor):
            a = x.detach().cpu().numpy()
            out[name] = a.astype(np.uint32) if a.dtype == np.int64 else a
    return out
