"""Carry weights and semaphore state across from the JAX package as numpy
arrays.

The port never imports JAX: these functions take whatever the JAX side
hands over — ``jax.Array`` leaves or numpy arrays, anything
``np.asarray`` accepts — and build the port's tensors.  ``uint32`` leaves
become u32 carriers (int64 tensors, `core.u32`); bfloat16 leaves (numpy
holds them in ``ml_dtypes.bfloat16``, which torch cannot read) cross bit
for bit through their 16-bit patterns; :func:`to_numpy` and
:func:`tree_to_numpy` map port tensors back (int64 leaves to ``uint32``,
bfloat16 to ``ml_dtypes.bfloat16``) so the two sides compare with ``==``.

Every converter builds on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"`` and raises where CUDA is absent
(`device.resolve_device`), like the port's other factories.
"""

from __future__ import annotations

import numpy as np
import torch

from .admission.functional_qos import QoSState
from .core import u32
from .core.functional import BlockPool, MultiSemaState, SemaState
from .device import resolve_device
from .optim.adamw import OptState, tree_map
from .parallel.steps import TrainState
from .serving.engine_state import KVPool
from .serving.prefix import PrefixCache


def tensor(x, device=None) -> torch.Tensor:
    """One leaf: ``uint32`` → u32 carrier, bfloat16 → ``torch.bfloat16``
    with the same bits, anything else keeps its dtype."""
    dev = resolve_device(device, "convert.tensor")
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return u32.u32(a, device=dev)
    if a.dtype.name == "bfloat16":
        bits = torch.as_tensor(np.array(a).view(np.int16), device=dev)
        return bits.view(torch.bfloat16)
    return torch.as_tensor(np.array(a), device=dev)


def leaf_to_numpy(x: torch.Tensor) -> np.ndarray:
    """One port tensor as numpy: int64 (u32 carriers) → ``uint32``,
    bfloat16 → the same bits as ``ml_dtypes.bfloat16`` (the dtype JAX
    hands over; ``uint16`` bits where ``ml_dtypes`` is not installed),
    anything else as it is."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        bits = x.view(torch.int16).numpy().view(np.uint16)
        try:
            import ml_dtypes
        except ImportError:
            return bits
        return bits.view(ml_dtypes.bfloat16)
    a = x.numpy()
    return a.astype(np.uint32) if a.dtype == np.int64 else a


def model_from_jax(model: dict, device=None) -> dict:
    """The paged-pool model dict (``emb``, ``wo``, ``kp``, ``vp``) as the
    port's float32 tensors."""
    dev = resolve_device(device, "convert.model_from_jax")
    return {k: torch.as_tensor(np.array(v, np.float32), device=dev)
            for k, v in model.items()}


def tree_from_jax(tree, device=None):
    """A nested dict / list / tuple of leaves (a JAX pytree of arrays) as
    the same nesting of the port's tensors, each leaf through
    :func:`tensor` (dtypes kept, ``uint32`` as u32 carriers)."""
    dev = resolve_device(device, "convert.tree_from_jax")
    if isinstance(tree, dict):
        return {k: tree_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_jax(v, dev) for v in tree)
    return tensor(tree, dev)


def params_from_jax(params, device=None) -> dict:
    """The transformer's parameter pytree (`models.transformer.
    init_params`) with the JAX layouts and dtypes kept: ``wq`` (D, H, hd),
    ``wo`` (H, hd, D); the MoE leaves ``router`` (f32), ``wi``/``wg``
    (E_pad, D, F), ``wo`` (E_pad, F, D) and ``shared``; the RG-LRU leaves
    (``lam`` f32) and the xLSTM cells'; the repeating unit's leaves stacked
    on a leading unit axis.  The generic walk carries every kind."""
    return tree_from_jax(params, resolve_device(device,
                                                "convert.params_from_jax"))


def opt_state_from_jax(opt, device=None) -> OptState:
    """AdamW's state (`optim.adamw.OptState`): ``step`` as a 0-dim int32
    tensor, the moments and the f32 master in the parameters' layout."""
    dev = resolve_device(device, "convert.opt_state_from_jax")
    return OptState(step=tensor(opt.step, dev),
                    mu=tree_from_jax(opt.mu, dev),
                    nu=tree_from_jax(opt.nu, dev),
                    master=tree_from_jax(opt.master, dev))


def train_state_from_jax(state, device=None, mesh=None, sc=None) -> TrainState:
    """A train state (`parallel.steps.TrainState`): the parameters, the
    optimizer state and the compression residuals.  With ``mesh`` (and
    the step configuration ``sc``, whose ``fsdp`` and ``compress_pods``
    pick the specs) every rank converts the whole state onto its local
    device and keeps its slices (`parallel.steps.distribute_state`); a
    residual converted for a mesh with pods is copied to each pod."""
    if mesh is not None:
        from .launch.mesh import local_device
        from .parallel.sharding import mesh_axes
        from .parallel.steps import StepConfig, distribute_state

        sc = StepConfig() if sc is None else sc
        dev = local_device(mesh)
        full = train_state_from_jax(state, dev)
        n_pods = mesh_axes(mesh).get("pod", 0)
        if full.residuals and n_pods and sc.compress_pods:
            full = full._replace(residuals=tree_map(
                lambda r: r[None].repeat((n_pods,) + (1,) * r.ndim),
                full.residuals))
        return distribute_state(full, sc, mesh)
    dev = resolve_device(device, "convert.train_state_from_jax")
    return TrainState(params=params_from_jax(state.params, dev),
                      opt=opt_state_from_jax(state.opt, dev),
                      residuals=tree_from_jax(state.residuals, dev))


def caches_from_jax(caches, device=None) -> dict:
    """The transformer's caches (`models.transformer.init_caches`): ring
    caches ``k``/``v`` (…, B, C, KV, hd), ``pos`` (…, B, C) int32, ``ptr``
    int32, and the recurrent states (RG-LRU ``h``/``conv``, mLSTM
    ``C``/``n``/``m``/``conv``, sLSTM ``c``/``n``/``h``/``m``), the units'
    stacked on a leading unit axis."""
    return tree_from_jax(caches, resolve_device(device,
                                                "convert.caches_from_jax"))


def multi_sema_from_jax(state, device=None) -> MultiSemaState:
    dev = resolve_device(device, "convert.multi_sema_from_jax")
    return MultiSemaState(*[tensor(x, dev) for x in state])


def sema_from_jax(sema, device=None) -> SemaState:
    dev = resolve_device(device, "convert.sema_from_jax")
    return SemaState(*[tensor(x, dev) for x in sema])


def qos_from_jax(qos, device=None) -> QoSState:
    dev = resolve_device(device, "convert.qos_from_jax")
    return QoSState(*[tensor(x, dev) for x in qos])


def block_pool_from_jax(pool, device=None) -> BlockPool:
    device = resolve_device(device, "convert.block_pool_from_jax")
    return BlockPool(sema=sema_from_jax(pool.sema, device),
                     free_q=tensor(pool.free_q, device),
                     refcnt=tensor(pool.refcnt, device),
                     gen=tensor(pool.gen, device))


def prefix_cache_from_jax(cache, device=None) -> PrefixCache:
    """The weak prefix index (u32 keys and generations as carriers)."""
    dev = resolve_device(device, "convert.prefix_cache_from_jax")
    return PrefixCache(*[tensor(x, dev) for x in cache])


def kv_pool_from_jax(kv, device=None) -> KVPool:
    """The engine's block-paged KV state: pool, tables and (when the JAX
    state has one) the prefix cache."""
    device = resolve_device(device, "convert.kv_pool_from_jax")
    return KVPool(pool=block_pool_from_jax(kv.pool, device),
                  tbl=tensor(kv.tbl, device),
                  cache=(prefix_cache_from_jax(kv.cache, device)
                         if kv.cache is not None else None))


def to_numpy(state) -> dict:
    """A port NamedTuple of tensors as ``{field: numpy array}`` with u32
    carriers back as ``uint32`` (nested NamedTuples — a `KVPool`'s pool
    and prefix cache — flatten to dotted names; absent parts are
    skipped; each leaf through :func:`leaf_to_numpy`)."""
    out = {}
    for name, x in zip(state._fields, state):
        if isinstance(x, tuple):
            out.update({f"{name}.{k}": v for k, v in to_numpy(x).items()})
        elif isinstance(x, torch.Tensor):
            out[name] = leaf_to_numpy(x)
    return out


def tree_to_numpy(tree):
    """A nested dict / list / tuple of port tensors (parameters, caches)
    as the same nesting of numpy arrays, each leaf through
    :func:`leaf_to_numpy`."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return leaf_to_numpy(tree)
