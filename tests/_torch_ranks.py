"""Multi-rank bodies for the port's mesh tests, and the launcher that runs
them.

`launch(target, world, workdir, timeout, **kw)` runs ``python
_torch_ranks.py`` in a subprocess that leads its own process group (so a
hung collective is killed with everything it spawned when ``timeout``
runs out), which spawns ``world`` ranks of ``target``.  The ranks meet
through a ``file://`` rendezvous in ``workdir`` — no fixed port, so
concurrent test workers cannot collide — over gloo on the CPU, one
thread each.  Rank 0 saves its result to ``workdir/result.pt``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def launch(target: str, world: int, workdir, timeout: float, **kw):
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": f"{SRC}{os.pathsep}{HERE}",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__)), target, str(world),
         str(workdir), json.dumps(kw)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{target} on {world} ranks passed its "
                             f"{timeout} s limit:\n{out[-4000:]}")
    assert proc.returncode == 0, f"{target} failed:\n{out[-6000:]}"
    return torch.load(workdir / "result.pt", weights_only=False)


def batch_np(vocab: int, B: int, S: int, seed: int = 0) -> dict:
    """The batch the reference's mesh test draws (numpy, ``seed``)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _tb(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _setup(rank, world, workdir):
    import logging

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_rank

    init_rank(rank, world, str(Path(workdir) / "rendezvous"))


def _flat(tree) -> dict:
    """``{path: full tensor}`` of a state tree; every rank calls it (a
    DTensor's ``full_tensor()`` is a collective)."""
    from repro_torch.checkpoint.manager import path_leaves

    out = {}
    for path, leaf in path_leaves(tree):
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        out["/".join(str(k) for k in path)] = leaf.detach().clone()
    return out


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


# ------------------------------------------------------------ the step -----


def mesh_train(rank, world, workdir, kw):
    """For each arch: the single-device step (rank 0, at the mesh's MoE
    dispatch groups) and the meshed step on each mesh, from the same
    seeded state and batch; the metrics, parameters and first moments."""
    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding, steps

    _setup(rank, world, workdir)
    B, S, A = kw["B"], kw["S"], kw["A"]
    opt = AdamWConfig(lr=kw["lr"], warmup_steps=1, total_steps=10)
    out, single = {}, {}
    for arch in kw["archs"]:
        cfg = get_smoke_config(arch)
        shape = ShapeSpec("t", S, B, "train")
        batch = _tb(batch_np(cfg.vocab, B, S))
        for dims in kw["meshes"]:
            axes = {"data": dims[0], "model": dims[1]}
            sc = steps.default_step_config(cfg, shape, dp=dims[0], axes=axes,
                                           accum_steps=A,
                                           param_dtype=torch.float32,
                                           fsdp=True)
            key = f"{arch}/{dims[0]}x{dims[1]}"
            # one device, the tokens in the mesh's dispatch groups
            # (G = data ranks), as the meshed MoE groups them
            groups = dims[0] if cfg.n_experts else 1
            if rank == 0 and (arch, groups) not in single:
                real = moe.mesh_axes
                moe.mesh_axes = lambda: {"data": groups}
                try:
                    st = steps.make_train_state(
                        torch.Generator().manual_seed(0), cfg, sc,
                        device="cpu")
                    st, m = steps.make_train_step(cfg, shape, sc, opt)(
                        st, batch)
                finally:
                    moe.mesh_axes = real
                single[(arch, groups)] = {"metrics": _metrics(m),
                                          "params": _flat(st.params),
                                          "mu": _flat(st.opt.mu)}
            if rank == 0:
                out[key + "/single"] = single[(arch, groups)]
            mesh = make_dev_mesh(*dims, device="cpu")
            with sharding.use_mesh(mesh):
                st = steps.make_train_state(torch.Generator().manual_seed(0),
                                            cfg, sc, mesh=mesh)
                step = steps.make_train_step(cfg, shape, sc, opt)
            st, m = step(st, batch)
            res = {"metrics": _metrics(m), "params": _flat(st.params),
                   "mu": _flat(st.opt.mu)}
            if rank == 0:
                out[key + "/mesh"] = res
    if rank == 0:
        torch.save(out, Path(workdir) / "result.pt")


def train_attention_local(rank, world, workdir, kw):
    """One meshed train step per (arch, mesh) with every call of the
    plain blockwise attention watched by a dispatch mode: how many
    products it ran on local tensors and on DTensor operands; and the
    step's metrics beside the single-device step's (rank 0)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import shard_attention, sharding, steps

    _setup(rank, world, workdir)
    seen = {"calls": 0, "local": 0, "dtensor": 0}

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._overloadpacket in flop_registry:
                dt = any(isinstance(a, DTensor)
                         for a in tree_leaves((args, kwargs)))
                seen["dtensor" if dt else "local"] += 1
            return func(*args, **(kwargs or {}))

    def watched(fn):
        def call(*a, **k):
            seen["calls"] += 1
            with Products():
                return fn(*a, **k)
        return call

    # the names the train branch can reach the plain attention by
    for mod in (transformer, shard_attention):
        if hasattr(mod, "blockwise_attention"):
            mod.blockwise_attention = watched(mod.blockwise_attention)
    B, S = kw["B"], kw["S"]
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}
    for arch, dims in kw["cases"]:
        cfg = get_smoke_config(arch)
        shape = ShapeSpec("t", S, B, "train")
        batch = _tb(batch_np(cfg.vocab, B, S))
        axes = {"data": dims[0], "model": dims[1]}
        sc = steps.default_step_config(cfg, shape, dp=dims[0], axes=axes,
                                       accum_steps=1,
                                       param_dtype=torch.float32,
                                       kv_block=kw["kv_block"])
        key = f"{arch}/{dims[0]}x{dims[1]}"
        if rank == 0:
            st = steps.make_train_state(torch.Generator().manual_seed(0),
                                        cfg, sc, device="cpu")
            _, m = steps.make_train_step(cfg, shape, sc, opt)(st, batch)
            out[key + "/single"] = _metrics(m)
        mesh = make_dev_mesh(*dims, device="cpu")
        with sharding.use_mesh(mesh):
            st = steps.make_train_state(torch.Generator().manual_seed(0),
                                        cfg, sc, mesh=mesh)
            step = steps.make_train_step(cfg, shape, sc, opt)
        before = dict(seen)
        _, m = step(st, batch)
        out[key + "/mesh"] = _metrics(m)
        out[key + "/seen"] = {k: seen[k] - before[k] for k in seen}
    if rank == 0:
        torch.save(out, Path(workdir) / "result.pt")


# the operand dimensions a product contracts, by aten op (None: a bias)
_CONTRACTED = {"mm": (1, 0), "bmm": (2, 1), "addmm": (None, 1, 0),
               "baddbmm": (None, 2, 1), "dot": (0, 0)}


def recurrent_local(rank, world, workdir, kw):
    """Per (arch, mesh): a meshed train step, a prefill and decode steps
    with `rglru._rglru_coeffs` and the xLSTM cells' time steps watched by
    a dispatch mode — the coefficients' products on local tensors, on
    DTensor operands, and on a DTensor operand split along the dimension
    the product contracts; the ops inside a time step on local tensors
    and on DTensors — and the train step's metrics beside the
    single-device step's (rank 0)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import rglru, xlstm
    from repro_torch.models.transformer import init_caches, init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding, steps

    _setup(rank, world, workdir)
    seen: dict = {}

    def split_contracted(func, args) -> bool:
        dims = _CONTRACTED.get(func._overloadpacket.__name__, ())
        return any(isinstance(a, DTensor) and d is not None and any(
            p.is_shard(d % a.ndim) and a.device_mesh.size(m) > 1
            for m, p in enumerate(a.placements))
            for a, d in zip(args, dims))

    class Watch(TorchDispatchMode):
        def __init__(self, what):
            super().__init__()
            self.what = what

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if self.what == "loop" or func._overloadpacket in flop_registry:
                dt = any(isinstance(a, DTensor)
                         for a in tree_leaves((args, kwargs)))
                seen[self.what + ("_dtensor" if dt else "_local")] += 1
                if dt and split_contracted(func, args):
                    seen[self.what + "_split"] += 1
            return func(*args, **(kwargs or {}))

    def watched(fn, what):
        def call(*a, **k):
            seen[what + "_calls"] += 1
            with Watch(what):
                return fn(*a, **k)
        return call

    rglru._rglru_coeffs = watched(rglru._rglru_coeffs, "coeffs")
    xlstm._mlstm_step = watched(xlstm._mlstm_step, "loop")
    xlstm._slstm_step = watched(xlstm._slstm_step, "loop")
    B, S, C, n_dec = kw["B"], kw["S"], kw["C"], kw["n_decode"]
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    out = {}

    def reset():
        seen.update({f"{w}_{k}": 0 for w in ("coeffs", "loop")
                     for k in ("calls", "local", "dtensor", "split")})

    def phase(key, fn):
        reset()
        res = fn()
        out[key + "/seen"] = dict(seen)
        return res

    reset()
    for arch, dims in kw["cases"]:
        cfg = get_smoke_config(arch)
        shape = ShapeSpec("t", S, B, "train")
        batch = _tb(batch_np(cfg.vocab, B, S))
        axes = {"data": dims[0], "model": dims[1]}
        sc = steps.default_step_config(cfg, shape, dp=dims[0], axes=axes,
                                       accum_steps=1,
                                       param_dtype=torch.float32)
        key = f"{arch}/{dims[0]}x{dims[1]}"
        if rank == 0:
            st = steps.make_train_state(torch.Generator().manual_seed(0),
                                        cfg, sc, device="cpu")
            _, m = steps.make_train_step(cfg, shape, sc, opt)(st, batch)
            out[key + "/single"] = _metrics(m)
        mesh = make_dev_mesh(*dims, device="cpu")
        with sharding.use_mesh(mesh):
            st = steps.make_train_state(torch.Generator().manual_seed(0),
                                        cfg, sc, mesh=mesh)
            step = steps.make_train_step(cfg, shape, sc, opt)
        _, m = phase(key + "/train", lambda: step(st, batch))
        out[key + "/mesh"] = _metrics(m)
        prompt, toks = serve_inputs(cfg.vocab, B, S, n_dec)
        params = init_params(torch.Generator().manual_seed(0), cfg,
                             torch.float32, "cpu")
        with sharding.use_mesh(mesh):
            params = steps.serve_params(params, mesh)
            prefill = steps.make_prefill_step(
                cfg, ShapeSpec("p", S, B, "prefill"))
            decode = steps.make_decode_step(cfg,
                                            ShapeSpec("d", C, B, "decode"))
        _, caches = phase(key + "/prefill", lambda: prefill(
            params, {"tokens": torch.as_tensor(prompt)},
            init_caches(cfg, B, C, torch.float32, "cpu")))
        for t in range(n_dec):
            pos = torch.full((B, 1), S + t, dtype=torch.int32)
            _, caches = phase(key + f"/decode{t}", lambda: decode(
                params, torch.as_tensor(toks[t]), pos, caches))
    if rank == 0:
        torch.save(out, Path(workdir) / "result.pt")


# ------------------------------------------------------- the serve steps ----


def serve_inputs(vocab: int, B: int, S: int, n_decode: int, seed: int = 0):
    """The prompt (B, S) and the decode steps' tokens (n_decode, B, 1)
    that the serve-step tests feed (numpy, ``seed``)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (n_decode, B, 1)).astype(np.int32))


def serve_run(cfg, B, S, C, n_decode, mesh=None, groups=1,
              dtype=torch.float32):
    """A prefill of S tokens into caches of capacity C, then ``n_decode``
    decode steps (positions S, S + 1, …), through the port's serve steps
    (under ``mesh`` when given; else on one device with the MoE's tokens
    in ``groups`` dispatch groups, as a mesh of that many data ranks
    groups them), the parameters drawn and the caches made in ``dtype``.
    Returns each step's whole logits and the final caches' leaves."""
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.models import moe
    from repro_torch.models.transformer import init_caches, init_params
    from repro_torch.parallel import sharding, steps

    prompt, toks = serve_inputs(cfg.vocab, B, S, n_decode)
    params = init_params(torch.Generator().manual_seed(0), cfg, dtype,
                         "cpu")
    caches = init_caches(cfg, B, C, dtype, "cpu")
    pre_shape = ShapeSpec("p", S, B, "prefill")
    dec_shape = ShapeSpec("d", C, B, "decode")
    real = moe.mesh_axes
    if mesh is None:
        moe.mesh_axes = lambda: {"data": groups}
    try:
        with sharding.use_mesh(mesh):
            if mesh is not None:
                params = steps.serve_params(params, mesh)
            prefill = steps.make_prefill_step(cfg, pre_shape)
            decode = steps.make_decode_step(cfg, dec_shape)
        logits = []
        lg, caches = prefill(params, {"tokens": torch.as_tensor(prompt)},
                             caches)
        logits.append(lg)
        for t in range(n_decode):
            pos = torch.full((B, 1), S + t, dtype=torch.int32)
            lg, caches = decode(params, torch.as_tensor(toks[t]), pos,
                                caches)
            logits.append(lg)
    finally:
        moe.mesh_axes = real
    full = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x
    return ({"logits": [full(x).detach().clone() for x in logits]},
            _flat(caches))


def mesh_serve(rank, world, workdir, kw):
    """For each arch and mesh: the port's meshed serve steps and (rank 0)
    its single-device steps at the mesh's MoE dispatch groups; and how
    DTensor cuts the rows of a (data, model) sequence-sharded tensor."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.parallel import sharding

    _setup(rank, world, workdir)
    C, S, n = kw["C"], kw["S"], kw["n_decode"]
    out = {}
    mesh = make_dev_mesh(2, 2, device="cpu")
    rows = sharding.distribute(torch.arange(2 * 8).reshape(2, 8), mesh,
                               (None, ("data", "model")))
    held = [None] * world
    torch.distributed.all_gather_object(
        held, (mesh.get_coordinate(), rows.to_local().tolist()))
    out["rows"] = held
    for arch in kw["archs"]:
        cfg = get_smoke_config(arch)
        for dims, B in kw["cases"]:
            key = f"{arch}/{dims[0]}x{dims[1]}/b{B}"
            if rank == 0:
                out[key + "/single"] = serve_run(cfg, B, S, C, n,
                                                 groups=dims[0])
            mesh = make_dev_mesh(*dims, device="cpu")
            res = serve_run(cfg, B, S, C, n, mesh=mesh)
            if rank == 0:
                out[key + "/mesh"] = res
    if rank == 0:
        torch.save(out, Path(workdir) / "result.pt")


def mesh_bf16(rank, world, workdir, kw):
    """The reference's production dtype under a mesh: for each arch and
    mesh, the serve steps on bf16 parameters and caches and one train
    step at `steps.default_step_config`'s bf16 (FSDP on, the f32 master),
    meshed and (rank 0) on one device at the mesh's MoE dispatch
    groups."""
    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import moe
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding, steps

    _setup(rank, world, workdir)
    C, S, n = kw["C"], kw["S"], kw["n_decode"]
    B, T, lr = kw["B"], kw["T"], kw["lr"]
    opt = AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
    bf16 = torch.bfloat16
    out = {}

    def train(cfg, sc, shape, batch, mesh=None):
        with sharding.use_mesh(mesh):
            st = steps.make_train_state(torch.Generator().manual_seed(0),
                                        cfg, sc, device="cpu", mesh=mesh)
            step = steps.make_train_step(cfg, shape, sc, opt)
        st, m = step(st, batch)
        return {"metrics": _metrics(m), "params": _flat(st.params),
                **{f: _flat(getattr(st.opt, f))
                   for f in ("mu", "nu", "master")}}

    for arch in kw["archs"]:
        cfg = get_smoke_config(arch)
        shape = ShapeSpec("t", T, B, "train")
        batch = _tb(batch_np(cfg.vocab, B, T))
        for dims in kw["meshes"]:
            key = f"{arch}/{dims[0]}x{dims[1]}"
            axes = {"data": dims[0], "model": dims[1]}
            sc = steps.default_step_config(cfg, shape, dp=dims[0], axes=axes,
                                           fsdp=True)
            assert sc.param_dtype == bf16
            if rank == 0:
                out[key + "/serve/single"] = serve_run(
                    cfg, B, S, C, n, groups=dims[0], dtype=bf16)
                real = moe.mesh_axes
                moe.mesh_axes = lambda: {"data": dims[0]}
                try:
                    out[key + "/train/single"] = train(cfg, sc, shape, batch)
                finally:
                    moe.mesh_axes = real
            mesh = make_dev_mesh(*dims, device="cpu")
            res = {"serve": serve_run(cfg, B, S, C, n, mesh=mesh, dtype=bf16),
                   "train": train(cfg, sc, shape, batch, mesh)}
            if rank == 0:
                out[key + "/serve/mesh"] = res["serve"]
                out[key + "/train/mesh"] = res["train"]
    if rank == 0:
        torch.save(out, Path(workdir) / "result.pt")


# ----------------------------------------------------------- compression ----


def compress_exchange(rank, world, workdir, kw):
    """`compress_psum` over the world: shard r's gradient and residual are
    ``kw["inputs"][case][r]``; every rank's (g_mean, residual)."""
    import torch.distributed as dist

    from repro_torch.optim.compression import compress_psum

    _setup(rank, world, workdir)
    inputs = torch.load(kw["inputs"], weights_only=False)
    out = {}
    for case, per_rank in inputs.items():
        g, r = (torch.as_tensor(x) for x in per_rank[rank])
        gm, nr = compress_psum(g, r, dist.group.WORLD, world)
        got = [None] * world
        dist.all_gather_object(got, (gm.numpy(), nr.numpy()))
        out[case] = got
    if rank == 0:
        torch.save(out, Path(workdir) / "result.pt")


def compressed_train(rank, world, workdir, kw):
    """The compressed train step on (pod, data, model) for ``steps``
    steps from the seeded state: each step's metrics, and the final
    parameters and residuals."""
    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding, steps

    _setup(rank, world, workdir)
    cfg = get_smoke_config(kw["arch"])
    B, S = kw["B"], kw["S"]
    shape = ShapeSpec("t", S, B, "train")
    opt = AdamWConfig(lr=kw["lr"], warmup_steps=1, total_steps=10)
    n_pod, n_data, n_model = kw["dims"]
    axes = {"pod": n_pod, "data": n_data, "model": n_model}
    sc = steps.default_step_config(cfg, shape, dp=n_pod * n_data, axes=axes,
                                   accum_steps=1, param_dtype=torch.float32,
                                   fsdp=True, compress_pods=True)
    mesh = make_dev_mesh(n_data, n_model, n_pod, device="cpu")
    with sharding.use_mesh(mesh):
        st = steps.make_train_state(torch.Generator().manual_seed(0), cfg, sc,
                                    mesh=mesh)
        step = steps.make_train_step(cfg, shape, sc, opt)
    # which batch rows each rank holds under the batch rule (pod, data)
    rows = sharding.distribute(torch.arange(B), mesh, (("pod", "data"),))
    held = [None] * world
    torch.distributed.all_gather_object(
        held, (mesh.get_coordinate(), rows.to_local().tolist()))
    hist = []
    for t in range(kw["steps"]):
        st, m = step(st, _tb(batch_np(cfg.vocab, B, S, seed=t)))
        hist.append(_metrics(m))
    res = {"metrics": hist, "params": _flat(st.params),
           "residuals": _flat(st.residuals), "rows": held}
    # one step on the mesh the reference's compressed step fails on
    n_pod, n_data, n_model = kw["fault_dims"]
    mesh = make_dev_mesh(n_data, n_model, n_pod, device="cpu")
    sc = sc._replace(accum_steps=1)
    with sharding.use_mesh(mesh):
        st = steps.make_train_state(torch.Generator().manual_seed(0), cfg, sc,
                                    mesh=mesh)
        step = steps.make_train_step(cfg, shape, sc, opt)
    _, m = step(st, _tb(batch_np(cfg.vocab, B, S)))
    res["fault_mesh_loss"] = float(m["loss"])
    if rank == 0:
        torch.save(res, Path(workdir) / "result.pt")


# --------------------------------------------------------------- elastic ----


def elastic(rank, world, workdir, kw):
    """dp 4 → 2 → 4 with model = 1 through checkpoints: a straight run of
    the seeded state on dp 4 against the same steps taken across the
    resizes, and a restore onto the same mesh."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding, steps
    from repro_torch.runtime import elastic as el

    _setup(rank, world, workdir)
    cfg = get_smoke_config(kw["arch"])
    B, S = kw["B"], kw["S"]
    shape = ShapeSpec("t", S, B, "train")
    opt = AdamWConfig(lr=kw["lr"], warmup_steps=1, total_steps=10)
    sc = steps.default_step_config(cfg, shape, dp=4, axes={"data": 4},
                                   accum_steps=1, param_dtype=torch.float32,
                                   fsdp=True)
    batches = [_tb(batch_np(cfg.vocab, B, S, seed=t)) for t in range(4)]
    ck = CheckpointManager(str(Path(workdir) / "ckpt"))

    def stepper(mesh):
        with sharding.use_mesh(mesh):
            return steps.make_train_step(cfg, shape, sc, opt)

    def save(t, state):
        ck.save(t, state, blocking=True)
        dist.barrier()

    mesh4 = make_dev_mesh(4, 1, device="cpu")
    # a JAX state (its leaves as arrays) converted onto the mesh
    from repro_torch import convert

    jst = convert.train_state_from_jax(_nested(np.load(kw["jax_state"])),
                                       mesh=mesh4, sc=sc)
    from_jax = {"leaves": {k: v.numpy() for k, v in _flat(jst).items()}}
    _, m = stepper(mesh4)(jst, batches[0])
    from_jax["loss"] = float(m["loss"])
    with sharding.use_mesh(mesh4):
        st = steps.make_train_state(torch.Generator().manual_seed(0), cfg, sc,
                                    mesh=mesh4)
    step4 = stepper(mesh4)
    st, _ = step4(st, batches[0])
    save(1, st)
    straight = []
    s = st
    for t in (1, 2, 3):
        s, m = step4(s, batches[t])
        straight.append(float(m["loss"]))
    # the same mesh after a restore: bit-equal
    plan4 = el.plan_for_membership(4, 1, 1, B, epoch=1)
    r4, at, mesh4b = el.resume_elastic(ck, st, sc, plan4, device="cpu")
    _, m = stepper(mesh4b)(r4, batches[1])
    same = float(m["loss"])
    # shrink to dp 2 (ranks 2 and 3 sit out), one step, save
    plan2 = el.plan_for_membership(2, 1, 1, B, epoch=2)
    r2, at2, mesh2 = el.resume_elastic(ck, st, sc, plan2, device="cpu")
    resized = []
    if el.in_mesh(mesh2):
        r2, m = stepper(mesh2)(r2, batches[1])
        resized.append(float(m["loss"]))
        ck.save(2, r2, blocking=True)
    dist.barrier()
    # grow back to dp 4
    r4, at3, mesh4c = el.resume_elastic(ck, st, sc, plan4, device="cpu")
    for t in (2, 3):
        r4, m = stepper(mesh4c)(r4, batches[t])
        resized.append(float(m["loss"]))
    if rank == 0:
        torch.save({"from_jax": from_jax,
                    "straight": straight, "same_mesh": same,
                    "resized": resized, "steps": [at, at2, at3],
                    "plans": [plan2.n_data, plan4.n_data]},
                   Path(workdir) / "result.pt")


def _nested(flat) -> object:
    """A JAX train state from ``{"params/units/b0/attn/wq": array, ...}``
    (its ``/``-joined key paths): dicts and attribute namespaces for the
    state's NamedTuples, as `convert.train_state_from_jax` reads them."""
    from types import SimpleNamespace

    root: dict = {}
    for key in flat.files if hasattr(flat, "files") else flat:
        *path, leaf = key.split("/")
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    opt = SimpleNamespace(**root["opt"])
    return SimpleNamespace(params=root["params"], opt=opt,
                           residuals=root.get("residuals", {}))


def _main() -> None:
    import torch.multiprocessing as mp

    target, world, workdir, kw = (sys.argv[1], int(sys.argv[2]),
                                  sys.argv[3], json.loads(sys.argv[4]))
    mp.spawn(globals()[target], args=(world, workdir, kw), nprocs=world)


if __name__ == "__main__":
    _main()
