"""The port's meshed steps at the reference's production dtype: the serve
steps on bf16 parameters and caches, and one train step at
`default_step_config`'s bf16 (bf16 working parameters, the f32 master,
FSDP on), on four gloo ranks at (data 2, model 2) and (data 1, model 4),
for qwen2-0.5b and one recurrent kind, recurrentgemma-9b (RG-LRU blocks
beside windowed attention), against JAX's ``Auto``-axis meshed steps at
bf16 and against the port's one-device bf16 steps.

Four ranks (`_torch_ranks.mesh_bf16`, a subprocess with its own timeout)
serve a prefill of S = 28 tokens into 32-slot rings and 5 decode steps
(the ring wraps) at B = 4, and train one step at B = 4 × T = 16, A = 1,
from the port's seeded bf16 parameters; JAX runs the same steps from
the same parameters on forced-device meshes of the same shapes at the
same time, one subprocess an (arch, mesh) (on (1, 4) with the size-1 ``data`` dropped from the
``seq_kv`` rule, as `tests/test_torch_mesh_serve.py` does), and on one
device at f32 from the same parameters cast up: the yardstick.

The tolerances are those of `tests/test_torch_bf16.py` and
`tests/test_torch_train_bf16.py`: no two of these runs round to bf16 at
the same points (a meshed product sums bf16 partial results across
ranks, one device sums them in f32), so logits within 5e-2 × max
|logit|, bf16 cache leaves within 5% of each leaf's largest magnitude,
f32 state leaves within `YARD` × the gap JAX's bf16 states open from its
f32 run's, ``pos`` / ``ptr`` bit-equal; the train step's metrics,
moments and master as in `tests/test_torch_train_bf16.py`; every leaf
of the reference's dtype.  The MoE archs at bf16 on a mesh are left to
the card (their f32 meshed steps are held in the two mesh test files)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro_torch.checkpoint.manager import path_leaves
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.transformer import init_params

ARCHS = ("qwen2-0.5b", "recurrentgemma-9b")
MESHES = ((2, 2), (1, 4))
C, S, N_DECODE = 32, 28, 5          # serve
B, T, LR = 4, 16, 1e-3              # serve batch; train B × T
LOGIT_TOL = 5e-2
KV_TOL = 5e-2
YARD = 2.0
METRIC_TOL = 2.5e-3                 # as tests/test_torch_train_bf16.py
ZERO_GRAD_LEAVES = ("/bk",)         # the key bias (test_torch_train_bf16)

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro import compat
    from repro.configs.registry import ShapeSpec, get_smoke_config
    from repro.models.transformer import init_caches, init_params
    from repro.optim.adamw import AdamWConfig, init_opt_state
    from repro.parallel import steps as steps_lib
    from repro.parallel.sharding import axis_rules, cache_pspecs, param_pspecs

    (workdir, archs, meshes, with_f32, C, S, n_dec, B, T,
     lr) = json.loads(sys.argv[1])
    AT = jax.sharding.AxisType
    opt = AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)
    dtypes = {}

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def save(name, tree):
        flat = {key(p): x for p, x in jax.tree_util.tree_leaves_with_path(
            tree)}
        dtypes[name] = {k: str(x.dtype) for k, x in flat.items()}
        np.savez(os.path.join(workdir, name + ".npz"),
                 **{k: np.asarray(x.astype(jnp.float32)
                                  if jnp.issubdtype(x.dtype, jnp.floating)
                                  else x) for k, x in flat.items()})

    def put(mesh, tree, specs):
        return jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), tree, specs)

    real_rules = steps_lib._mode_rules

    def rules_without_unit_axes(cfg, shape):
        r = real_rules(cfg, shape)
        sizes = compat.get_abstract_mesh().shape
        return dict(r, seq_kv=tuple(a for a in r["seq_kv"] if sizes[a] > 1))

    def serve(cfg, params, dtype, mesh=None):
        rng = np.random.default_rng(0)   # as _torch_ranks.serve_inputs
        prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        toks = rng.integers(0, cfg.vocab, (n_dec, B, 1)).astype(np.int32)
        pre = ShapeSpec("p", S, B, "prefill")
        dec = ShapeSpec("d", C, B, "decode")
        caches = init_caches(cfg, B, C, dtype)
        if mesh is not None:
            rules = steps_lib._mode_rules(cfg, pre)
            params = put(mesh, params, param_pspecs(params))
            with axis_rules(**rules):
                caches = put(mesh, caches, cache_pspecs(caches))
        lg, caches = jax.jit(steps_lib.make_prefill_step(cfg, pre))(
            params, {"tokens": jnp.asarray(prompt)}, caches)
        logits = [lg]
        step = jax.jit(steps_lib.make_decode_step(cfg, dec))
        for t in range(n_dec):
            lg, caches = step(params, jnp.asarray(toks[t]),
                              jnp.full((B, 1), S + t, jnp.int32), caches)
            logits.append(lg)
        return jnp.stack(logits), caches

    def train(cfg, params, dtype, mesh=None, dims=None):
        shape = ShapeSpec("t", T, B, "train")
        rng = np.random.default_rng(0)   # as _torch_ranks.batch_np
        batch = {k: jnp.asarray(rng.integers(0, cfg.vocab, (B, T)),
                                jnp.int32) for k in ("tokens", "labels")}
        state = steps_lib.TrainState(params, init_opt_state(params), {})
        if dims is None:
            sc = steps_lib.default_step_config(cfg, shape, dp=1, fsdp=False,
                                               param_dtype=dtype)
        else:
            sc = steps_lib.default_step_config(cfg, shape, dp=dims[0],
                                               fsdp=True, param_dtype=dtype)
            specs = steps_lib.train_state_pspecs(state, sc)
            fl, tdef = jax.tree_util.tree_flatten(state)
            state = tdef.unflatten([
                jax.device_put(x, NamedSharding(mesh, s))
                for x, s in zip(fl, tdef.flatten_up_to(specs))])
        st, m = jax.jit(steps_lib.make_train_step(cfg, shape, sc, opt))(
            state, batch)
        return {"params": st.params, "mu": st.opt.mu, "nu": st.opt.nu,
                "master": st.opt.master}, {k: float(v) for k, v in m.items()}

    metrics = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        init = np.load(os.path.join(workdir, arch + ".npz"))
        proto = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0),
                                                   cfg, jnp.bfloat16))
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(init[key(p)], x.dtype), proto)
        if with_f32:
            p32 = jax.tree.map(lambda x: x.astype(jnp.float32), params)
            logits, caches = serve(cfg, p32, jnp.float32)
            save(f"{arch}_f32_serve_logits", {"l": logits})
            save(f"{arch}_f32_serve_caches", caches)
            trees, metrics[f"{arch}_f32"] = train(cfg, p32, jnp.float32)
            for f, tree in trees.items():
                save(f"{arch}_f32_train_{f}", tree)
        for dims in meshes:
            mesh = jax.make_mesh(tuple(dims), ("data", "model"),
                                 axis_types=(AT.Auto,) * 2,
                                 devices=jax.devices()[:4])
            name = f"{arch}_{dims[0]}x{dims[1]}"
            steps_lib._mode_rules = (rules_without_unit_axes if 1 in dims
                                     else real_rules)
            with compat.set_mesh(mesh):
                logits, caches = serve(cfg, params, jnp.bfloat16, mesh)
            steps_lib._mode_rules = real_rules
            save(name + "_serve_logits", {"l": logits})
            save(name + "_serve_caches", caches)
            with compat.set_mesh(mesh):
                trees, metrics[name] = train(cfg, params, jnp.bfloat16, mesh,
                                             dims)
            for f, tree in trees.items():
                save(f"{name}_train_{f}", tree)
    print(json.dumps({"metrics": metrics, "dtypes": dtypes}))
""")

TRAIN_TREES = ("params", "mu", "nu", "master")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps (a subprocess) and the port's (four ranks), run at the
    same time from the same bf16 parameters."""
    work = tmp_path_factory.mktemp("mesh_bf16")
    for arch in ARCHS:
        p = init_params(torch.Generator().manual_seed(0),
                        get_smoke_config(arch), torch.bfloat16, "cpu")
        np.savez(work / f"{arch}.npz",
                 **{"/".join(str(k) for k in path): leaf.float().numpy()
                    for path, leaf in path_leaves(p)})
    jax_procs = [subprocess.Popen(  # one an (arch, mesh), side by side
        [sys.executable, "-c", _JAX_SCRIPT,
         json.dumps([str(work), [arch], [dims], dims == MESHES[0], C, S,
                     N_DECODE, B, T, LR])],
        env={**os.environ, "PYTHONPATH": str(ranks.SRC),
             "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in ARCHS for dims in MESHES]
    info = {"metrics": {}, "dtypes": {}}
    try:
        port = ranks.launch("mesh_bf16", 4, work / "port", timeout=600,
                            archs=ARCHS, meshes=MESHES, C=C, S=S,
                            n_decode=N_DECODE, B=B, T=T, lr=LR)
        for proc in jax_procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            for k, v in json.loads(out.strip().splitlines()[-1]).items():
                info[k].update(v)
    finally:
        for proc in jax_procs:
            if proc.poll() is None:
                proc.kill()

    def load(name):
        return dict(np.load(work / f"{name}.npz")), info["dtypes"][name]

    return load, info["metrics"], port


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _rel_gap(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _leaf_l2(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _dtype(t) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(
        t.numpy().dtype)


def _check_serve(got, want, f32, what):
    """``got`` the port's (logits, caches), ``want`` the reference's
    bf16 run and ``f32`` JAX's f32 run, each as ``(leaves, dtypes)``
    (dtypes None for a port run held to another port run)."""
    (g_out, g_cache), (w_logits, w_caches) = got, want
    w_l = w_logits[0]["l"]
    assert len(g_out["logits"]) == len(w_l) == N_DECODE + 1
    for t, (a, b) in enumerate(zip(g_out["logits"], w_l)):
        assert _rel_gap(a, b) <= LOGIT_TOL, (what, "logits", t)
    leaves, dtypes = w_caches
    yard = max([_rel_gap(leaves[k], f32[k]) for k in leaves
                if dtypes[k] == "float32"], default=0.0)
    assert set(g_cache) == set(leaves), what
    for k, w in leaves.items():
        g = g_cache[k]
        assert _dtype(g) == dtypes[k], (what, k, _dtype(g), dtypes[k])
        if dtypes[k] == "bfloat16":
            assert _rel_gap(g, w) <= KV_TOL, (what, k)
        elif dtypes[k] == "float32":
            assert _rel_gap(g, w) <= YARD * yard, (what, k, yard)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {k}")


def _check_train(got, want, metrics, f32, what):
    """The train step's rules of `tests/test_torch_train_bf16.py`."""
    def rel(k):
        return (abs(got["metrics"][k] - metrics[k])
                / max(abs(metrics[k]), 1e-30))

    for k in ("loss", "ce", "lb_loss", "router_z"):
        assert rel(k) <= METRIC_TOL, (what, k, got["metrics"][k],
                                      metrics[k])
    assert got["metrics"]["tokens"] == metrics["tokens"]
    params, p_dtypes = want["params"]
    for k, w in got["params"].items():
        assert _dtype(w) == p_dtypes[k], (what, k)
        assert _dtype(got["master"][k]) == "float32"
    for f in ("mu", "nu"):
        leaves, _ = want[f]
        yard = max(_leaf_l2(leaves[k], f32[f][0][k]) for k in leaves)
        for k, w in leaves.items():
            assert _leaf_l2(got[f][k], w) <= YARD * yard, (what, f, k)
        if f == "mu":  # |‖a‖ − ‖b‖| ≤ ‖a − b‖: the norm within the same
            assert rel("grad_norm") <= YARD * yard, (what, yard)
    flips = own = 0
    master, _ = want["master"]
    for k, w in master.items():
        gap = np.abs(_np(got["master"][k]) - _np(w))
        assert gap.max() <= 2 * LR * (1 + 1e-3), (what, k, gap.max())
        if not k.endswith(ZERO_GRAD_LEAVES):
            flips += int((gap > LR / 2).sum())
            own += int((np.abs(_np(f32["master"][0][k]) - _np(w))
                        > LR / 2).sum())
    assert flips <= YARD * own, (what, flips, own)


def _ids(d):
    return f"{d[0]}x{d[1]}"


@pytest.mark.parametrize("dims", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_serve_steps_bf16_match_jax_mesh_steps(runs, arch, dims):
    """The port's meshed bf16 prefill and decode steps against JAX's on
    the same mesh shape: every step's logits, the final caches."""
    load, _, port = runs
    name = f"{arch}_{dims[0]}x{dims[1]}"
    f32, _ = load(f"{arch}_f32_serve_caches")
    _check_serve(port[f"{arch}/{_ids(dims)}/serve/mesh"],
                 (load(name + "_serve_logits"), load(name + "_serve_caches")),
                 f32, f"port mesh vs JAX mesh {name}")


@pytest.mark.parametrize("dims", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_serve_steps_bf16_match_single_device(runs, arch, dims):
    """The port's meshed bf16 serve steps against its one-device bf16
    steps, at the tolerances of the reference (JAX's f32 run the
    yardstick), every leaf of the same dtype."""
    load, _, port = runs
    key = f"{arch}/{_ids(dims)}/serve"
    single_logits, single_caches = port[key + "/single"]
    f32, _ = load(f"{arch}_f32_serve_caches")
    dtypes = {k: _dtype(v) for k, v in single_caches.items()}
    want = ({"l": [_np(x) for x in single_logits["logits"]]}, None), (
        {k: _np(v) if dtypes[k] in ("bfloat16", "float32") else v.numpy()
         for k, v in single_caches.items()}, dtypes)
    _check_serve(port[key + "/mesh"], want, f32,
                 f"port mesh vs single {key}")


@pytest.mark.parametrize("dims", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_train_step_bf16_matches_jax_mesh_step(runs, arch, dims):
    """The port's meshed bf16 train step (FSDP, the f32 master) against
    JAX's on the same mesh shape."""
    load, metrics, port = runs
    name = f"{arch}_{dims[0]}x{dims[1]}"
    f32 = {f: load(f"{arch}_f32_train_{f}") for f in TRAIN_TREES}
    want = {f: load(f"{name}_train_{f}") for f in TRAIN_TREES}
    _check_train(port[f"{arch}/{_ids(dims)}/train/mesh"], want,
                 metrics[name], f32, f"port mesh vs JAX mesh {name}")


@pytest.mark.parametrize("dims", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_train_step_bf16_matches_single_device(runs, arch, dims):
    """The port's meshed bf16 train step against its one-device bf16
    step at the mesh's dispatch groups."""
    load, metrics, port = runs
    key = f"{arch}/{_ids(dims)}/train"
    single = port[key + "/single"]
    f32 = {f: load(f"{arch}_f32_train_{f}") for f in TRAIN_TREES}
    want = {f: ({k: _np(v) for k, v in single[f].items()},
                {k: _dtype(v) for k, v in single[f].items()})
            for f in TRAIN_TREES}
    _check_train(port[key + "/mesh"], want, single["metrics"], f32,
                 f"port mesh vs single {key}")
