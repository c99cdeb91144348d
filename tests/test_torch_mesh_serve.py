"""The port's meshed serve steps (`repro_torch.parallel.steps`
``make_prefill_step`` / ``make_decode_step`` under a `DeviceMesh`) against
JAX's meshed steps and against the port's single-device steps.

Four gloo ranks on the CPU (`_torch_ranks.mesh_serve`, a subprocess with
its own timeout) run, for each arch, a prefill of S = 60 tokens into
caches of capacity 64, then 6 decode steps, so that every ring wraps and
the shard that owns the written slot changes, on (data 2, model 2) at
batch 4 (the sequence over ``model``), (data 2, model 2) at batch 1 (the
sequence over ``data`` + ``model``) and (data 1, model 4) at batch 4.  The
prefill's flash kernel runs on each rank's (batch, heads) shard, the
decode kernel on each rank's rows of the sequence-sharded cache, merged
by log-sum-exp.  JAX runs the same steps from the same parameters
(carried across as arrays) on forced-device meshes of the same shapes
with ``Auto`` axes, in one subprocess for all archs, at the same time as
the ranks (on the (1, 4) mesh with the size-1 ``data`` dropped from the
``seq_kv`` rule, without which the reference's cache spec names ``data``
twice and JAX refuses it: ROADMAP queue 3).  Logits and float cache
leaves must agree within 1e-5 (absolute); ``pos`` and ``ptr`` bit for
bit.

The single-device steps the mesh is held to group a MoE's tokens as the
mesh does (G = data ranks).  The JAX side also runs the reference's
owning-shard ring write (``ring_write=True``), which its decode never
calls, against its one-hot write, and its steps on a mesh with
``jax.make_mesh``'s default ``Explicit`` axes and, unpatched, on (1, 4):
both raise (ROADMAP queue 3)."""

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

ARCHS = ("qwen2-0.5b", "deepseek-moe-16b", "recurrentgemma-9b", "gemma3-1b",
         "xlstm-350m")
CASES = (((2, 2), 4), ((2, 2), 1), ((1, 4), 4))
C, S, N_DECODE = 64, 60, 6
TOL = 1e-5

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat
    from repro.configs.registry import ShapeSpec, get_smoke_config
    from repro.models.cache import kv_cache_append
    from repro.models.transformer import init_caches, init_params
    from repro.parallel import steps as steps_lib
    from repro.parallel.sharding import axis_rules, cache_pspecs, param_pspecs

    workdir, archs, cases, C, S, n_dec = json.loads(sys.argv[1])
    AT = jax.sharding.AxisType

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def flat(tree):
        return {key(p): np.asarray(x) for p, x in
                jax.tree_util.tree_leaves_with_path(tree)}

    def put(mesh, tree, specs):
        return jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), tree, specs)

    def inputs(vocab, B):  # as _torch_ranks.serve_inputs
        rng = np.random.default_rng(0)
        return (rng.integers(0, vocab, (B, S)).astype(np.int32),
                rng.integers(0, vocab, (n_dec, B, 1)).astype(np.int32))

    def attn_caches(tree):
        if isinstance(tree, dict):
            if "k" in tree:
                return [tree]
            return [c for k in sorted(tree) for c in attn_caches(tree[k])]
        if isinstance(tree, list):
            return [c for v in tree for c in attn_caches(v)]
        return []

    def ring_write_equal(caches, rules, B):
        # the reference's owning-shard write against its one-hot write,
        # on every attention cache (a stacked one: its first unit)
        ok = True
        for c in attn_caches(caches):
            if c["k"].ndim == 5:
                c = {n: x[0] for n, x in c.items()}
            kv = jnp.full((B, 1) + c["k"].shape[2:], 0.5, c["k"].dtype)
            pos = jnp.full((B, 1), 999, jnp.int32)

            def app(cc, rw):
                with axis_rules(**rules):
                    return kv_cache_append(cc, kv, kv, pos, ring_write=rw)

            a = jax.jit(lambda cc: app(cc, False))(c)
            b = jax.jit(lambda cc: app(cc, True))(c)
            ok &= all(bool(jnp.array_equal(a[n], b[n])) for n in a)
        return ok

    # The reference's rules give a mesh whose data axis is 1 the cache
    # spec (batch "data", seq_kv ("data", "model")), which names "data"
    # twice and which JAX refuses (ROADMAP queue 3).  On such a mesh the
    # script drops the size-1 axis from seq_kv, as the port's placements
    # do (an axis of size 1 splits nothing); the unpatched step's error
    # is recorded below.
    real_rules = steps_lib._mode_rules

    def rules_without_unit_axes(cfg, shape):
        r = real_rules(cfg, shape)
        sizes = compat.get_abstract_mesh().shape
        return dict(r, seq_kv=tuple(a for a in r["seq_kv"] if sizes[a] > 1))

    def serve(cfg, params, mesh, dims, B):
        prompt, toks = inputs(cfg.vocab, B)
        pre = ShapeSpec("p", S, B, "prefill")
        dec = ShapeSpec("d", C, B, "decode")
        with compat.set_mesh(mesh):
            rules = steps_lib._mode_rules(cfg, pre)
            p = put(mesh, params, param_pspecs(params))
            caches = init_caches(cfg, B, C, jnp.float32)
            with axis_rules(**rules):
                caches = put(mesh, caches, cache_pspecs(caches))
            lg, caches = jax.jit(steps_lib.make_prefill_step(cfg, pre))(
                p, {"tokens": jnp.asarray(prompt)}, caches)
            logits = [np.asarray(lg)]
            step = jax.jit(steps_lib.make_decode_step(cfg, dec))
            for t in range(n_dec):
                lg, caches = step(p, jnp.asarray(toks[t]),
                                  jnp.full((B, 1), S + t, jnp.int32), caches)
                logits.append(np.asarray(lg))
            ring = ring_write_equal(caches, steps_lib._mode_rules(cfg, dec),
                                    B)
        return logits, caches, ring

    def fault(fn):
        try:
            fn()
            return {"error": None}
        except Exception as e:
            return {"error": type(e).__name__, "message": str(e)[:400]}

    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        init = np.load(os.path.join(workdir, arch + ".npz"))
        proto = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0),
                                                   cfg, jnp.float32))
        params = jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(init[key(p)]), proto)
        for dims, B in cases:
            mesh = jax.make_mesh(tuple(dims), ("data", "model"),
                                 axis_types=(AT.Auto,) * 2,
                                 devices=jax.devices()[:4])
            steps_lib._mode_rules = (rules_without_unit_axes if 1 in dims
                                     else real_rules)
            logits, caches, ring = serve(cfg, params, mesh, dims, B)
            steps_lib._mode_rules = real_rules
            name = f"{arch}_{dims[0]}x{dims[1]}_b{B}"
            np.save(os.path.join(workdir, name + "_logits.npy"),
                    np.stack(logits))
            np.savez(os.path.join(workdir, name + "_caches.npz"),
                     **flat(caches))
            out[name] = {"ring_write_equal": ring}
    # how P(None, ("data", "model")) cuts 8 columns over a (2, 2) mesh
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AT.Auto,) * 2, devices=jax.devices()[:4])
    idx = NamedSharding(mesh, P(None, ("data", "model"))).devices_indices_map(
        (2, 8))
    out["rows"] = [[int(d), int(m), idx[mesh.devices[d, m]][1].start]
                   for d in range(2) for m in range(2)]
    # the reference's steps on jax.make_mesh's default (Explicit) axes,
    # and on a data axis of 1 unpatched
    cfg = get_smoke_config(archs[0])
    params = init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    out["explicit"] = dict(fault(lambda: serve(cfg, params, mesh, (2, 2),
                                               4)),
                           axis_types=str(mesh.axis_types))
    mesh = jax.make_mesh((1, 4), ("data", "model"),
                         axis_types=(AT.Auto,) * 2, devices=jax.devices()[:4])
    out["unit_data_axis"] = fault(lambda: serve(cfg, params, mesh, (1, 4),
                                                4))
    print(json.dumps(out))
""")


def _name(arch, dims, B) -> str:
    return f"{arch}_{dims[0]}x{dims[1]}_b{B}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's meshed steps (a subprocess) and the port's (four ranks), run
    at the same time from the same parameters."""
    work = tmp_path_factory.mktemp("mesh_serve")
    for arch in ARCHS:
        p = init_params(torch.Generator().manual_seed(0),
                        get_smoke_config(arch), torch.float32, "cpu")
        np.savez(work / f"{arch}.npz",
                 **{"/".join(str(k) for k in path): leaf.numpy()
                    for path, leaf in path_leaves(p)})
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT,
         json.dumps([str(work), ARCHS, CASES, C, S, N_DECODE])],
        env={**os.environ, "PYTHONPATH": str(ranks.SRC),
             "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = ranks.launch("mesh_serve", 4, work / "port", timeout=600,
                            archs=ARCHS, cases=CASES, C=C, S=S,
                            n_decode=N_DECODE)
        out, err = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-4000:]
    info = json.loads(out.strip().splitlines()[-1])
    jax_res = {}
    for arch in ARCHS:
        for dims, B in CASES:
            name = _name(arch, dims, B)
            jax_res[name] = (
                {"logits": list(np.load(work / f"{name}_logits.npy"))},
                dict(np.load(work / f"{name}_caches.npz")))
    return jax_res, port, info


def _close(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=what)


def _check(got, want, what: str) -> None:
    (g_out, g_cache), (w_out, w_cache) = got, want
    assert len(g_out["logits"]) == len(w_out["logits"]) == N_DECODE + 1
    for t, (a, b) in enumerate(zip(g_out["logits"], w_out["logits"])):
        _close(a, b, f"{what}: logits of step {t}")
    assert set(g_cache) == set(w_cache), what
    for k, w in w_cache.items():
        _close(g_cache[k], w, f"{what}: cache {k}")


@pytest.mark.parametrize("dims,B", CASES,
                         ids=lambda c: "x".join(map(str, c))
                         if isinstance(c, tuple) else f"b{c}")
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_serve_steps_match_jax_mesh_steps(runs, arch, dims, B):
    """The port's meshed prefill and decode steps against JAX's on the
    same mesh shape: every step's logits, the final caches."""
    jax_res, port, _ = runs
    key = f"{arch}/{dims[0]}x{dims[1]}/b{B}"
    _check(port[key + "/mesh"], jax_res[_name(arch, dims, B)],
           f"port mesh vs JAX mesh {key}")


@pytest.mark.parametrize("dims,B", CASES,
                         ids=lambda c: "x".join(map(str, c))
                         if isinstance(c, tuple) else f"b{c}")
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_serve_steps_match_single_device(runs, arch, dims, B):
    """The port's meshed steps against its single-device steps at the
    mesh's MoE dispatch groups: the shards' kernels and the log-sum-exp
    merge move no number past 1e-5, and the owning-shard ring write
    leaves the cache the single-device write leaves."""
    _, port, _ = runs
    key = f"{arch}/{dims[0]}x{dims[1]}/b{B}"
    _check(port[key + "/mesh"], port[key + "/single"],
           f"port mesh vs single {key}")


def test_reference_ring_write_equals_its_one_hot_write(runs):
    """JAX's owning-shard ring write (``ring_write=True``, a ``shard_map``
    manual over the sequence axes), which no reference path calls, leaves
    the cache its one-hot write leaves, on every attention cache of every
    case — the write the port's meshed decode reproduces."""
    _, _, info = runs
    for arch in ARCHS:
        for dims, B in CASES:
            assert info[_name(arch, dims, B)]["ring_write_equal"], (arch,
                                                                   dims, B)


def test_sequence_shards_are_data_major(runs):
    """DTensor's ``[Shard(1), Shard(1)]`` over (data, model) cuts the rows
    as JAX's ``P(None, ("data", "model"))``: data-major."""
    _, port, info = runs
    jax_start = {(d, m): start for d, m, start in info["rows"]}
    for (d, m), rows in port["rows"]:
        assert rows[0][0] == jax_start[(d, m)] == 2 * (2 * d + m)
        assert rows == [[r * 8 + jax_start[(d, m)] + i for i in range(2)]
                        for r in range(2)]


def test_reference_serve_steps_fault_on_a_data_axis_of_one(runs):
    """On a (data 1, model 4) mesh the reference's rules name ``data``
    twice in a cache spec — the batch rule takes the size-1 ``data`` and
    ``seq_kv`` becomes ``("data", "model")`` — and JAX refuses the spec
    (ROADMAP queue 3).  The port's placements leave a size-1 axis
    replicated, so its steps run there and match its single-device steps
    and JAX's with the size-1 axis dropped from ``seq_kv`` (the tests
    above)."""
    _, port, info = runs
    ex = info["unit_data_axis"]
    assert ex["error"] == "DuplicateSpecError", ex
    assert "duplicate entries for `data`" in ex["message"]
    key = f"{ARCHS[0]}/1x4/b4/mesh"
    assert all(np.isfinite(np.asarray(x)).all()
               for x in port[key][0]["logits"])


def test_reference_serve_steps_fault_on_explicit_axes(runs):
    """The reference's prefill step on a mesh of ``jax.make_mesh``'s
    default (``Explicit``) axes raises at the embedding gather on jax 0.9
    (ROADMAP queue 3); on ``Auto`` axes it runs, and the port's meshed
    step matches it (the tests above)."""
    _, port, info = runs
    ex = info["explicit"]
    assert "Explicit" in ex["axis_types"], ex
    assert ex["error"] == "ShardingTypeError", ex
    assert "gather" in ex["message"]
    key = f"{ARCHS[0]}/2x2/b4/mesh"
    assert all(np.isfinite(np.asarray(x)).all()
               for x in port[key][0]["logits"])
