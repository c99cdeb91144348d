"""The port's int8 error-feedback pod exchange (`repro_torch.optim.
compression`) and the compressed train step against the reference.

* one shard: the reference's two tests of ``compress_psum``
  (`tests/test_substrates.py`) on a world of one rank;
* two gloo ranks against JAX's ``shard_map`` version over a two-device
  ``pod`` mesh, a different gradient and residual on each shard, at 1000
  and 4096 values and across a block boundary: ``g_mean`` and the
  residual bit-equal (the port sums int32 where the reference sums int16
  — the same integers);
* the compressed step on (pod 2, data 2, model 1), 3 steps, against an
  oracle composed of the reference's pieces — each pod's f32 gradients
  from ``jax.value_and_grad`` of ``train_loss`` on its half of the batch,
  JAX's ``compress_psum`` over a two-device pod mesh, JAX's
  ``adamw_update`` — since the reference's own compressed step raises on
  jax 0.9 (pinned below on both sides);
* which batch rows each rank holds under the (pod, data) batch rule,
  against JAX's ``NamedSharding`` on the same mesh.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_ranks as ranks
from repro_torch.checkpoint.manager import path_leaves
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.transformer import init_params
from repro_torch.optim.compression import BLOCK, compress_psum, init_residuals

ARCH = "qwen2-0.5b"
B, S, LR, STEPS = 8, 32, 1e-3, 3
CASES = {"n1000": 1000, "n4096": 4096, "n769": 3 * BLOCK + 1}

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P, NamedSharding
    from repro import compat
    from repro.configs.registry import ShapeSpec, get_smoke_config
    from repro.models.transformer import train_loss
    from repro.optim.adamw import AdamWConfig, adamw_update, init_opt_state
    from repro.optim.compression import compress_psum
    from repro.parallel import steps as steps_lib

    workdir, arch, B, S, lr, n_steps = json.loads(sys.argv[1])
    AT = jax.sharding.AxisType
    devs = jax.devices()
    pod = jax.make_mesh((2,), ("pod",), axis_types=(AT.Auto,),
                        devices=devs[:2])
    out = {}

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    # -- the exchange: shard i takes row i of the stacked inputs
    @jax.jit
    def exchange(g2, r2):
        def body(g, r):
            gm, nr = compress_psum(g[0], r[0], "pod", 2)
            return gm[None], nr[None]
        return compat.shard_map(body, mesh=pod, in_specs=(P("pod"), P("pod")),
                                out_specs=(P("pod"), P("pod")),
                                axis_names={"pod"})(g2, r2)

    ex = np.load(os.path.join(workdir, "exchange.npz"))
    res = {}
    for case in sorted({k.split(":")[0] for k in ex}):
        gm, nr = exchange(jnp.asarray(ex[case + ":g"]),
                          jnp.asarray(ex[case + ":r"]))
        res[case + ":gm"], res[case + ":r"] = np.asarray(gm), np.asarray(nr)
    np.savez(os.path.join(workdir, "exchange_jax.npz"), **res)

    # -- the compressed step's oracle, from the reference's pieces
    cfg = get_smoke_config(arch)
    init = np.load(os.path.join(workdir, "init.npz"))
    sc = steps_lib.default_step_config(cfg, ShapeSpec("t", S, B, "train"),
                                       dp=1, param_dtype=jnp.float32,
                                       fsdp=False)
    proto = jax.eval_shape(lambda: steps_lib.make_train_state(
        jax.random.PRNGKey(0), cfg, sc))
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(init[key(p)]), proto.params)
    opt_state = init_opt_state(params)
    opt = AdamWConfig(lr=lr, warmup_steps=1, total_steps=10)

    @jax.jit
    def pod_grads(params, batch):
        (loss, m), g = jax.value_and_grad(
            lambda p: train_loss(p, cfg, batch, remat="full"),
            has_aux=True)(params)
        return jax.tree.map(lambda x: x.astype(jnp.float32), g), dict(
            m, loss=loss)

    res2 = jax.tree.map(lambda p: jnp.zeros((2,) + p.shape, jnp.float32),
                        params)
    hist = []
    for t in range(n_steps):
        rng = np.random.default_rng(t)
        full = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        per = [pod_grads(params, {k: jnp.asarray(v[i * B // 2:
                                                   (i + 1) * B // 2])
                                  for k, v in full.items()})
               for i in range(2)]
        g2 = jax.tree.map(lambda a, b: jnp.stack([a, b]), per[0][0],
                          per[1][0])
        both = jax.tree.map(exchange, g2, res2)
        g_mean = jax.tree.map(lambda x: x[0][0], both,
                              is_leaf=lambda x: isinstance(x, tuple))
        res2 = jax.tree.map(lambda x: x[1], both,
                            is_leaf=lambda x: isinstance(x, tuple))
        metrics = {k: (float(per[0][1][k]) + float(per[1][1][k])) / 2
                   for k in per[0][1]}
        params, opt_state, om = adamw_update(opt, g_mean, opt_state,
                                             jnp.float32)
        metrics.update({k: float(v) for k, v in om.items()})
        hist.append(metrics)
    np.savez(os.path.join(workdir, "oracle_params.npz"),
             **{key(p): np.asarray(x) for p, x in
                jax.tree_util.tree_leaves_with_path(params)})
    np.savez(os.path.join(workdir, "oracle_res.npz"),
             **{key(p): np.asarray(x) for p, x in
                jax.tree_util.tree_leaves_with_path(res2)})
    out["oracle"] = hist

    # -- which rows each device holds under P(("pod", "data"))
    mesh3 = jax.sharding.Mesh(np.array(devs[:4]).reshape(2, 2, 1),
                              ("pod", "data", "model"))
    x = jax.device_put(jnp.arange(B), NamedSharding(mesh3, P(("pod", "data"))))
    pos = {d.id: [int(i) for i in np.argwhere(mesh3.devices == d)[0]]
           for d in devs[:4]}
    out["rows"] = sorted([pos[s.device.id], np.asarray(s.data).tolist()]
                         for s in x.addressable_shards)

    # -- the reference's compressed step on (pod 2, data 1, model 2)
    mesh = jax.make_mesh((2, 1, 2), ("pod", "data", "model"),
                         axis_types=(AT.Auto,) * 3, devices=devs[:4])
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (B, S)),
                                   jnp.int32),
             "labels": jnp.asarray(rng.integers(0, cfg.vocab, (B, S)),
                                   jnp.int32)}
    try:
        with compat.set_mesh(mesh):
            scc = steps_lib.default_step_config(
                cfg, ShapeSpec("t", S, B, "train"), dp=2,
                param_dtype=jnp.float32, compress_pods=True)
            st = steps_lib.make_train_state(jax.random.PRNGKey(0), cfg, scc)
            jax.jit(steps_lib.make_train_step(
                cfg, ShapeSpec("t", S, B, "train"), scc))(st, batch)
        out["fault"] = None
    except Exception as e:
        out["fault"] = [type(e).__name__, str(e)[:2000]]
    print(json.dumps(out))
""")


def _np_tree(tree) -> dict:
    return {"/".join(str(k) for k in p): leaf.detach().numpy()
            for p, leaf in path_leaves(tree)}


def _exchange_inputs() -> dict:
    """Per case, each shard's (gradient, residual): different normals on
    each shard, a small residual."""
    rng = np.random.default_rng(7)
    return {case: [(rng.normal(size=(n,)).astype(np.float32) * (1 + i),
                    (rng.normal(size=(n,)) * 0.01).astype(np.float32))
                   for i in range(2)] for case, n in CASES.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's exchange, oracle and reference fault (one subprocess) and the
    port's exchange (two ranks) and compressed steps (four ranks), run at
    the same time."""
    work = tmp_path_factory.mktemp("compression")
    inputs = _exchange_inputs()
    np.savez(work / "exchange.npz",
             **{f"{c}:{w}": np.stack([s[j] for s in per])
                for c, per in inputs.items()
                for j, w in enumerate(("g", "r"))})
    torch.save(inputs, work / "exchange_in.pt")
    params = init_params(torch.Generator().manual_seed(0),
                         get_smoke_config(ARCH), torch.float32, "cpu")
    np.savez(work / "init.npz", **_np_tree(params))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT,
         json.dumps([str(work), ARCH, B, S, LR, STEPS])],
        env={**os.environ, "PYTHONPATH": str(ranks.SRC),
             "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port_ex = ranks.launch("compress_exchange", 2, work / "ex",
                               timeout=300,
                               inputs=str(work / "exchange_in.pt"))
        port_step = ranks.launch("compressed_train", 4, work / "step",
                                 timeout=400, arch=ARCH, B=B, S=S, lr=LR,
                                 steps=STEPS, dims=[2, 2, 1],
                                 fault_dims=[2, 1, 2])
        out, err = jax_proc.communicate(timeout=400)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-4000:]
    jax_out = json.loads(out.strip().splitlines()[-1])
    jax_out["exchange"] = dict(np.load(work / "exchange_jax.npz"))
    jax_out["params"] = dict(np.load(work / "oracle_params.npz"))
    jax_out["residuals"] = dict(np.load(work / "oracle_res.npz"))
    return jax_out, port_ex, port_step


# ------------------------------------------------------------ one shard ----


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo world in this process (a file store in tmp_path)."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_compression_ef_residual_correctness(world_of_one):
    """One shard: g_mean + residual reconstructs g, and the residual is
    at most one quantization step (blockmax/127)."""
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(1000,)),
                        dtype=torch.float32)
    out, res = compress_psum(g, torch.zeros_like(g), world_of_one, 1)
    np.testing.assert_allclose((out + res).numpy(), g.numpy(), atol=1e-5)
    assert float(res.abs().max()) <= float(g.abs().max()) / 127.0 + 1e-6


def test_compression_unbiased_over_time(world_of_one):
    """Error feedback: Σ_t compressed_t ≈ Σ_t g_t (noise does not
    accumulate)."""
    rng = np.random.default_rng(1)
    r = torch.zeros(512)
    total_true = np.zeros(512)
    total_comp = np.zeros(512)
    for t in range(30):
        g = torch.as_tensor(rng.normal(size=(512,)) * (1 + t % 3),
                            dtype=torch.float32)
        out, r = compress_psum(g, r, world_of_one, 1)
        total_true += g.numpy()
        total_comp += out.numpy()
    assert (np.max(np.abs(total_true - total_comp))
            < np.abs(total_true).max() * 0.02 + 0.1)


def test_init_residuals_shapes():
    """Zero f32 residuals like the parameters; one a pod behind a leading
    pod axis."""
    p = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": [torch.ones(5)]}
    r = init_residuals(p)
    assert r["a"].shape == (3, 4) and r["a"].dtype == torch.float32
    assert init_residuals(p, 2)["b"][0].shape == (2, 5)
    assert float(init_residuals(p, 2)["a"].abs().sum()) == 0.0


# ----------------------------------------------------------- two shards ----


@pytest.mark.parametrize("case", list(CASES))
def test_exchange_bit_equal_to_jax(runs, case):
    """Two gloo ranks vs JAX's two-shard ``shard_map``: every shard's
    ``g_mean`` and residual bit-equal."""
    jax_out, port_ex, _ = runs
    jg, jr = jax_out["exchange"][case + ":gm"], jax_out["exchange"][case + ":r"]
    for i in range(2):
        gm, nr = port_ex[case][i]
        np.testing.assert_array_equal(gm, jg[i], err_msg=f"g_mean {i}")
        np.testing.assert_array_equal(nr, jr[i], err_msg=f"residual {i}")
    # both shards end with the same mean, and their own residuals
    np.testing.assert_array_equal(port_ex[case][0][0], port_ex[case][1][0])


# ------------------------------------------------------- compressed step ----


@pytest.mark.parametrize("t", range(STEPS))
def test_compressed_step_matches_oracle_metrics(runs, t):
    """Each step's metrics (pod-averaged) within 1e-5 of the oracle."""
    jax_out, _, port = runs
    for k, v in jax_out["oracle"][t].items():
        np.testing.assert_allclose(port["metrics"][t][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_compressed_step_matches_oracle_state(runs):
    """After 3 steps: the parameters within one Adam step of the oracle's;
    each pod's residual within 1e-6 wherever both sides rounded the
    quantized value alike.  Each pod's gradient agrees with JAX's only to
    f32 rounding, so where ``x/scale`` lies that close to a half-integer
    the two round ``q`` apart by one: that element's residual (and mean)
    then differ by one quantization step — at most twice the leaf's
    largest residual, since a residual is at most half a step.  A small
    leaf with a small gradient sees more ties (qwen2's value bias: 10 of
    128); over the model they are 0.2% of the elements."""
    jax_out, _, port = runs
    assert set(port["params"]) == set(jax_out["params"])
    for k, w in jax_out["params"].items():
        np.testing.assert_allclose(port["params"][k].numpy(), w, rtol=0,
                                   atol=LR, err_msg=k)
    n_tie = n_all = 0
    for k, w in jax_out["residuals"].items():
        got = port["residuals"][k].numpy()
        assert got.shape == w.shape == (2,) + port["params"][k].shape
        diff = np.abs(got - w)
        n_tie += int((diff > 1e-6).sum())
        n_all += diff.size
        assert (diff > 1e-6).mean() < 0.1, (k, int((diff > 1e-6).sum()))
        for p in range(2):
            bound = 2.0 * np.abs(w[p]).max() * (1 + 1e-5) + 1e-6
            assert diff[p].max() <= bound, (k, p, diff[p].max(), bound)
    assert n_tie < 5e-3 * n_all, (n_tie, n_all)


def test_batch_rows_per_rank_match_jax(runs):
    """Two mesh axes on the batch dimension, ("pod", "data"): each rank
    holds the rows JAX's ``NamedSharding`` gives the device at its mesh
    position (pod major)."""
    jax_out, _, port = runs
    got = sorted([list(c), rows] for c, rows in port["rows"])
    assert got == jax_out["rows"]


def test_reference_compressed_step_fault_pinned(runs):
    """The reference's compressed step raises on jax 0.9: inside its
    ``shard_map`` manual over "pod", ``_mode_rules`` still maps ``batch``
    to ("pod", "data"), so the model's first constraint names the manual
    axis.  The port runs each pod on its (data, model) sub-mesh, where the
    missing "pod" axis drops out of the rule: its step on the same
    (pod 2, data 1, model 2) mesh gives a finite loss."""
    jax_out, _, port = runs
    assert jax_out["fault"] is not None
    name, msg = jax_out["fault"]
    assert name == "ValueError" and "Auto" in msg, jax_out["fault"]
    assert np.isfinite(port["fault_mesh_loss"])
