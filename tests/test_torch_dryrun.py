"""The port's dry-run tools (`repro_torch.launch.dryrun`, `hlo_analysis`,
`recompute_roofline`) — the counterpart of
`tests/test_roofline_calibration.py`: the same three calibrations for the
torch counts, then the analytic pieces against the reference's.

  * per-device FLOPs: a sharded product on a fake 8 × 8 mesh counts one
    device's share exactly (2·n³/64);
  * loops: eager torch runs every iteration, so a 10-step loop counts 10
    bodies — the opposite of XLA, which counts a while body once;
  * collectives: a reshard records one all-gather on ``model`` whose ring
    bytes equal the reference parser's on XLA's HLO for the same reshard;

then the ring formulas on synthetic HLO lines, the analytic helpers on
every cell, the U ∈ {2, 4} reconstruction, one smoke cell of each step
kind on a fake (2, 2) mesh, `recompute` and import hygiene.

Anything that makes a process group runs in a subprocess (the torch
script below, with a ``fake`` group); the reference's dry run, whose
import reconfigures JAX, runs in another, with ``JAX_PLATFORMS=cpu``.
Both start together.  `repro.launch.hlo_analysis` (``re`` and numpy
only) is imported here."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.launch.hlo_analysis import analyze_collectives
from repro_torch.configs.registry import SHAPES, all_cells, get_config
from repro_torch.launch import dryrun, hlo_analysis, recompute_roofline
from repro_torch.launch.mesh import production_axes

ROOT = Path(__file__).resolve().parent.parent
N = 1024

_TORCH_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    import torch
    import torch.distributed as dist

    before = dict(os.environ)
    from repro_torch.launch import dryrun
    out = {"import_env_unchanged": dict(os.environ) == before,
           "import_started_group": dist.is_initialized()}
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.launch.hlo_analysis import DeviceCounter
    from repro_torch.launch.mesh import make_dev_mesh

    record_path, n = sys.argv[1], int(sys.argv[2])
    XLSTM_S = 80  # past dryrun.SEQ_POINTS

    # 2. loops: ten bodies, each counted
    a, b = torch.ones(256, 256), torch.ones(256, 256)
    with DeviceCounter() as c:
        for _ in range(10):
            a = a @ b
    out["loop_flops"] = c.flops

    # 2b. the xLSTM time loops under a count: every step dispatched
    from repro_torch.models import xlstm
    calls = {"mlstm": 0, "slstm": 0}
    for kind in calls:
        real = getattr(xlstm, f"_{kind}_step")
        def counted(*a, _real=real, _kind=kind, **k):
            calls[_kind] += 1
            return _real(*a, **k)
        setattr(xlstm, f"_{kind}_step", counted)
    xl = get_smoke_config("xlstm-350m")
    m, _ = dryrun.count_step(xl, ShapeSpec("t", 8, 2, "train"))
    out["xlstm_steps"] = {"calls": dict(calls), "flops": m["flops"],
                          "blocks": [b.kind for b in xl.blocks]}

    with dryrun.fake_world(64):
        mesh = make_dev_mesh(8, 8, device="cpu")
        with dryrun.fake_tensors():
            # 1. per-device flops of a sharded product
            x = distribute_tensor(torch.zeros(n, n), mesh,
                                  [Shard(0), Replicate()], src_data_rank=None)
            w = distribute_tensor(torch.zeros(n, n), mesh,
                                  [Replicate(), Shard(1)], src_data_rank=None)
            with DeviceCounter(mesh) as c:
                x @ w
            out["matmul_flops"] = c.flops
            # 3. a model-sharded tensor resharded to replicated on model
            t = distribute_tensor(torch.zeros(64, 64), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
            with DeviceCounter(mesh) as c:
                t.redistribute(mesh, [Shard(0), Replicate()])
            out["reshard"] = c.collectives.as_dict()
        # a collective the counter does not know raises
        try:
            with DeviceCounter(mesh):
                dist.broadcast(torch.zeros(4), 0, group=mesh.get_group(1))
            out["unknown_collective"] = None
        except NotImplementedError as e:
            out["unknown_collective"] = str(e)

    # 6 and 7. smoke cells on a fake (2, 2) mesh and on one device
    cfg = get_smoke_config("qwen2-0.5b")
    shapes = {"train": ShapeSpec("t", 32, 8, "train"),
              "prefill": ShapeSpec("p", 64, 4, "prefill"),
              "decode": ShapeSpec("d", 64, 4, "decode")}
    with dryrun.fake_world(4):
        mesh = make_dev_mesh(2, 2, device="cpu")
        for kind, shape in shapes.items():
            out[kind + "_mesh"] = dryrun.count_step(cfg, shape, mesh)[0]
            out[kind + "_one"] = dryrun.count_step(cfg, shape)[0]
        deep = dataclasses.replace(cfg, num_units=6)
        out["recon"], out["recon_how"] = dryrun.count_step(
            deep, shapes["prefill"], mesh)
        with dryrun.fake_tensors():
            from repro_torch.parallel import sharding
            with sharding.use_mesh(mesh):
                out["direct"] = dryrun._measure_analysis(
                    deep, shapes["prefill"], mesh)
        # 7b. a cell of time loops past the sequence points: extended
        # from two trip counts, and counted directly
        for kind in ("train", "prefill"):
            shape = ShapeSpec(kind, XLSTM_S, 4, kind)
            got, how = dryrun.count_step(xl, shape, mesh)
            with dryrun.fake_tensors(), sharding.use_mesh(mesh):
                direct, _ = dryrun.measure_units(xl, shape, mesh)
            out["seq_" + kind] = {"extended": got, "how": how,
                                  "direct": direct}

    # 8. a production record for recompute
    rec = dryrun.run_one("qwen2-0.5b", "decode_32k", "pod", "analysis")
    with open(record_path, "w") as f:
        json.dump(rec, f)
    out["group_after"] = dist.is_initialized()
    print(json.dumps(out))
""")

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=64"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.launch.hlo_analysis import analyze_collectives, analytic_hbm_bytes

    # the reshard of the reference's calibration (its backend now has 64
    # devices, before the dry run's import asks for 512), on Auto axes:
    # jax 0.9 makes Explicit ones, where the calibration's constraint
    # raises (that test's red, ROADMAP queue 3)
    mesh = jax.make_mesh((8, 8), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ns = lambda s: jax.sharding.NamedSharding(mesh, s)
    g = jax.jit(lambda a: jax.lax.with_sharding_constraint(a, ns(P("data", None))),
                in_shardings=ns(P("data", "model")),
                out_shardings=ns(P("data", None)))
    c3 = g.lower(jax.ShapeDtypeStruct((64, 64), jnp.float32)).compile()
    st = analyze_collectives(c3.as_text(), {"data": 8, "model": 8})
    out = {"reshard": {"wire": st.wire_bytes_per_chip, "ops": st.ops,
                       "by_kind": st.by_kind, "by_axis": st.by_axis}}

    from repro.configs.registry import SHAPES, all_cells, get_config
    from repro.launch.dryrun import attn_model_flops, model_flops, scan_flop_correction
    axes_sets = json.loads(sys.argv[1])
    cells = {}
    for arch, shape in all_cells():
        cfg, sh = get_config(arch), SHAPES[shape.name]
        cells[f"{arch}/{shape.name}"] = {
            "model_flops": model_flops(cfg, sh),
            "attn_model_flops": attn_model_flops(cfg, sh),
            "scan_flop_correction": scan_flop_correction(cfg, sh),
            "hbm": {name: analytic_hbm_bytes(cfg, sh, axes)
                    for name, axes in axes_sets.items()}}
    out["cells"] = cells
    print(json.dumps(out))
""")

AXES_SETS = {"v5e_pod": {"data": 16, "model": 16},
             "v5e_multipod": {"pod": 2, "data": 16, "model": 16},
             "h100_pod": production_axes(),
             "h100_multipod": production_axes(multi_pod=True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(torch side, reference side, record path): the two subprocesses,
    run at the same time."""
    tmp = tmp_path_factory.mktemp("dryrun")
    record = tmp / "record.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    kw = dict(cwd=ROOT, env=env, stdout=subprocess.PIPE,
              stderr=subprocess.PIPE, text=True)
    procs = [subprocess.Popen([sys.executable, "-c", _TORCH_SCRIPT,
                               str(record), str(N)], **kw),
             subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT,
                               json.dumps(AXES_SETS)], **kw)]
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, stderr[-4000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    return outs[0], outs[1], record


def test_per_device_flops_exact(runs):
    """1. A (1024, 1024) f32 product, x Shard(0) over data and w Shard(1)
    over model on a fake 8 × 8 mesh: one device's share, 2·n³/64, exactly
    (not the global 2·n³ that the DTensor-level op or the sharding
    propagator's shape inference would give)."""
    port, _, _ = runs
    assert port["matmul_flops"] == 2 * N ** 3 / 64


def test_loops_count_every_iteration(runs):
    """2. Ten steps of a loop count ten bodies.  XLA's cost analysis
    counts a while body once (the reference's calibration asserts < 1.2
    bodies); eager torch runs — and counts — each iteration."""
    port, _, _ = runs
    assert port["loop_flops"] == 10 * 2 * 256 ** 3


def test_xlstm_time_loops_counted_in_full(runs):
    """2b. Under a count, each mLSTM / sLSTM block runs all S = 8 of its
    time steps in the forward and again in the remat recompute — so the
    count needs no `scan_flop_correction` (the port records 0 where the
    reference adds (S−1) bodies for XLA)."""
    port, _, _ = runs
    got = port["xlstm_steps"]
    for kind in ("mlstm", "slstm"):
        n_blocks = got["blocks"].count(kind)
        assert got["calls"][kind] == 2 * 8 * n_blocks, (kind, got)


def test_reshard_collective_matches_reference_parser(runs):
    """3. (64, 64) f32 from (Shard(0), Shard(1)) to (Shard(0),
    Replicate()): one all-gather on model, 1792 B of wire a device —
    the reference's `analyze_collectives` on XLA's HLO of the same
    reshard gives the same."""
    port, ref, _ = runs
    got = port["reshard"]
    assert got["ops"] == 1
    assert got["by_kind"] == {"all-gather": 1792.0}
    assert got["by_axis"] == {"model": 1792.0}
    assert got["wire_bytes_per_chip"] == 1792.0
    assert ref["reshard"]["wire"] == got["wire_bytes_per_chip"]
    assert ref["reshard"]["by_axis"] == got["by_axis"]
    assert ref["reshard"]["by_kind"] == got["by_kind"]


def test_unknown_collective_raises(runs):
    """A collective outside the counter's table (a broadcast, which the
    port never issues) raises rather than going uncounted."""
    port, _, _ = runs
    assert "c10d::broadcast_" in port["unknown_collective"]


_HLO_OP ={"all-gather": "all-gather", "reduce-scatter": "reduce-scatter",
           "all-reduce": "all-reduce", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("kind", hlo_analysis.RING_KINDS)
def test_ring_formulas_match_reference(kind, n):
    """4. The port's ring formulas equal the reference parser's on a
    synthetic HLO line of each kind over a group of n model ranks."""
    group = "{" + ",".join(str(i) for i in range(n)) + "}"
    line = (f"  %x = f32[{n * 64},32]{{1,0}} {_HLO_OP[kind]}(f32[64,32] %p), "
            f"replica_groups={{{group}}}, dimensions={{0}}")
    st = analyze_collectives(line, {"data": 8, "model": 8})
    out_bytes = n * 64 * 32 * 4
    assert st.ops == 1
    assert hlo_analysis.ring_wire_bytes(kind, out_bytes, n) == pytest.approx(
        st.wire_bytes_per_chip, rel=1e-15)
    stats = hlo_analysis.CollectiveStats()
    stats.add(kind, out_bytes, n, "model")
    assert dict(stats.by_kind) == pytest.approx(st.by_kind, rel=1e-15)
    assert dict(stats.by_axis) == pytest.approx(st.by_axis, rel=1e-15)


def test_analytic_helpers_match_reference(runs):
    """5. `model_flops`, `attn_model_flops`, `scan_flop_correction` and
    `analytic_hbm_bytes` equal the reference's on every cell, at the v5e
    axes and at the H100 ones."""
    _, ref, _ = runs
    cells = ref["cells"]
    assert set(cells) == {f"{a}/{s.name}" for a, s in all_cells()}
    for arch, shape in all_cells():
        want = cells[f"{arch}/{shape.name}"]
        cfg, sh = get_config(arch), SHAPES[shape.name]
        for name, fn in (("model_flops", dryrun.model_flops),
                         ("attn_model_flops", dryrun.attn_model_flops),
                         ("scan_flop_correction",
                          dryrun.scan_flop_correction)):
            np.testing.assert_allclose(fn(cfg, sh), want[name], rtol=1e-12,
                                       err_msg=f"{arch}/{shape.name} {name}")
        for name, axes in AXES_SETS.items():
            np.testing.assert_allclose(
                hlo_analysis.analytic_hbm_bytes(cfg, sh, axes),
                want["hbm"][name], rtol=1e-12,
                err_msg=f"{arch}/{shape.name} hbm {name}")


def test_unit_reconstruction_equals_direct_count(runs):
    """6. The U ∈ {2, 4} reconstruction of a 6-unit smoke stack's prefill
    on the fake (2, 2) mesh equals the direct count at U = 6: FLOPs
    exactly, bytes and collectives to rounding."""
    port, _, _ = runs
    assert port["recon_how"]["u_points"] == [2, 4]
    rec, direct = port["recon"], port["direct"]
    assert rec["flops"] == direct["flops"]
    assert rec["bytes_accessed"] == pytest.approx(direct["bytes_accessed"],
                                                  rel=1e-12)
    assert rec["ops"] == direct["ops"] > 0
    for key in ("by_kind", "by_axis", "by_kind_axis"):
        assert set(rec[key]) == set(direct[key])
        for k, v in direct[key].items():
            assert rec[key][k] == pytest.approx(v, rel=1e-12), (key, k)


@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_time_loop_extension_equals_direct_count(runs, kind):
    """7b. xlstm-350m's smoke cell at S = 80 on the fake (2, 2) mesh,
    counted at the `SEQ_POINTS` trip counts and extended linearly, equals
    its direct count at S = 80 (every time step run): FLOPs exactly,
    bytes and collectives to rounding."""
    port, _, _ = runs
    got = port["seq_" + kind]
    assert got["how"]["seq_points"] == list(dryrun.SEQ_POINTS)
    ext, direct = got["extended"], got["direct"]
    assert ext["flops"] == direct["flops"] > 0
    assert ext["bytes_accessed"] == pytest.approx(direct["bytes_accessed"],
                                                  rel=1e-12)
    assert ext["ops"] == direct["ops"] > 0
    for key in ("by_kind", "by_axis", "by_kind_axis", "flops_by_op"):
        assert set(ext[key]) == set(direct[key])
        for k, v in direct[key].items():
            assert ext[key][k] == pytest.approx(v, rel=1e-12), (key, k)


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_smoke_cell_on_fake_mesh(runs, kind):
    """7. One smoke cell of each step kind on a fake (2, 2) mesh: the
    record is well formed; a device does at least a quarter of the
    one-device FLOPs (4 ranks) and at most all of them; the train cell
    gathers its FSDP shards and reduce-scatters their gradients on
    data."""
    port, _, _ = runs
    mesh, one = port[kind + "_mesh"], port[kind + "_one"]
    for m in (mesh, one):
        assert {"flops", "bytes_accessed", "wire", "ops", "by_kind",
                "by_axis", "by_kind_axis", "flops_by_op", "top"} <= set(m)
        assert m["flops"] > 0 and m["bytes_accessed"] > 0
    assert one["ops"] == 0 and one["wire"] == 0
    assert one["flops"] / 4 <= mesh["flops"] <= one["flops"]
    assert mesh["ops"] > 0
    assert set(mesh["by_axis"]) <= {"data", "model"}
    assert sum(mesh["by_kind"].values()) == pytest.approx(mesh["wire"])
    if kind == "train":
        assert mesh["by_kind_axis"].get("all-gather@data", 0) > 0
        assert mesh["by_kind_axis"].get("reduce-scatter@data", 0) > 0


def _close(got, want, where="roofline") -> None:
    """Numbers within 1e-12 relative, dicts key for key, the rest
    equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (int, float)) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=1e-12), where
    else:
        assert got == want, where


def test_recompute_is_idempotent(runs, tmp_path):
    """8. `recompute` on a production analysis record gives the record's
    own roofline back, and again on its output."""
    _, _, record = runs
    rec = json.loads(record.read_text())
    assert rec["ok"] and rec["chips"] == 256
    path = tmp_path / "qwen2-0.5b_decode_32k_pod_analysis.json"
    path.write_text(record.read_text())
    assert recompute_roofline.recompute(path)
    once = json.loads(path.read_text())
    assert recompute_roofline.recompute(path)
    twice = json.loads(path.read_text())
    assert once == twice
    _close(once["roofline"], rec["roofline"])
    r = rec["roofline"]
    assert r["bottleneck"] in ("T_comp", "T_mem", "T_coll")
    assert r["T_coll"] == pytest.approx(sum(r["T_coll_by_axis"].values()))


def test_import_hygiene(runs):
    """9. Importing the dry run sets no environment variable and starts no
    process group (the reference's sets XLA_FLAGS); the fake group of a
    run is gone after it."""
    port, _, _ = runs
    assert port["import_env_unchanged"]
    assert not port["import_started_group"]
    assert not port["group_after"]


def test_out_directory_differs_from_reference():
    """10. The two dry runs write their records to different default
    directories, so a port run never replaces a reference record of the
    same name.  The reference's default is read from its parser's source
    (importing it reconfigures JAX); the port's from its own parser,
    without running a cell."""
    import ast

    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    ref = [ast.literal_eval(kw.value) for node in ast.walk(ast.parse(src))
           if isinstance(node, ast.Call)
           and getattr(node.func, "attr", None) == "add_argument"
           and node.args and ast.literal_eval(node.args[0]) == "--out"
           for kw in node.keywords if kw.arg == "default"]
    port = dryrun.parser().parse_args([]).out
    assert ref == ["experiments/dryrun"]
    assert port == dryrun.OUT_DIR == "experiments/dryrun_torch"
    assert Path(port).resolve() != Path(ref[0]).resolve()
    assert not Path(port).resolve().is_relative_to(Path(ref[0]).resolve())
