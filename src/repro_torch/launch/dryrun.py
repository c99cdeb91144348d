"""Dry run of every (arch × shape × mesh) cell on the production H100 mesh
— the port of ``repro.launch.dryrun``.  No card and no allocation: one
process plays rank 0 of a ``fake`` process group of 256 (pod) or 512
(multipod) ranks, on `launch.mesh.make_production_mesh` over ``cpu``;
parameters, optimizer state, caches and inputs are fake tensors
(``FakeTensorMode``) that carry shapes and dtypes only.  The fake group
lives inside `fake_world` (a context manager, entered by `run_one`), the
fake mode inside each count: importing this module sets no environment
variable and starts no process group.

What stands in for XLA (see `launch.hlo_analysis`): the step runs once,
eagerly, under `hlo_analysis.DeviceCounter`, which counts the FLOPs of
the ops on rank 0's local tensors, the bytes they move and every
collective with the mesh dimension it runs over.  The tensors are fake
and on ``cpu``, so `kernels.ops` takes the plain version of each kernel:
flash and decode attention on each rank's shard
(`parallel.shard_attention`) and the LM head are counted as the plain
versions compute them — the same work the kernels do; how a kernel
carries it out (the flash kernel's 3xTF32 takes three products for one)
is not the model's work and is not counted.  The dry run launches no
kernel.  ``flop_registry`` counts products, convolutions and attention
ops; elementwise arithmetic, which XLA's cost analysis adds, is not in
it.

Two modes a cell, as in the reference:

  production — the step as it would ship (its microbatch accumulation):
               per-device bytes exactly from the specs of every input
               (`_analytic_args_bytes`) plus the activation estimate
               (`projected_bytes`), and the accumulation tuner.  (torch's
               ``MemTracker``, run over the step on the fake mesh, read
               26.2 GB for qwen2-0.5b's decode_32k, whose inputs hold
               0.40 GB a device, and 133 GB for its train_4k: not a
               device's peak, so it is not used);
  analysis   — ``StepConfig.analysis`` (one microbatch, one KV block,
               one CE chunk: what the reference's unrolled lowering
               computes) counted by `DeviceCounter`; a stack of more
               than 4 units counted at U ∈ {2, 4} and extended linearly
               (`_lin`), as the reference does.  Eager torch runs every
               loop iteration — the mLSTM / sLSTM time steps included —
               so the count needs no `scan_flop_correction` (0 here; the
               reference adds it because XLA counts a loop body once); a
               cell made only of such loops (xlstm-350m's train and
               prefill) is counted at two trip counts and extended
               linearly (`measure_cell`), its loops running on each
               rank's local rows (`parallel.shard_recurrent`).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k \\
      --mesh pod --mode analysis
  python -m repro_torch.launch.dryrun --all --modes analysis --meshes pod

Records go to `OUT_DIR` (experiments/dryrun_torch) unless ``--out`` names
another directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from ..configs.registry import ARCH_IDS, SHAPES, get_config, shapes_for
from ..optim.adamw import AdamWConfig
from ..parallel import sharding
from ..parallel import steps as steps_lib
from .hlo_analysis import (DeviceCounter, analytic_hbm_bytes, HBM_BW,
                           roofline_terms)
from .mesh import make_production_mesh, mesh_device_count, production_axes

# The reference's budget: a v5e's 16 GB less a runtime reserve (14.5 GB);
# the same share of an H100's 80 GB.
HBM_BUDGET = steps_lib.H100_HBM_BYTES * 14.5 / 16


# ------------------------------------------------------- analytic helpers ---


def scan_flop_correction(cfg, shape) -> float:
    """(trips−1) × body-FLOPs for the nonlinear time-step scans (mLSTM /
    sLSTM) that XLA counts once.  Train counts fwd+recompute+bwd ≈ 4×
    fwd body.  (The reference's; the port's eager count needs none.)"""
    kinds = [b.kind for b in cfg.blocks]
    n_ml = kinds.count("mlstm")
    n_sl = kinds.count("slstm")
    if n_ml + n_sl == 0 or shape.kind == "decode":
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    d_in = 2 * cfg.d_model
    H = cfg.xlstm_heads
    hd = d_in // H
    ml_body = B * (5 * H * hd * hd + 6 * H * hd)  # C/n update + qC readout
    hd_s = cfg.d_model // H
    sl_body = B * (2 * H * hd_s * 4 * hd_s + 30 * H * hd_s)  # recurrent mm + gates
    per_step = n_ml * ml_body + n_sl * sl_body
    mult = 4.0 if shape.kind == "train" else 1.0
    return (S - 1) * per_step * mult


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); D = tokens/step."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    if shape.kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens  # inference: fwd only


def attn_model_flops(cfg, shape) -> float:
    """Attention-score/PV FLOPs not counted by 6·N·D (reported separately so
    the useful-compute ratio can be read against the right denominator).
    Causal/windowed structure credited (factor ½ or window/S)."""
    n_attn = sum(1 for b in cfg.blocks if b.kind in ("attn", "moe"))
    if n_attn == 0:
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    H, hd = cfg.n_heads, cfg.hd
    total = 0.0
    for b in cfg.blocks:
        if b.kind not in ("attn", "moe"):
            continue
        if shape.kind == "decode":
            ctx = min(S, b.window) if b.window else S
            total += 4.0 * B * H * ctx * hd  # one query vs cache
        else:
            frac = min(1.0, b.window / S) if b.window else 0.5  # causal half
            fb = 3.0 if shape.kind == "train" else 1.0  # fwd(+bwd≈2×)
            total += 4.0 * B * H * S * S * frac * hd * fb
    return total


# ------------------------------------------------------------- the world ----


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` default process group of ``world`` ranks (this process
    is rank 0: collectives return at once, moving nothing), destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process without a group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_tensors():
    """Tensors without storage from here on (a mesh is made before: its
    rank grid must hold real numbers)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def _fake(tree):
    """Meta-tensor stand-ins (`steps.input_specs`) as fake ``cpu``
    tensors of the same shapes and dtypes (under the active fake mode)."""
    return sharding.zip_tree(
        lambda x, _: torch.zeros(x.shape, dtype=x.dtype), tree, tree)


# ----------------------------------------------------------- cell dry-run ---


def build_step(cfg, shape, sc, mesh=None):
    """(step, args, specs) of a cell under ``mesh`` (active; ``None``: one
    device): the step from the port's factories, its arguments as fake
    tensors laid out as the step takes them (the caches of a serve step
    as the step hands them back, its steady state), and the spec of
    every argument leaf.  The caches take the parameters' dtype."""
    ins = _fake(steps_lib.input_specs(cfg, shape, cache_dtype=sc.param_dtype))
    gen = torch.Generator().manual_seed(0)
    if shape.kind == "train":
        step = steps_lib.make_train_step(cfg, shape, sc, AdamWConfig())
        state = steps_lib.make_train_state(gen, cfg, sc, device="cpu",
                                           mesh=mesh)
        args = (state, ins["batch"])
        specs = (steps_lib.train_state_pspecs(state, sc),
                 sharding.batch_pspecs(ins["batch"]))
        return step, args, specs
    params = steps_lib.init_params(gen, cfg, sc.param_dtype, "cpu")
    if mesh is not None:
        params = steps_lib.serve_params(params, mesh)
    pspec = sharding.param_pspecs(params, fsdp=False)
    with sharding.axis_rules(**steps_lib._mode_rules(cfg, shape)):
        cspec = sharding.cache_pspecs(ins["caches"])
        if mesh is not None:
            ins["caches"] = steps_lib._placed_caches(ins["caches"], mesh)
        if shape.kind == "prefill":
            step = steps_lib.make_prefill_step(cfg, shape, sc)
            args = (params, ins["batch"], ins["caches"])
            specs = (pspec, sharding.batch_pspecs(ins["batch"]), cspec)
        else:
            step = steps_lib.make_decode_step(cfg, shape, sc)
            args = (params, ins["tokens"], ins["positions"], ins["caches"])
            specs = (pspec,
                     sharding.batch_pspecs({"t": ins["tokens"]})["t"],
                     sharding.batch_pspecs({"p": ins["positions"]})["p"],
                     cspec)
    return step, args, specs


def _analytic_args_bytes(specs, args, axes: dict) -> float:
    """Exact per-device bytes of every argument: each leaf's bytes over
    the product of the mesh axes its spec shards it over."""

    def spec_div(spec):
        n = 1
        for entry in spec:
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                n *= axes.get(ax, 1)
        return n

    total = [0.0]

    def add(x, spec):
        total[0] += x.numel() * x.element_size() / spec_div(spec)

    for a, s in zip(args, specs):
        sharding.zip_tree(add, a, s)
    return total[0]


def _act_bytes(cfg, shape, sc, axes: dict) -> float:
    """The reference's per-device activation estimate: a train
    microbatch's (`steps.est_train_act_bytes`; √U-level remat keeps
    U/g + g unit carries of U), else four hidden rows a token."""
    dp = steps_lib.dp_size(axes)
    if shape.kind == "train":
        per_dev_tokens = shape.global_batch * shape.seq_len / max(dp, 1)
        act = steps_lib.est_train_act_bytes(
            cfg, per_dev_tokens / sc.accum_steps, axes.get("model", 1))
        if sc.remat == "2level":
            g = math.isqrt(cfg.num_units) or 1
            act *= (cfg.num_units // g + g) / max(cfg.num_units, 1)
        return act
    rows = shape.seq_len if shape.kind == "prefill" else 1
    return 4 * shape.global_batch * max(1, rows) * cfg.d_model * 2 / max(dp, 1)


def tuned_memory(cfg, shape, mesh, axes: dict) -> tuple:
    """The production step configuration of a cell and its per-device
    bytes (``memory``): the exact bytes of its inputs from their specs,
    the activation estimate and ``projected_bytes``, their sum; a train
    cell doubles its accumulation, then takes 2-level remat, while
    ``projected_bytes`` exceeds `HBM_BUDGET` (the reference's tuner).
    Runs on fake tensors under ``mesh`` (active).  Returns (step config,
    memory, whether it was retuned)."""
    dp = steps_lib.dp_size(axes)
    sc = steps_lib.default_step_config(cfg, shape, dp, axes=axes)
    max_accum = max(1, shape.global_batch // max(dp, 1))
    retuned = False
    while True:
        _, args, specs = build_step(cfg, shape, sc, mesh)
        args_exact = _analytic_args_bytes(specs, args, axes)
        act = _act_bytes(cfg, shape, sc, axes)
        memory = {"analytic_args_bytes": args_exact, "act_bytes": act,
                  "projected_bytes": args_exact + act,
                  "budget_bytes": HBM_BUDGET}
        if shape.kind == "train" and memory["projected_bytes"] > HBM_BUDGET:
            if sc.accum_steps < max_accum:
                sc = sc._replace(accum_steps=sc.accum_steps * 2)
                retuned = True
                continue
            if sc.remat != "2level":
                sc = sc._replace(remat="2level")
                retuned = True
                continue
        return sc, memory, retuned


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             mode: str = "production") -> dict:
    """The production mode: `tuned_memory` of the cell.  Runs under
    `fake_world`."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    multi_pod = mesh_kind == "multipod"
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    axes = production_axes(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mode": mode, "chips": mesh.size(), "ok": False}
    t0 = time.time()
    with fake_tensors(), sharding.use_mesh(mesh):
        sc, rec["memory"], retuned = tuned_memory(cfg, shape, mesh, axes)
    rec["step_config"] = {"accum_steps": sc.accum_steps, "remat": sc.remat,
                          "fsdp": sc.fsdp}
    if retuned:
        rec["retuned"] = True
    rec["ok"] = True
    rec["t_total_s"] = round(time.time() - t0, 1)
    return rec


def count_step(cfg, shape, mesh=None, sc_over=None) -> tuple:
    """`measure_cell` of ``cfg`` on fake tensors under ``mesh`` (a mesh of
    the active process group, made before; ``None``: one device)."""
    with fake_tensors(), sharding.use_mesh(mesh):
        return measure_cell(cfg, shape, mesh, sc_over)


def _measure_analysis(cfg, shape, mesh, sc_over=None) -> dict:
    """One analysis step counted by `DeviceCounter` → FLOPs, bytes and
    collectives of rank 0."""
    dp = steps_lib.dp_size()
    sc = steps_lib.default_step_config(cfg, shape, dp, analysis=True,
                                       **(sc_over or {}))
    step, args, _ = build_step(cfg, shape, sc, mesh)
    with DeviceCounter(mesh) as counter:
        step(*args)
    coll = counter.collectives.as_dict()
    return {"flops": counter.flops, "bytes_accessed": counter.bytes,
            "wire": coll["wire_bytes_per_chip"], "ops": coll["ops"],
            "by_kind": coll["by_kind"], "by_axis": coll["by_axis"],
            "by_kind_axis": coll["by_kind_axis"],
            "flops_by_op": dict(counter.flops_by_op), "top": coll["top"]}


def _lin(base: dict, delta: dict, extra_units: float) -> dict:
    """base + extra_units × delta, linearly over all numeric fields/dicts."""
    out = {}
    for k, b in base.items():
        d = delta.get(k, 0)
        if isinstance(b, dict):
            keys = set(b) | set(d if isinstance(d, dict) else {})
            out[k] = {kk: b.get(kk, 0.0) + extra_units * (d.get(kk, 0.0) if isinstance(d, dict) else 0.0)
                      for kk in keys}
        elif isinstance(b, (int, float)):
            out[k] = b + extra_units * d
        else:
            out[k] = b
    return out


def _slope(lo: dict, hi: dict, n: float) -> dict:
    """(hi − lo) / n over all numeric fields and dicts."""
    return {k: ({kk: (hi[k].get(kk, 0.0) - lo[k].get(kk, 0.0)) / n
                 for kk in set(hi[k]) | set(lo[k])}
                if isinstance(hi[k], dict) else
                ((hi[k] - lo[k]) / n if isinstance(hi[k], (int, float))
                 else hi[k]))
            for k in hi}


def measure_units(cfg, shape, mesh, sc_over=None) -> tuple:
    """The analysis count of ``cfg``: direct for U ≤ 4 units, else
    f(U) = f(4) + (U−4)·(f(4)−f(2))/2 from counts at U ∈ {2, 4}
    (identical units make every count affine in U).  Returns (count,
    how it was made)."""
    U = cfg.num_units
    if U <= 4:
        return _measure_analysis(cfg, shape, mesh, sc_over), "direct"
    m2 = _measure_analysis(dataclasses.replace(cfg, num_units=2), shape,
                           mesh, sc_over)
    m4 = _measure_analysis(dataclasses.replace(cfg, num_units=4), shape,
                           mesh, sc_over)
    delta = _slope(m2, m4, 2)
    meas = _lin(m4, delta, U - 4)
    meas["top"] = m4["top"]
    return meas, {"u_points": [2, 4], "per_unit_flops": delta["flops"]}


# the sequence lengths a cell of time loops is counted at (`measure_cell`)
SEQ_POINTS = (32, 64)


def time_loops_only(cfg, shape) -> bool:
    """Whether every block of ``cfg`` runs a time loop (mLSTM / sLSTM) and
    ``shape`` runs it over a sequence: then every op of the step is
    affine in the sequence length — the loops' trip counts, and the
    products, norms and loss over the tokens (the analysis step takes one
    microbatch and one CE chunk) — and nothing else depends on it."""
    return (shape.kind != "decode" and bool(cfg.blocks)
            and all(b.kind in ("mlstm", "slstm") for b in cfg.blocks))


def measure_cell(cfg, shape, mesh, sc_over=None) -> tuple:
    """The analysis count of a cell: `measure_units`, except where
    `time_loops_only` holds and the sequence is longer than
    `SEQ_POINTS`' second: there each loop is counted at the two trip
    counts of `SEQ_POINTS` and the count extended linearly,
    f(S) = f(S₂) + (S−S₂)·(f(S₂)−f(S₁))/(S₂−S₁).  Eager torch runs every
    iteration, so a 32768-step loop under fake tensors would take hours
    to count; the extension is exact (`tests/test_torch_dryrun.py` holds
    it to the direct count).  Returns (count, how it was made)."""
    S1, S2 = SEQ_POINTS
    if not (time_loops_only(cfg, shape) and shape.seq_len > S2):
        return measure_units(cfg, shape, mesh, sc_over)
    m1, _ = measure_units(cfg, dataclasses.replace(shape, seq_len=S1), mesh,
                          sc_over)
    m2, how = measure_units(cfg, dataclasses.replace(shape, seq_len=S2),
                            mesh, sc_over)
    delta = _slope(m1, m2, S2 - S1)
    meas = _lin(m2, delta, shape.seq_len - S2)
    meas["top"] = m2["top"]
    return meas, {"units": how, "seq_points": list(SEQ_POINTS),
                  "per_step_flops": delta["flops"]}


def roofline(cfg, shape, meas: dict, axes: dict, n_chips: int,
             dtype: str = "bf16") -> dict:
    """The roofline terms of a counted cell (``meas``: FLOPs, bytes and
    collectives a device): T_comp at the ``dtype`` peak, T_mem from
    `analytic_hbm_bytes` (the eager bytes kept as ``T_mem_eager_upper``),
    T_coll by axis; the bottleneck, the roofline fraction and the useful
    ratios against the model's FLOPs."""
    mem_model = analytic_hbm_bytes(cfg, shape, axes, accum=1)
    terms = roofline_terms(meas["flops"], mem_model, meas["by_axis"], dtype)
    terms["T_mem_eager_upper"] = meas["bytes_accessed"] / HBM_BW
    terms["hbm_model_bytes"] = mem_model
    mf = model_flops(cfg, shape)
    terms["model_flops_total"] = mf
    terms["counted_flops_total"] = meas["flops"] * n_chips
    terms["useful_ratio"] = mf / max(terms["counted_flops_total"], 1.0)
    terms["attn_model_flops_total"] = attn_model_flops(cfg, shape)
    terms["useful_ratio_with_attn"] = (
        mf + terms["attn_model_flops_total"]) / max(
        terms["counted_flops_total"], 1.0)
    return terms


def run_analysis(arch: str, shape_name: str, mesh_kind: str,
                 sc_over: dict | None = None) -> dict:
    """The roofline measurement of a cell (`measure_cell`,
    `roofline`).  Runs under `fake_world`."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    multi_pod = mesh_kind == "multipod"
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    axes = production_axes(multi_pod=multi_pod)
    n_chips = mesh.size()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mode": "analysis", "chips": n_chips, "ok": False}
    t0 = time.time()
    meas, how = count_step(cfg, shape, mesh, sc_over)
    with fake_tensors(), sharding.use_mesh(mesh):
        # the bytes the production step holds (the analysis step takes
        # one microbatch of it)
        sc, rec["memory"], _ = tuned_memory(cfg, shape, mesh, axes)
    rec["step_config"] = {"accum_steps": sc.accum_steps, "remat": sc.remat,
                          "fsdp": sc.fsdp}
    rec["reconstruction"] = how
    rec["cost"] = {"flops": meas["flops"],
                   "bytes_accessed": meas["bytes_accessed"],
                   "flops_by_op": meas["flops_by_op"]}
    rec["collectives"] = {"ops": meas["ops"], "wire_bytes_per_chip":
                          meas["wire"], "by_kind": meas["by_kind"],
                          "by_axis": meas["by_axis"],
                          "by_kind_axis": meas["by_kind_axis"],
                          "top": meas["top"]}
    # eager torch counts every time step: nothing to correct
    rec["flops_correction_total"] = 0.0
    rec["reference_scan_flop_correction"] = scan_flop_correction(cfg, shape)
    rec["roofline"] = roofline(cfg, shape, meas, axes, n_chips)
    rec["ok"] = True
    rec["t_total_s"] = round(time.time() - t0, 1)
    return rec


# ------------------------------------------------------------------ main ----


def cell_list():
    return [(arch, shape.name) for arch in ARCH_IDS
            for shape in shapes_for(arch)]


def summary(rec: dict) -> str:
    """One line of a record: per-device FLOPs and projected bytes, the
    roofline terms (T_coll by axis), the bottleneck, the seconds."""
    tag = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}_{rec['mode']}"
    if "roofline" in rec:
        r = rec["roofline"]
        axes = " ".join(f"{a}={t * 1e3:.3f}ms"
                        for a, t in sorted(r["T_coll_by_axis"].items()))
        return (f"[dryrun] {tag}: flops/device={rec['cost']['flops']:.4e} "
                f"T_comp={r['T_comp'] * 1e3:.3f}ms "
                f"T_mem={r['T_mem'] * 1e3:.3f}ms "
                f"T_coll={r['T_coll'] * 1e3:.3f}ms ({axes}) "
                f"bottleneck={r['bottleneck']} "
                f"useful={r['useful_ratio']:.3f} projected/device="
                f"{rec['memory']['projected_bytes'] / 1e9:.3f} GB "
                f"t={rec['t_total_s']}s")
    m = rec["memory"]
    return (f"[dryrun] {tag}: projected/device="
            f"{m['projected_bytes'] / 1e9:.3f} GB (args "
            f"{m['analytic_args_bytes'] / 1e9:.3f}) "
            f"accum={rec['step_config']['accum_steps']} "
            f"remat={rec['step_config']['remat']} t={rec['t_total_s']}s")


def run_one(arch, shape, mesh, mode, remat=None) -> dict:
    """One job in this process, inside its own `fake_world`."""
    world = mesh_device_count(multi_pod=(mesh == "multipod"))
    with fake_world(world):
        if mode == "analysis":
            return run_analysis(arch, shape, mesh,
                                {"remat": remat} if remat else None)
        return run_cell(arch, shape, mesh, mode)


# The port's records go to a directory of their own: the reference's dry
# run writes records of the same names to experiments/dryrun, and
# benchmarks/roofline_table.py reads that one.
OUT_DIR = "experiments/dryrun_torch"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--mode", default="production",
                    choices=["production", "analysis"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--all", action="store_true",
                    help="run every cell, each in a subprocess")
    ap.add_argument("--modes", default="production,analysis")
    ap.add_argument("--meshes", default="pod,multipod")
    ap.add_argument("--remat", default=None,
                    help="override the analysis remat policy")
    ap.add_argument("--tag", default=None, help="output-name suffix")
    ap.add_argument("--job-timeout", type=float, default=None,
                    help="--all: seconds a cell may take (none by default)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        # every cell × mesh × mode, less multipod analysis (the roofline
        # table is single-pod, as the reference's)
        jobs = [(arch, shape, mesh, mode) for arch, shape in cell_list()
                for mesh in args.meshes.split(",")
                for mode in args.modes.split(",")
                if not (mode == "analysis" and mesh == "multipod")]
        print(f"[dryrun] {len(jobs)} jobs", flush=True)
        failures = 0
        t_all = time.time()
        for i, (arch, shape, mesh, mode) in enumerate(jobs):
            tag = f"{arch}_{shape}_{mesh}_{mode}"
            out_json = outdir / f"{tag}.json"
            if out_json.exists() and json.loads(out_json.read_text()).get("ok"):
                print(f"[{i + 1}/{len(jobs)}] {tag}: cached", flush=True)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--mode", mode, "--out", str(outdir)]
            t0 = time.time()
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.job_timeout)
                log = r.stdout[-4000:] + "\n" + r.stderr[-8000:]
            except subprocess.TimeoutExpired:
                log = f"passed its --job-timeout of {args.job_timeout} s"
            ok = out_json.exists() and json.loads(out_json.read_text()).get("ok")
            print(f"[{i + 1}/{len(jobs)}] {tag}: {'ok' if ok else 'FAIL'} "
                  f"({time.time() - t0:.0f}s)", flush=True)
            if not ok:
                failures += 1
                (outdir / f"{tag}.err").write_text(log)
        print(f"[dryrun] done, {failures} failures, "
              f"{time.time() - t_all:.0f}s", flush=True)
        return 1 if failures else 0

    tag = f"{args.arch}_{args.shape}_{args.mesh}_{args.mode}"
    if args.tag:
        tag += f"_{args.tag}"
    try:
        rec = run_one(args.arch, args.shape, args.mesh, args.mode,
                      args.remat)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "mode": args.mode, "ok": False,
               "error": traceback.format_exc()}
        (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
        print(rec["error"], file=sys.stderr)
        return 1
    (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
    print(summary(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
