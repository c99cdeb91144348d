#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  env           the card, its power limit, torch / CUDA / nvcc versions;
  build         both kernels compiled from ``src/repro_torch/csrc`` by one
                ``nvcc`` each, started together, into ``build/kernels/``;
  kernel_check  each kernel against its plain PyTorch version on the card:
                ``qos_round_fused`` bit-exact (T=256, max_units=256; N=4096
                rows with 3 and 16 tenants, and 3 tenants at each backlog
                length the serve phase gives the kernel; general, 2³²
                wrap, all-dead and zero-free cases; the K=32 scan), and
                ``paged_decode`` within atol = rtol = 2e-5 in f32 at the
                slice's shape and at qwen2-0.5b's attention shape;
  serve_small   the engine on the card against the same engine on the CPU
                (plain versions) on a small trace: streams and samples
                equal;
  serve         the main path: `ContinuousBatchingEngine.megastep(32)` at
                qwen2-0.5b's full width (d=896, vocab=151936), 256 slots,
                a 2048×16 block pool that the worst-case demand
                oversubscribes (the block gate must stall), ~1000 requests
                of three tenants, until every request is finished or
                expired; each round runs under
                ``torch.cuda.set_sync_debug_mode("error")``;
  kernels       per kernel: launches on the main path, max error against
                the plain version on the timed inputs, time at the main
                path's shapes beside the plain version's, the bound and a
                library call's time.

Then the ``nvidia-smi`` name and power-limit line, the ``kernels`` JSON
line, and, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; without CUDA (or without the repository beside
this file) it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
SEED = 0
TENANTS = ("gold", "silver", "bronze")
# the serve phase: slots, requests, kv pool (NB, BS, MB), longest request
# (prompt_cap 128 + max_new 128 tokens); 256 slots × 16 blocks worst case
# against 2048 blocks, so the block gate binds
SERVE_SLOTS, SERVE_REQUESTS = 256, 1000
SERVE_POOL = (2048, 16, 32)
SERVE_MAX_LEN = 256
QOS_CASES = (
    ("general", dict(wrap=False, alive_density=0.8, free=200)),
    ("wrap", dict(wrap=True, alive_density=0.8, free=200)),
    ("all-dead", dict(wrap=False, alive_density=0.0, free=200)),
    ("zero-free", dict(wrap=True, alive_density=0.9, free=0)),
)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA
    events, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ----------------------------------------------------------------- inputs ---


def qos_case(torch, dev, *, seed, S, N, T, wrap, alive_density, free):
    """A QoS round's inputs on the card: per-tenant consecutive tickets
    (issued by `qos_take`, optionally straddling 2³²), random dead slack,
    virtual passes, deadlines (a fifth expire), shuffled rows."""
    import numpy as np

    from repro_torch.admission import functional_qos as fq
    from repro_torch.core import u32

    rng = np.random.default_rng(seed)
    weights = rng.uniform(0.5, 4.0, S).astype(np.float32)
    st = fq.make_qos(weights, table_size=T, device=dev)
    base = (1 << 32) - N // (2 * S) if wrap else int(rng.integers(0, 1000))
    b = u32.u32(np.full(S, base, np.int64), device=dev)
    st = st._replace(ticket=b, grant=b, consumed=b,
                     dead=torch.as_tensor(rng.integers(0, 4, S), device=dev),
                     vpass=torch.as_tensor(rng.uniform(0, 3, S)
                                           .astype(np.float32), device=dev))
    ids = torch.as_tensor(rng.integers(0, S, N).astype(np.int32), device=dev)
    st, tickets, _, _ = fq.qos_take(st, ids,
                                    torch.ones(N, dtype=torch.bool,
                                               device=dev))
    perm = torch.as_tensor(rng.permutation(N), device=dev)
    alive = torch.as_tensor(rng.random(N) < alive_density, device=dev)
    dls = np.where(rng.random(N) < 0.2, rng.uniform(-1, 1, N), np.inf)
    dls = torch.as_tensor(dls.astype(np.float32), device=dev)
    return st, ids[perm], tickets[perm], alive, dls, free


def paged_case(torch, dev, *, seed, S, H, KV, hd, NB, BS, MB, max_len=None):
    """Paged-decode inputs on the card: ragged lens up to ``max_len``
    (the full table by default; zeros included, one slot at the maximum),
    permuted pool ids, -1 past each slot's blocks."""
    import numpy as np

    max_len = MB * BS if max_len is None else max_len
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, S).astype(np.int32)
    lens[:4] = 0
    lens[-1] = max_len
    ids = rng.permutation(NB)
    tbl = np.full((S, MB), -1, np.int32)
    p = 0
    for s in range(S):
        nb = -(-int(lens[s]) // BS)
        if p + nb > NB:
            nb = NB - p
            lens[s] = nb * BS
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, H, hd), generator=g, device=dev)
    kp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    return (q, kp, vp, torch.as_tensor(tbl, device=dev),
            torch.as_tensor(lens, device=dev))


def states_equal(torch, a, b) -> bool:
    """Field-wise bit equality of two NamedTuples of tensors."""
    for x, y in zip(a, b):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def qos_max_err(torch, got, want) -> float:
    """Largest |difference| over every field of two QoS round results
    ``(state', admitted, expired, leftover)``; masks count as 0/1, u32
    carriers exactly; equal infinities differ by 0, any other non-finite
    difference is inf."""
    err = 0.0
    for x, y in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
        x, y = x.double(), y.double()
        d = torch.where((x == y) | (x.isnan() & y.isnan()), 0.0,
                        (x - y).abs())
        if d.numel():
            err = max(err, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return err


def qos_exact(torch, got, want) -> bool:
    """Bit equality of two QoS round results."""
    return (states_equal(torch, got[0], want[0])
            and all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])))


def backlog_rows(n_req: int, S: int, block_n: int = 256) -> list:
    """The backlog lengths the serve phase hands the QoS kernel as it
    drains: the engine's power-of-two backlog for ``max(n, S)`` rows,
    halving down to the ops wrapper's floor of ``block_n`` rows."""
    n = max(1 << (max(n_req, S) - 1).bit_length(), 8, block_n)
    rows = []
    while n >= block_n:
        rows.append(n)
        n //= 2
    return rows


# ----------------------------------------------------------------- phases ---


def kernel_check(torch, dev) -> dict:
    from repro_torch.kernels import ops, qos_admission, ref
    from repro_torch.kernels.paged_decode import paged_decode, \
        paged_decode_plain

    out = {}
    # backlog_cap rows with 3 and 16 tenants, then every backlog length the
    # serve phase gives the kernel, with its 3 tenants
    shapes = [(S, 4096) for S in (3, 16)] + [
        (3, N) for N in backlog_rows(SERVE_REQUESTS, SERVE_SLOTS)]
    for S, N in shapes:
        for case, kw in QOS_CASES:
            st, ids, tks, alive, dls, free = qos_case(
                torch, dev, seed=S + N, S=S, N=N, T=256, **kw)
            want = qos_admission.qos_round_plain(st, ids, tks, alive, dls,
                                                 0.0, free, 256)
            got = qos_admission.qos_round_fused(st, ids, tks, alive, dls,
                                                0.0, free, max_units=256)
            if not qos_exact(torch, got, want):
                raise AssertionError(
                    f"qos_round_fused != plain: S={S} N={N} {case}")
            out[f"qos S={S} N={N} {case}"] = "bit-exact"
    for S in (3, 16):
        st, ids, tks, alive, dls, _ = qos_case(
            torch, dev, seed=S + 100, S=S, N=4096, T=256, wrap=True,
            alive_density=0.9, free=0)
        g = torch.Generator(device=dev).manual_seed(S)
        nows = torch.linspace(-0.5, 1.0, 32, device=dev)
        released = torch.randint(0, 9, (32,), generator=g, device=dev,
                                  dtype=torch.int32)
        free0 = torch.full((), 64, dtype=torch.int32, device=dev)
        want = ref.qos_round_scan_ref(st, ids, tks, alive, dls, nows, free0,
                                      released, 256)
        got = ops.qos_round_scan(st, ids, tks, alive, dls, nows, free0,
                                 released, max_units=256)
        if not (states_equal(torch, got[0], want["state"])
                and torch.equal(got[1], want["admit_round"])
                and torch.equal(got[2], want["expire_round"])
                and torch.equal(got[3], want["free"])):
            raise AssertionError(f"qos_round_scan != plain scan: S={S}")
        out[f"qos_scan S={S} K=32"] = "bit-exact"

    for name, shape in (("slice", dict(H=1, KV=1, hd=896)),
                        ("qwen2-0.5b-attn", dict(H=14, KV=2, hd=64))):
        args = paged_case(torch, dev, seed=7, S=256, NB=4096, BS=16, MB=32,
                          **shape)
        got = paged_decode(*args)
        want = paged_decode_plain(*args)
        if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
            raise AssertionError(f"paged_decode != plain at {name}")
        err = float((got - want).abs().max())
        out[f"paged_decode {name}"] = f"max_abs_err {err:.3e}"
    return out


def small_engine(torch, dev, trace, model_cpu):
    from repro_torch.serving import engine_state as es
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    clk = [0.0]
    eng = ContinuousBatchingEngine(
        None, None, 4, tenants={"gold": 4.0, "silver": 2.0, "bronze": 1.0},
        use_kernel=True, clock=lambda: clk[0], prompt_cap=8,
        kv_pool=(32, 4, 8), device=dev)
    eng.megastep_model = {k: v.clone().to(dev) for k, v in model_cpu.items()}
    reqs = [Request(**t) for t in trace]
    eng.submit_batch(reqs)
    samples = []
    for _ in range(20):
        eng.megastep(8, token_fn=es.paged_pool_token_fn,
                     admit_fn=es.paged_pool_admit_fn,
                     nows=[k * 0.25 for k in range(8)])
        samples += eng.telemetry()["last_samples"]
        clk[0] += 2.0
        if all(r.done_event.is_set() for r in reqs):
            break
    return [(r.out_tokens, r.admit_round, r.expire_round) for r in reqs], \
        samples


def serve_small(torch, dev) -> dict:
    """The engine on the card (both kernels) against the engine on the CPU
    (plain versions) on one small trace."""
    import numpy as np

    from repro_torch.serving.engine_state import make_paged_pool_model

    rng = np.random.default_rng(SEED)
    names = ["gold", "silver", "bronze"]
    trace = [dict(rid=i, prompt=[int(x) for x in rng.integers(1, 50, int(
        rng.integers(1, 8)))], max_new_tokens=int(rng.integers(1, 16)),
        tenant_id=names[i % 3],
        deadline=(float(rng.integers(2, 12)) if i % 4 == 0 else None))
        for i in range(24)]
    model = make_paged_pool_model(torch.Generator().manual_seed(SEED), 50, 16,
                                  32, 4)
    gpu = small_engine(torch, dev, trace, model)
    cpu = small_engine(torch, torch.device("cpu"), trace, model)
    if gpu != cpu:
        raise AssertionError("engine on the card != engine on the CPU")
    return {"requests": len(trace), "rounds": len(gpu[1]),
            "tokens": sum(len(t[0]) for t in gpu[0]),
            "equal_to_cpu": True}


def serve_engine(torch, dev, *, S=SERVE_SLOTS, pool=SERVE_POOL,
                 vocab=151936, d=896, n_req=SERVE_REQUESTS, prompt=(16, 129),
                 new=(16, 129)):
    """The serve configuration, by default at qwen2-0.5b's full width:
    the engine with its model and ``n_req`` submitted requests, plus a
    function that runs one ``megastep(32)`` and returns its samples."""
    import numpy as np

    from repro_torch.serving import engine_state as es
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    K, DT = 32, 1.0
    NB, BS, _ = pool
    clk = [0.0]
    eng = ContinuousBatchingEngine(
        None, None, S, tenants={"gold": 4.0, "silver": 2.0, "bronze": 1.0},
        use_kernel=True, clock=lambda: clk[0], backlog_cap=4096,
        prompt_cap=128, kv_pool=pool, device=dev)
    eng.megastep_model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(*prompt)))],
        max_new_tokens=int(rng.integers(*new)),
        tenant_id=TENANTS[int(rng.integers(0, 3))],
        deadline=(DT * float(rng.integers(40, 320))
                  if rng.random() < 0.25 else None))
        for i in range(n_req)]
    eng.submit_batch(reqs)

    def megastep():
        eng.megastep(K, token_fn=es.paged_pool_token_fn,
                     admit_fn=es.paged_pool_admit_fn,
                     nows=[k * DT for k in range(K)])
        clk[0] += K * DT
        return eng.telemetry()["last_samples"]

    return eng, reqs, megastep


def serve(torch, dev, **sizes) -> dict:
    """The main path: serve until every request is finished or expired."""
    from repro_torch.kernels import ops

    eng, reqs, megastep = serve_engine(torch, dev, **sizes)
    S, K = eng.n_slots, 32
    NB, n_req = eng._kv_blocks, len(reqs)
    vocab = eng.megastep_model["emb"].shape[0]
    ops.reset_launch_counts()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    megasteps, samples, step_ms = 0, [], []
    while not all(r.done_event.is_set() for r in reqs):
        if megasteps == 64:
            raise AssertionError("serve did not resolve every request")
        t1 = time.perf_counter()
        samples += megastep()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        megasteps += 1
    sync()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    tokens = sum(len(r.out_tokens) for r in reqs)
    finished = [r for r in reqs if not r.expired]
    gate_stalls = sum(s["gate_stalls"] for s in samples)
    checks = {
        "all_resolved": all(r.done_event.is_set() for r in reqs),
        "health_zero": all(s["health"] == 0 for s in samples),
        "one_sync_per_megastep": eng.stats.host_syncs == megasteps,
        "kernels_launched": all(v > 0 for v in launches.values()),
        "finished_full_length": all(len(r.out_tokens) == r.max_new_tokens
                                    for r in finished),
        "tokens_in_vocab": all(0 <= t < vocab for r in reqs
                               for t in r.out_tokens),
        "pool_drained": eng.telemetry()["kv_blocks_free"] == NB,
        "block_gate_stalled": gate_stalls > 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"serve checks failed: {checks}")
    return {
        "requests": n_req, "finished": eng.stats.finished,
        "expired": eng.stats.expired, "preempted": eng.stats.preempted,
        "megasteps": megasteps, "rounds": megasteps * K,
        "busy_rounds": eng.stats.steps, "tokens": tokens,
        "gate_stalls": gate_stalls,
        "admits_per_tenant": dict(eng.tenant_admitted),
        "megastep_ms": step_ms,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ms_per_round": 1e3 * wall / (megasteps * K),
        "host_syncs": eng.stats.host_syncs, "launches": launches,
        "sync_debug_mode": "error", "checks": checks,
        "backlog_rows": backlog_rows(n_req, S),
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if dev.type == "cuda" else None),
    }


def profile_megastep(torch, dev) -> dict:
    """Where one megastep's time goes: the serve configuration with 400
    requests; one warm megastep, one timed without the profiler, one under
    torch.profiler.  Device busy time (the sum of kernel times) over the
    unprofiled and the profiled wall time, and the kernels that take the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, _, megastep = serve_engine(torch, dev, n_req=400)
    megastep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    megastep()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        megastep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # device-side kernel events only (CPU op events also carry the device
    # time of the kernels they launched)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    ours = {name: {"ms_per_launch": e.self_device_time_total / 1e3 / e.count,
                   "launches": e.count}
            for e in kernels for name in ("qos_round_kernel",
                                          "paged_decode_kernel")
            if name in e.key}
    return {"requests": 400, "rounds": 32,
            "wall_ms_unprofiled": 1e3 * plain_wall,
            "wall_ms_profiled": 1e3 * wall,
            "device_busy_ms": busy_us / 1e3,
            "busy_share_of_unprofiled_wall": busy_us / 1e6 / plain_wall,
            "busy_share_of_profiled_wall": busy_us / 1e6 / wall,
            "kernel_launches": sum(e.count for e in kernels),
            "ported_kernels": ours,
            "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top]}


def kernel_times(torch, dev, launches, first_backlog_rows) -> list:
    """Each kernel against its plain version on the timed inputs (the max
    error goes into the row), then the times of the kernel, the plain
    version and a library call at the main path's shapes; the bound from
    these inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import qos_admission, ref
    from repro_torch.kernels.paged_decode import paged_decode, \
        paged_decode_plain

    rows = []
    # QoS round: the serve path's first backlog (pow2 rows), 3 tenants,
    # T=256, max_units = 256 slots
    N, S, T, U = first_backlog_rows, 3, 256, 256
    st, ids, tks, alive, dls, free = qos_case(
        torch, dev, seed=1, S=S, N=N, T=T, wrap=False, alive_density=0.9,
        free=64)
    now = torch.zeros((), device=dev)
    free_t = torch.full((), free, dtype=torch.int32, device=dev)

    def kernel():
        return qos_admission.qos_round_fused(st, ids, tks, alive, dls, now,
                                             free_t, max_units=U)

    def plain():
        return qos_admission.qos_round_plain(st, ids, tks, alive, dls, now,
                                             free_t, U)

    got, want = kernel(), plain()
    q_err = qos_max_err(torch, got, want)
    if not qos_exact(torch, got, want):
        raise AssertionError(f"qos_round_fused != plain at N={N}: max "
                             f"|err| {q_err}")
    k_ms, p_ms = time_ms(kernel), time_ms(plain)
    q_bytes = (N * (4 + 4 + 1 + 4)          # rows: tenant, ticket, alive, dl
               + S * (6 * 4) + T * 4 + 12   # tenant state, array, scalars
               + N * 2 + S * 16 + T * 4 + 4)  # masks, state', array', left
    q_ops = 2 * S * U                        # one div + add per crossing
    q_bound = max(q_bytes / HBM_BYTES_PER_S, q_ops / F32_FLOPS) * 1e3
    rows.append({
        "name": "qos_round_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/qos_admission.cu",
        "replaces": "src/repro/kernels/qos_admission.py:249",
        "launches": launches["qos_round_fused"], "max_abs_err": q_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": q_bound,
        "bound_by": ("bytes" if q_bytes / HBM_BYTES_PER_S
                     >= q_ops / F32_FLOPS else "operations"),
        "library_ms": None,
        "shape": {"N": N, "tenants": S, "T": T, "max_units": U}})

    # paged decode at the serve path's shape: 256 slots, H=KV=1, hd=896,
    # its pool, lens up to its longest request
    Sd, H, KV, hd = SERVE_SLOTS, 1, 1, 896
    NB, BS, MB = SERVE_POOL
    q, kp, vp, tbl, lens = paged_case(torch, dev, seed=11, S=Sd, H=H, KV=KV,
                                      hd=hd, NB=NB, BS=BS, MB=MB,
                                      max_len=SERVE_MAX_LEN)
    got = paged_decode(q, kp, vp, tbl, lens)
    want = paged_decode_plain(q, kp, vp, tbl, lens)
    d_err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"paged_decode != plain at the serve shape: "
                             f"max |err| {d_err}")
    k_ms = time_ms(lambda: paged_decode(q, kp, vp, tbl, lens))
    p_ms = time_ms(lambda: paged_decode_plain(q, kp, vp, tbl, lens),
                   iters=5, warmup=1)
    kd, kpos = ref.paged_gather_kv(kp, tbl, lens)
    vd, _ = ref.paged_gather_kv(vp, tbl, lens)
    qh = q[:, :, None, :]                                   # (S, H, 1, hd)
    kh = kd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vh = vd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    mask = (kpos >= 0)[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    live = int(lens.sum())
    d_bytes = (2 * live * KV * hd * 4          # live K and V rows, once
               + 2 * Sd * H * hd * 4           # q in, out
               + Sd * MB * 4 + Sd * 4)         # table, lens
    d_ops = 4 * live * H * hd                  # q·k and p·v, 2 flops each
    d_bound = max(d_bytes / HBM_BYTES_PER_S, d_ops / F32_FLOPS) * 1e3
    rows.append({
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:119",
        "launches": launches["paged_decode"],
        "max_abs_err": d_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": d_bound,
        "bound_by": ("bytes" if d_bytes / HBM_BYTES_PER_S
                     >= d_ops / F32_FLOPS else "operations"),
        "library_ms": lib_ms,
        "shape": {"S": Sd, "H": H, "KV": KV, "hd": hd, "BS": BS, "MB": MB,
                  "live_tokens": live}})
    return rows


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = smi_line()
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip()
    emit("env", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_v.splitlines()[-1], python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = build.build(force=True)
    emit("build", seconds=time.perf_counter() - t0,
         per_source={n: {"seconds": v["seconds"],
                         "ptxas": [ln for ln in v["ptxas"].splitlines()
                                   if "registers" in ln or "spill" in ln]}
                     for n, v in built.items()})

    t0 = time.perf_counter()
    checks = kernel_check(torch, dev)
    emit("kernel_check", seconds=time.perf_counter() - t0, results=checks)

    t0 = time.perf_counter()
    small = serve_small(torch, dev)
    emit("serve_small", seconds=time.perf_counter() - t0, **small)

    torch.cuda.reset_peak_memory_stats()
    res = serve(torch, dev)
    emit("serve", **res)

    t0 = time.perf_counter()
    prof = profile_megastep(torch, dev)
    emit("profile", seconds=time.perf_counter() - t0, **prof)

    rows = kernel_times(torch, dev, res["launches"], res["backlog_rows"][0])
    emit("kernels", kernels=rows)

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
