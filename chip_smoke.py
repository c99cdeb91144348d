#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  env           the card, its power limit, torch / CUDA / nvcc versions;
  build         the six kernels compiled from ``src/repro_torch/csrc`` by
                one ``nvcc`` each, started together, into
                ``build/kernels/``;
  kernel_check  each kernel against its plain PyTorch version on the card:
                ``qos_round_fused`` bit-exact (T=256, max_units=256; N=4096
                rows with 3 and 16 tenants, and 3 tenants at each backlog
                length the serve phase gives the kernel; general, 2³²
                wrap, all-dead and zero-free cases; each also through
                ``ops.qos_round`` with device scalars at N−3 rows; as
                the host ``step()`` calls it, an all-alive live backlog of
                1000 and 37 rows with ``now`` and ``free`` as Python
                numbers; the K=32 scan);
                ``paged_decode`` within atol = rtol = 2e-5 in f32, each
                call twice, at the up-front path's shape, at qwen2-0.5b's
                attention shape, at the chunked path's (the 4096-block
                pool all live), at G=16 with hd=1024 and at hd=18, BS=4;
                ``paged_prefill`` at the chunked slice's shape (S=256,
                CT=64, H=KV=1, hd=896, BS=16, MB=72) and at qwen2-0.5b's
                attention shape (H=14, KV=2, hd=64), with ragged mid-block
                offsets and idle slots (4 key runs of 288, the split-K
                merge): pools bit-equal (int32 views),
                blocks off the chunk rows untouched, outputs within 2e-5;
                ``sema_batch`` bit-exact at N=1000 and 4096 (T=256,
                tickets across 2³², post_n 0, 3 and T+5; the scalars as
                device carriers, and as submit_batch passes them: ticket
                and grant carriers, post_n and salt ints);
                ``decode_attention`` within 2e-5 at every shape a main
                path gives it: serve_model's (B=8, C=256, H=14, KV=2,
                hd=64; full, windowed, a rolling ring), prefill_model's
                (B=4, C=259: a ragged last split) and the dense-ring
                demo's (B=64, C=256, H=KV=1, hd=896, a rolling ring),
                and over a long cache (C=2048: B=8 with a window, 8
                splits; B=1, 64 splits), where whole splits are masked;
                ``flash_attention`` (causal) within 2e-5 at B=4, H=14,
                KV=2, hd=64: S=512 with and without a window, and
                prefill_model's S=256 and S=259 (a ragged last tile);
                and at hd=256, G=4 (H=4, KV=1; S=512, with and without a
                window);
  two_streams   the three split-K kernels (decode attention, paged
                prefill, paged decode) launched 8 times on each of two
                streams in turns, on different inputs: every output within
                2e-5 of the plain version, each stream with its own
                arrival counters;
  serve_small   the up-front engine on the card against the same engine on
                the CPU (plain versions) on a small trace: streams and
                samples equal;
  serve_small_chunked  the same for the chunked engine with the prefix
                cache and the paged-pool model;
  serve_model_small  the single-tenant serving driver
                (`repro_torch.launch.serve.main`, qwen2-0.5b smoke config)
                on the card against the same driver and weights on the
                CPU: token streams, tickets and samples equal;
  serve         the up-front path: `ContinuousBatchingEngine.megastep(32)`
                at qwen2-0.5b's full width (d=896, vocab=151936), 256
                slots, a 2048×16 block pool that the worst-case demand
                oversubscribes (the block gate must stall), ~1000 requests
                of three tenants, until every request is finished or
                expired;
  serve_chunked the chunked path at the same width: 256 slots,
                ``kv_pool=(4096, 16, 72)``, ``prompt_cap=1024``,
                ``chunked_prefill=(64, 1024, 6144)``, ``prefix_cache=8192``,
                400 requests (a tenant system prompt of 256 tokens plus a
                16–768-token suffix, ~5% exact repeats), megastep(32) with
                `make_chunked_prefill_token_fn(64)`, until every request
                is resolved; slots must park, prefixes hit in full, blocks
                copy on write;
                each round of both serve phases runs under
                ``torch.cuda.set_sync_debug_mode("error")``;
  serve_model   the single-tenant path: `launch.serve.ModelServer` over the
                full qwen2-0.5b config (24 layers, d=896, 14/2 heads,
                hd=64, d_ff=4864, vocab=151936, f32, random weights from
                the seed), 8 slots, max_len=256, the engine with
                ``use_kernel=True``; 32 requests (prompts 16–64 tokens,
                max_new 16–64) in two ``submit_batch`` waves, the second
                after 8 steps, served by ``step()`` to completion;
  prefill_model the full config's ``prefill`` (flash kernel) on B=4 × S=256,
                then 3 ``decode_step``s (decode kernel), each held to a
                fresh prefill over the longer prefix (2e-3);
  serve_dense_ring  the dense-ring demo model (per-slot ring caches at
                qwen2-0.5b width, hd=896) in a QoS ``megastep(32)`` until
                every request resolves: one host sync per megastep;
  serve_step    the multi-tenant host ``step()`` at the serve phase's
                configuration (256 slots, the 2048×16 pool, tenants 4:2:1,
                1000 requests, a quarter with deadlines on the 0.25 grid,
                ``use_kernel=True``) with the rid step function, against
                ``megastep(32)`` of a second engine over the paged-pool
                model emitting the rid tokens, on one virtual clock until
                every request resolves: streams, rounds, the QoS state,
                the free pool, the block-semaphore mirror, every sample
                with its events and the trace spans bit-equal; host syncs
                one a step and one a megastep; the QoS kernel launched
                exactly once by every step with a live backlog;
  serve_step_chunked  the same at the serve_chunked configuration (chunked
                prefill, prefix sharing, its 400-request trace): slots
                park, prefixes hit, blocks copy on write, and the host
                replica equals the device pool after the run (refcounts,
                table, free queue);
  serve_model_qos  the host ``step()`` of a QoS engine (tenants 4:2:1,
                ``use_kernel=True``) over `launch.serve.ModelServer` at the
                full qwen2-0.5b config, 8 slots, 16 requests (a quarter
                with deadlines), against the same trace through a CPU
                engine with the rid step function: admission and finish
                rounds, slots and samples equal, every logit finite;
  profile, profile_chunked  one megastep of each path under
                ``torch.profiler``: device busy share, launches per round,
                the top kernels (and the chunk plan's launches, and the
                live tokens of the chunked round's paged decode calls);
  kernels       per kernel: launches on the main paths, max error against
                the plain version on the timed inputs, time at the main
                path's shapes beside the plain version's, the bound and a
                library call's time, and the wrapper's host time per call
                (200 calls enqueued, no synchronise) split into checks,
                allocation, stream lookup and the ``ctypes`` call; the
                QoS row times ``ops.qos_round`` as the engine calls it
                and counts its CUDA launches a call, as the ``sema_batch``
                row does; the paged-decode row is timed at the up-front
                and (``at_chunked_shape``) the chunked paths' shapes.

Then the ``nvidia-smi`` name and power-limit line, the ``kernels`` JSON
line, and, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; without CUDA (or without the repository beside
this file) it exits non-zero and prints no result.

    python3 chip_smoke.py --ab-attention PARENT

times the six redesigned kernels (paged decode at both megastep paths'
shapes, ``sema_batch``, the QoS round and paged prefill as their
wrappers are called on the main paths, flash and decode attention) and
the rounds of the three megastep paths, of the source tree at PARENT
(for example ``git archive`` of an earlier commit unpacked under
``build/``) and of this tree in turns on the card (parent, this, this,
parent), and prints one JSON line.
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
TF32_FLOPS = 495e12         # H100 SXM TF32 tensor cores, dense
SEED = 0
TENANTS = ("gold", "silver", "bronze")
# the serve phase: slots, requests, kv pool (NB, BS, MB), longest request
# (prompt_cap 128 + max_new 128 tokens); 256 slots × 16 blocks worst case
# against 2048 blocks, so the block gate binds
SERVE_SLOTS, SERVE_REQUESTS = 256, 1000
SERVE_POOL = (2048, 16, 32)
SERVE_MAX_LEN = 256
# the serve_chunked phase: continuous chunked prefill with prefix sharing.
# Each prompt is its tenant's 256-token system prompt plus a 16–768-token
# suffix (prompt_cap 1024 = 64 blocks; + max_new 128 → the 72-block
# table); ~5% repeat an earlier prompt of the same tenant token for token.
# The commitment watermark (6144 blocks) sits above the 4096-block pool,
# so admission oversubscribes it and slots park.
CHUNK_SLOTS, CHUNK_REQUESTS = 256, 400
CHUNK_POOL = (4096, 16, 72)
CHUNK_PROMPT_CAP = 1024
CHUNKED = (64, 1024, 6144)        # chunk tokens, token budget, commit
PREFIX_ENTRIES = 8192
SYSTEM_PROMPT = 256
WEIGHTS = {"gold": 4.0, "silver": 2.0, "bronze": 1.0}
# the serve_model phase: the single-tenant driver over the full config
MODEL_SLOTS, MODEL_MAX_LEN, MODEL_REQUESTS = 8, 256, 32
MODEL_PROMPT, MODEL_NEW = (16, 65), (16, 65)
MODEL_WAVE2_AT = 8              # steps before the second submit_batch
# the serve_model_qos phase: the multi-tenant host step() over the full
# config (MODEL_SLOTS slots, the serve_model prompt and max_new ranges)
QOS_MODEL_REQUESTS = 16
# the prefill_model phase
PREFILL_B, PREFILL_S, PREFILL_EXTRA = 4, 256, 3
# the serve_dense_ring phase: per-slot ring caches at qwen2-0.5b width
RING_SLOTS, RING_CAP, RING_REQUESTS = 64, 256, 300
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


def host_split(torch, fn, calls: int = 200) -> dict:
    """Host µs per call of a kernel wrapper ``fn``: ``calls`` calls timed
    with ``time.perf_counter()`` and no synchronise inside (the enqueue),
    then the same calls again with the allocations (``torch.empty``,
    ``torch.empty_like``), the stream lookup and the ``ctypes`` launch
    call timed apart; ``checks_us`` is the rest of the instrumented call
    (the wrapper's checks and, where it has any, its torch data
    preparation).  The instrumentation adds ~0.2 µs to each timed part."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import qos_admission as qa
    from repro_torch.kernels import sema_batch as sb

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    total = time.perf_counter() - t0
    torch.cuda.synchronize()

    acc = {"alloc": 0.0, "stream": 0.0, "ctypes": 0.0}

    def timed(f, part):
        def call(*a, **kw):
            t = time.perf_counter()
            r = f(*a, **kw)
            acc[part] += time.perf_counter() - t
            return r
        return call

    class Lib:  # a loaded library whose entry points are timed
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            return timed(getattr(self._lib, name), "ctypes")

    patched = [(torch, "empty", "alloc"), (torch, "empty_like", "alloc"),
               (torch.cuda, "current_stream", "stream"),
               (torch._C, "_cuda_getCurrentRawStream", "stream"),
               *((m, "_launch", "ctypes") for m in (fa, da, pd, pp, qa, sb)
                 if hasattr(m, "_launch"))]
    bound = [m for m in (pp, qa) if getattr(m, "_lib", None) is not None]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
    saved += [(m, "_lib", m._lib) for m in bound]
    libs = dict(build._libs)
    try:
        for obj, name, part in patched:
            if getattr(obj, name) is not None:
                setattr(obj, name, timed(getattr(obj, name), part))
        for m in bound:          # a wrapper that keeps its library bound
            m._lib = Lib(m._lib)
        for name, lib in libs.items():
            build._libs[name] = Lib(lib)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        inst = time.perf_counter() - t0
    finally:
        for obj, name, val in saved:
            setattr(obj, name, val)
        build._libs.update(libs)
    torch.cuda.synchronize()
    us = 1e6 / calls
    return {"host_us": total * us, "instrumented_us": inst * us,
            "checks_us": (inst - sum(acc.values())) * us,
            **{f"{k}_us": v * us for k, v in acc.items()}}


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


def chunked_decode_case(torch, dev, *, seed):
    """Paged-decode inputs at the chunked path's shape (S=256, H=KV=1,
    hd=896, the 4096×16 pool, 72-block tables) with the pool's blocks all
    live, as a chunked round holds them: lengths drawn exponential (mean
    256 tokens, up to the table's 1152), ~10% idle, the last slot at the
    full table, halved at random until the blocks fit the pool."""
    import numpy as np

    S, hd = CHUNK_SLOTS, 896
    NB, BS, MB = CHUNK_POOL
    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.exponential(256, S), MB * BS).astype(np.int64)
    lens[rng.random(S) < 0.1] = 0
    lens[-1] = MB * BS
    while (-(-lens // BS)).sum() > NB:
        i = int(rng.integers(0, S - 1))
        lens[i] //= 2
    ids = rng.permutation(NB)
    tbl = np.full((S, MB), -1, np.int32)
    p = 0
    for s in range(S):
        nb = -(-int(lens[s]) // BS)
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, 1, hd), generator=g, device=dev)
    kp = torch.randn((NB, BS, 1, hd), generator=g, device=dev)
    vp = torch.randn((NB, BS, 1, hd), generator=g, device=dev)
    return (q, kp, vp, torch.as_tensor(tbl, device=dev),
            torch.as_tensor(lens.astype(np.int32), device=dev))


def prefill_case(torch, dev, *, seed, S, CT, H, KV, hd, NB, BS, MB,
                 active=None, max_off=None):
    """Paged-prefill inputs on the card: chunk lengths 0..CT (a quarter of
    the slots idle, or only ``active`` slots with a token), offsets mostly
    off the block boundary up to ``max_off``, each slot's blocks
    [0, off+len) from a permutation of the pool, -1 past them.  Returns
    the kernel's arguments and the (block, row) pairs the chunk writes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    max_off = MB * BS - CT if max_off is None else max_off
    lens = rng.integers(1, CT + 1, S)
    lens[rng.random(S) < 0.25] = 0
    if active is not None:   # only the first slots carry a chunk
        lens[active:] = 0
    offs = rng.integers(0, max_off + 1, S)
    offs[::7] = (offs[::7] // BS) * BS          # some block-aligned starts
    if active is not None:
        offs[active:] = 0
    lens[0], lens[1] = 0, CT
    ids = rng.permutation(NB)
    tbl = np.full((S, MB), -1, np.int32)
    p = 0
    for s in range(S):
        nb = -(-int(offs[s] + lens[s]) // BS)
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    assert p <= NB, "pool too small for the case"
    rows = np.asarray([(tbl[s, (offs[s] + j) // BS], (offs[s] + j) % BS)
                       for s in range(S) for j in range(lens[s])],
                      np.int64).reshape(-1, 2)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, CT, H, hd), generator=g, device=dev)
    kc = torch.randn((S, CT, KV, hd), generator=g, device=dev)
    vc = torch.randn((S, CT, KV, hd), generator=g, device=dev)
    kp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    args = (q, kc, vc, kp, vp, *(torch.as_tensor(x.astype(np.int32),
                                                 device=dev)
                                 for x in (tbl, offs, lens)))
    return args, rows


def prefill_check(torch, args, rows, name) -> float:
    """The kernel against its plain version on ``args``: pools bit-equal
    (int32 views), every pool row off the chunk rows untouched, outputs
    within 2e-5.  Returns the outputs' max |error|."""
    from repro_torch.kernels import paged_prefill as pp

    q, kc, vc, kp, vp, tbl, off, lens = args
    want, kw, vw = pp.paged_prefill_plain(*args)
    kp0, vp0 = kp.clone(), vp.clone()
    got, kg, vg = pp.paged_prefill(*args)
    torch.cuda.synchronize()
    written = torch.zeros(kp.shape[:2], dtype=torch.bool, device=kp.device)
    written[torch.as_tensor(rows[:, 0], device=kp.device),
            torch.as_tensor(rows[:, 1], device=kp.device)] = True
    for a, b, old in ((kg, kw, kp0), (vg, vw, vp0)):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"paged_prefill pools != plain at {name}")
        if not torch.equal(a[~written].view(torch.int32),
                           old[~written].view(torch.int32)):
            raise AssertionError(f"paged_prefill wrote off its rows: {name}")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"paged_prefill != plain at {name}: {err}")
    return err


def decode_paged_check(torch, args, name) -> float:
    """The paged-decode kernel against its plain version within 2e-5,
    twice (the second call equal to the first).  Returns the max
    |error|."""
    from repro_torch.kernels.paged_decode import paged_decode, \
        paged_decode_plain

    got = paged_decode(*args)
    again = paged_decode(*args)
    want = paged_decode_plain(*args)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"paged_decode != plain at {name}: {err}")
    if not torch.equal(got, again):
        raise AssertionError(f"paged_decode differs call to call: {name}")
    return err


def sema_case(torch, dev, *, seed, N, T, post_n):
    """``sema_batch`` inputs on the card: tickets starting 300 below 2³²
    (an N ≥ 300 batch crosses the wrap), the grant 40 ahead, random
    waiting-array sequences, ~70% requesting rows."""
    import numpy as np

    from repro_torch.core import u32

    rng = np.random.default_rng(seed)
    base = (1 << 32) - 300
    return (u32.u32(base, device=dev), u32.u32(base + 40, device=dev),
            u32.u32(rng.integers(0, 1 << 32, T), device=dev),
            torch.as_tensor(rng.random(N) < 0.7, device=dev),
            u32.u32(post_n, device=dev), u32.u32(0x9E3779B9, device=dev))


def sema_check(torch, args, name) -> float:
    """The kernel against its plain version: every output bit-equal.
    Returns the max |difference| (0)."""
    from repro_torch.kernels.sema_batch import sema_batch, sema_batch_plain

    got, want = sema_batch(*args), sema_batch_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not torch.equal(g.reshape(-1), w.reshape(-1)):
            raise AssertionError(f"sema_batch != plain at {name}")
    return 0.0


def decode_case(torch, dev, *, seed, B, C, H, KV, hd, window=0,
                rolling=False):
    """Decode-attention inputs on the card: positions 0..C−1 (or a ring
    rotated by 37 that holds them out of order), one row half empty,
    queries at random positions (the last one at C−1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    if rolling:
        pos = np.tile(((np.arange(C) + 37) % C).astype(np.int32), (B, 1))
    pos[0, C // 2:] = -1
    q_pos = rng.integers(0, C, B).astype(np.int32)
    q_pos[-1] = C - 1
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, hd), generator=g, device=dev)
    k = torch.randn((B, C, KV, hd), generator=g, device=dev)
    v = torch.randn((B, C, KV, hd), generator=g, device=dev)
    return (q, k, v, torch.as_tensor(pos, device=dev),
            torch.as_tensor(q_pos, device=dev)), window


def decode_check(torch, args, window, name) -> float:
    """The kernel against its plain version within 2e-5.  Returns the max
    |error|."""
    from repro_torch.kernels.decode_attention import decode_attention, \
        decode_attention_plain

    got = decode_attention(*args, window=window)
    want = decode_attention_plain(*args, window=window)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"decode_attention != plain at {name}: {err}")
    return err


def flash_case(torch, dev, *, seed, B, S, H, KV, hd):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev) for shape in (
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


def flash_check(torch, args, window, name) -> float:
    """The kernel against its plain version (causal) within 2e-5.
    Returns the max |error|."""
    from repro_torch.kernels.flash_attention import flash_attention, \
        flash_attention_plain

    got = flash_attention(*args, window=window)
    want = flash_attention_plain(*args, window=window)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=2e-5, rtol=2e-5):
        raise AssertionError(f"flash_attention != plain at {name}: {err}")
    return err


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


def chunked_requests(n_req: int, vocab: int, seed: int = SEED) -> list:
    """The serve_chunked trace as ``Request`` keyword dicts: tenant
    uniform, its system prompt plus a 16–768-token suffix, ``max_new``
    16–128, a quarter with deadlines; about 5% repeat, token for token,
    the prompt of a request of the same tenant at least 64 requests
    earlier (full covers and copy-on-write)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    system = {t: [int(x) for x in rng.integers(1, vocab, SYSTEM_PROMPT)]
              for t in WEIGHTS}
    out = []
    for i in range(n_req):
        tenant = TENANTS[int(rng.integers(0, 3))]
        earlier = [r for r in out[:max(i - 63, 0)]
                   if r["tenant_id"] == tenant]
        if earlier and rng.random() < 0.05:
            prompt = list(earlier[int(rng.integers(0, len(earlier)))][
                "prompt"])
        else:
            prompt = system[tenant] + [int(x) for x in rng.integers(
                1, vocab, int(rng.integers(16, 769)))]
        out.append(dict(
            rid=i, prompt=prompt, max_new_tokens=int(rng.integers(16, 129)),
            tenant_id=tenant,
            deadline=(float(rng.integers(40, 320)) if rng.random() < 0.25
                      else None)))
    return out


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
            # as the engine calls it: device scalars, N not a power of two
            n = N - 3
            now = torch.zeros((), device=dev)
            free_t = torch.full((), free, dtype=torch.int32, device=dev)
            rows = (ids[:n], tks[:n], alive[:n], dls[:n])
            want = qos_admission.qos_round_plain(st, *rows, now, free_t,
                                                 256)
            got = ops.qos_round(st, *rows, now, free_t, max_units=256)
            if not qos_exact(torch, got, want):
                raise AssertionError(
                    f"ops.qos_round != plain: S={S} N={n} {case}")
            out[f"qos S={S} N={N} and N={n} {case}"] = "bit-exact"
    # as the host step() calls it: the live backlog as it stands (any
    # length, all alive), `now` and `free_units` as Python numbers
    for N in (1000, 37):
        for case, kw in QOS_CASES[:2]:
            st, ids, tks, _, dls, free = qos_case(
                torch, dev, seed=N + 7, S=3, N=N, T=256, **kw)
            alive = torch.ones(N, dtype=torch.bool, device=dev)
            want = qos_admission.qos_round_plain(st, ids, tks, alive, dls,
                                                 0.0, free, 256)
            got = ops.qos_round(st, ids, tks, alive, dls, 0.0, free,
                                max_units=256)
            if not qos_exact(torch, got, want):
                raise AssertionError(
                    f"ops.qos_round != plain as step() calls it: N={N} "
                    f"{case}")
            out[f"qos step() S=3 N={N} {case}"] = "bit-exact"
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

    # the up-front path's shape and qwen2-0.5b's heads (32-block tables),
    # the chunked path's (the 4096-block pool all live, 72-block tables),
    # the widest group and head (G=16, hd=1024: KT=8 tiles, one CTA an
    # SM) and a head off the 16-byte copy (hd=18, BS=4); each call twice
    # (the counters left at zero give the same result)
    for name, args in (
            ("slice", paged_case(torch, dev, seed=7, S=256, NB=4096, BS=16,
                                 MB=32, H=1, KV=1, hd=896)),
            ("qwen2-0.5b-attn", paged_case(torch, dev, seed=7, S=256,
                                           NB=4096, BS=16, MB=32, H=14,
                                           KV=2, hd=64)),
            ("chunked", chunked_decode_case(torch, dev, seed=7)),
            ("G=16 hd=1024", paged_case(torch, dev, seed=8, S=40, NB=512,
                                        BS=16, MB=12, H=16, KV=1,
                                        hd=1024)),
            ("hd=18 BS=4", paged_case(torch, dev, seed=9, S=30, NB=512,
                                      BS=4, MB=20, H=3, KV=1, hd=18))):
        err = decode_paged_check(torch, args, name)
        out[f"paged_decode {name}"] = f"max_abs_err {err:.3e}"

    for name, shape in (("slice", dict(H=1, KV=1, hd=896)),
                        ("qwen2-0.5b-attn", dict(H=14, KV=2, hd=64))):
        args, rows = prefill_case(torch, dev, seed=9, S=256, CT=64, NB=16384,
                                  BS=16, MB=72, **shape)
        out[f"paged_prefill {name}"] = (
            f"max_abs_err {prefill_check(torch, args, rows, name):.3e}")

    for N in (1000, 4096):
        for post_n in (0, 3, 256 + 5):
            args = sema_case(torch, dev, seed=N + post_n, N=N, T=256,
                             post_n=post_n)
            sema_check(torch, args, f"N={N} post_n={post_n}")
            # ticket and grant carriers, post_n and salt ints
            mixed = (args[0], args[1], args[2], args[3], post_n,
                     int(args[5]))
            sema_check(torch, mixed, f"N={N} post_n={post_n} mixed")
            out[f"sema_batch N={N} post_n={post_n}"] = "bit-exact"

    # serve_model's shape (B = slots, C = max_len) with a window and a
    # rolling ring; prefill_model's (a cache of S + 3 rows, its last tile
    # part empty); serve_dense_ring's (B = slots, C = ring)
    qwen = dict(H=14, KV=2, hd=64)
    for name, kw in (
            ("qwen2-0.5b", dict(B=MODEL_SLOTS, C=MODEL_MAX_LEN, **qwen)),
            ("qwen2-0.5b window=64", dict(B=MODEL_SLOTS, C=MODEL_MAX_LEN,
                                          window=64, **qwen)),
            ("qwen2-0.5b rolling", dict(B=MODEL_SLOTS, C=MODEL_MAX_LEN,
                                        rolling=True, **qwen)),
            ("qwen2-0.5b prefill_model", dict(
                B=PREFILL_B, C=PREFILL_S + PREFILL_EXTRA, **qwen)),
            ("dense-ring hd=896", dict(B=RING_SLOTS, C=RING_CAP, H=1, KV=1,
                                       hd=896, rolling=True)),
            ("long cache B=8 C=2048 window=300", dict(
                B=MODEL_SLOTS, C=2048, window=300, **qwen)),
            ("long cache B=1 C=2048", dict(B=1, C=2048, **qwen)),
            ("long cache B=8 C=2048 rolling", dict(
                B=MODEL_SLOTS, C=2048, rolling=True, **qwen))):
        args, window = decode_case(torch, dev, seed=21, **kw)
        err = decode_check(torch, args, window, name)
        out[f"decode_attention {name}"] = f"max_abs_err {err:.3e}"

    # S=512 causal and windowed; prefill_model's prefill (S) and its
    # longest fresh prefill (S + 3, a ragged last tile)
    for S, window in ((512, 0), (512, 128), (PREFILL_S, 0),
                      (PREFILL_S + PREFILL_EXTRA, 0)):
        args = flash_case(torch, dev, seed=23, B=PREFILL_B, S=S, **qwen)
        err = flash_check(torch, args, window, f"S={S} window={window}")
        out[f"flash_attention S={S} window={window}"] = \
            f"max_abs_err {err:.3e}"
    # gemma3-1b's attention width: hd=256, G=4 (two output slices a warp)
    for window in (0, 100):
        args = flash_case(torch, dev, seed=25, B=2, S=512, H=4, KV=1,
                          hd=256)
        err = flash_check(torch, args, window, f"hd=256 window={window}")
        out[f"flash_attention hd=256 G=4 S=512 window={window}"] = \
            f"max_abs_err {err:.3e}"
    return out


def two_streams(torch, dev, rounds: int = 8) -> dict:
    """The three split-K kernels (decode attention, paged prefill, paged
    decode), each launched ``rounds`` times on two streams in turns with
    no sync between, on different inputs: every output within 2e-5 of the
    plain version (the prefill's pools bit-equal), and each stream with
    arrival counters of its own."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import decode_attention, \
        decode_attention_plain
    from repro_torch.kernels.paged_decode import paged_decode, \
        paged_decode_plain
    from repro_torch.kernels.paged_prefill import paged_prefill, \
        paged_prefill_plain

    NB, BS, MB = CHUNK_POOL
    qwen = dict(H=14, KV=2, hd=64)

    def dec(seed):
        (q, k, v, kpos, qpos), _ = decode_case(
            torch, dev, seed=seed, B=MODEL_SLOTS, C=2048, **qwen)
        return (q, k, v, kpos, qpos)

    def pre(seed):
        args, _ = prefill_case(torch, dev, seed=seed, S=CHUNK_SLOTS,
                               CT=CHUNKED[0], H=1, KV=1, hd=896, NB=NB,
                               BS=BS, MB=MB, active=32, max_off=960)
        return args

    cases = {
        "decode_attention": (decode_attention, decode_attention_plain,
                             dec(41), dec(42)),
        "paged_prefill": (lambda *a: paged_prefill(*a)[0],
                          lambda *a: paged_prefill_plain(*a)[0],
                          pre(43), pre(44)),
        "paged_decode": (paged_decode, paged_decode_plain,
                         chunked_decode_case(torch, dev, seed=45),
                         paged_case(torch, dev, seed=46, S=SERVE_SLOTS, H=1,
                                    KV=1, hd=896, NB=SERVE_POOL[0],
                                    BS=SERVE_POOL[1], MB=SERVE_POOL[2],
                                    max_len=SERVE_MAX_LEN))}
    out = {}
    for name, (kernel, plain, a, b) in cases.items():
        want = [plain(*x) for x in (a, b)]
        pools = [tuple(t.clone() for t in x) for x in (a, b)] \
            if name == "paged_prefill" else None
        streams = [torch.cuda.Stream(dev) for _ in range(2)]
        for st in streams:
            st.wait_stream(torch.cuda.current_stream(dev))
        got = [[], []]
        for _ in range(rounds):
            for i, (st, x) in enumerate(zip(streams, (a, b))):
                with torch.cuda.stream(st):
                    got[i].append(kernel(*x))
        torch.cuda.synchronize()
        err = 0.0
        for i in range(2):
            for g in got[i]:
                err = max(err, float((g - want[i]).abs().max()))
                if not torch.allclose(g, want[i], atol=2e-5, rtol=2e-5):
                    raise AssertionError(
                        f"{name} on two streams != plain: {err}")
        if pools is not None:   # the prefill's pools as the plain writes
            for x, p0 in zip((a, b), pools):
                _, kw, vw = paged_prefill_plain(*p0)
                if not (torch.equal(x[3].view(torch.int32),
                                    kw.view(torch.int32))
                        and torch.equal(x[4].view(torch.int32),
                                        vw.view(torch.int32))):
                    raise AssertionError(f"{name} pools on two streams")
        own = {k[2] for k in build._arrivals if k[0] == name
               and k[2] in {st.cuda_stream for st in streams}}
        if len(own) != 2:
            raise AssertionError(f"{name}: the two streams share counters")
        out[name] = {"launches_per_stream": rounds, "max_abs_err": err,
                     "counter_arrays": len(own)}
    return out


def small_engine(torch, dev, trace, model_cpu, megastep_kw, **engine_kw):
    """A four-slot engine on ``dev`` with a copy of ``model_cpu``, served
    in ``megastep(8)`` calls until ``trace`` resolves.  Returns each
    request's (stream, admit round, expire round) and every sample."""
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    clk = [0.0]
    eng = ContinuousBatchingEngine(None, None, 4, use_kernel=True,
                                   clock=lambda: clk[0], device=dev,
                                   **engine_kw)
    eng.megastep_model = {k: v.clone().to(dev) for k, v in model_cpu.items()}
    reqs = [Request(**t) for t in trace]
    eng.submit_batch(reqs)
    samples = []
    for _ in range(20):
        eng.megastep(8, nows=[k * 0.25 for k in range(8)], **megastep_kw)
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

    from repro_torch.serving import engine_state as es
    from repro_torch.serving.engine_state import make_paged_pool_model

    rng = np.random.default_rng(SEED)
    names = ["gold", "silver", "bronze"]
    trace = [dict(rid=i, prompt=[int(x) for x in rng.integers(1, 50, int(
        rng.integers(1, 8)))], max_new_tokens=int(rng.integers(1, 16)),
        tenant_id=names[i % 3],
        deadline=(float(rng.integers(2, 12)) if i % 4 == 0 else None))
        for i in range(24)]
    model = make_paged_pool_model(torch.Generator().manual_seed(SEED), 50, 16,
                                  32, 4, device="cpu")
    kw = dict(tenants=dict(WEIGHTS), prompt_cap=8, kv_pool=(32, 4, 8))
    fns = dict(token_fn=es.paged_pool_token_fn,
               admit_fn=es.paged_pool_admit_fn)
    gpu = small_engine(torch, dev, trace, model, fns, **kw)
    cpu = small_engine(torch, torch.device("cpu"), trace, model, fns, **kw)
    if gpu != cpu:
        raise AssertionError("engine on the card != engine on the CPU")
    return {"requests": len(trace), "rounds": len(gpu[1]),
            "tokens": sum(len(t[0]) for t in gpu[0]),
            "equal_to_cpu": True}


def serve_small_chunked(torch, dev) -> dict:
    """The chunked engine with the prefix cache and the paged-pool model
    on the card (all three kernels) against the same engine on the CPU
    (plain versions): a 16-block pool, prompts repeating an 8-token
    system prompt and, often, a recent whole prompt."""
    import numpy as np

    from repro_torch.serving import engine_state as es
    from repro_torch.serving.engine_state import make_paged_pool_model

    rng = np.random.default_rng(24)
    trace = []
    for i in range(16):
        dl = 0.25 * int(rng.integers(1, 24)) if rng.random() < 0.35 else None
        if i >= 4 and rng.random() < 0.4:
            prompt = list(trace[int(rng.integers(i - 4, i))]["prompt"])
        else:
            prompt = [7] * 8 + [1 + int(x) for x in
                                rng.integers(1, 6, int(rng.integers(0, 11)))]
        mx = 1 + int(rng.integers(0, 12))
        tenant = ("gold", "bronze")[int(rng.integers(0, 2))]
        trace.append(dict(rid=i, prompt=prompt, max_new_tokens=mx,
                          tenant_id=tenant, deadline=dl))
    model = make_paged_pool_model(torch.Generator().manual_seed(SEED), 50, 16,
                                  16, 4, device="cpu")
    kw = dict(tenants={"gold": 2.0, "bronze": 1.0}, prompt_cap=32,
              kv_pool=(16, 4, 8), chunked_prefill=(5, 9, 16), prefix_cache=8)
    fns = dict(token_fn=es.make_chunked_prefill_token_fn(5))
    gpu = small_engine(torch, dev, trace, model, fns, **kw)
    cpu = small_engine(torch, torch.device("cpu"), trace, model, fns, **kw)
    if gpu != cpu:
        raise AssertionError("chunked engine on the card != on the CPU")
    samples = gpu[1]
    return {"requests": len(trace), "rounds": len(samples),
            "tokens": sum(len(t[0]) for t in gpu[0]),
            "prefix_hits": sum(x["prefix_hits"] for x in samples),
            "cow_copies": sum(x["cow_copies"] for x in samples),
            "parked": sum(x["parked"] for x in samples),
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


def drive(torch, dev, eng, reqs, megastep, limit: int):
    """Run ``megastep`` until every request is resolved (at most ``limit``
    megasteps), with the launch counts set to 0 just before and read just
    after.  Returns the samples, each megastep's wall ms, the total wall
    seconds, the launch counts and the checks every path must pass."""
    from repro_torch.kernels import ops

    vocab = eng.megastep_model["emb"].shape[0]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    samples, step_ms = [], []
    while not all(r.done_event.is_set() for r in reqs):
        if len(step_ms) == limit:
            raise AssertionError("the serve loop did not resolve every "
                                 "request")
        t1 = time.perf_counter()
        samples += megastep()
        step_ms.append(1e3 * (time.perf_counter() - t1))
    sync()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    finished = [r for r in reqs if not r.expired]
    checks = {
        "all_resolved": all(r.done_event.is_set() for r in reqs),
        "health_zero": all(s["health"] == 0 for s in samples),
        "one_sync_per_megastep": eng.stats.host_syncs == len(step_ms),
        "finished_full_length": all(len(r.out_tokens) == r.max_new_tokens
                                    for r in finished),
        "tokens_in_vocab": all(0 <= t < vocab for r in reqs
                               for t in r.out_tokens),
        "pool_drained": (eng._kv_pool is None or eng.telemetry()[
            "kv_blocks_free"] == eng._kv_blocks),
    }
    return samples, step_ms, wall, launches, checks


def serve(torch, dev, **sizes) -> dict:
    """The up-front path: serve until every request is finished or
    expired."""
    eng, reqs, megastep = serve_engine(torch, dev, **sizes)
    S, K = eng.n_slots, 32
    n_req = len(reqs)
    samples, step_ms, wall, launches, checks = drive(
        torch, dev, eng, reqs, megastep, limit=64)
    megasteps = len(step_ms)
    tokens = sum(len(r.out_tokens) for r in reqs)
    gate_stalls = sum(s["gate_stalls"] for s in samples)
    checks.update({
        "kernels_launched": (launches["qos_round_fused"] > 0
                             and launches["paged_decode"] > 0),
        "block_gate_stalled": gate_stalls > 0,
    })
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


def chunked_engine(torch, dev, *, n_req=CHUNK_REQUESTS, vocab=151936, d=896):
    """The serve_chunked configuration at qwen2-0.5b's full width: the
    engine with its model and ``n_req`` submitted requests, plus a
    function that runs one ``megastep(32)`` and returns its samples."""
    from repro_torch.serving import engine_state as es
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    K, DT = 32, 1.0
    NB, BS, _ = CHUNK_POOL
    clk = [0.0]
    eng = ContinuousBatchingEngine(
        None, None, CHUNK_SLOTS, tenants=dict(WEIGHTS), use_kernel=True,
        clock=lambda: clk[0], backlog_cap=4096, prompt_cap=CHUNK_PROMPT_CAP,
        kv_pool=CHUNK_POOL, chunked_prefill=CHUNKED,
        prefix_cache=PREFIX_ENTRIES, device=dev)
    eng.megastep_model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    reqs = [Request(**t) for t in chunked_requests(n_req, vocab)]
    eng.submit_batch(reqs)
    token_fn = es.make_chunked_prefill_token_fn(CHUNKED[0])

    def megastep():
        eng.megastep(K, token_fn=token_fn, nows=[k * DT for k in range(K)])
        clk[0] += K * DT
        return eng.telemetry()["last_samples"]

    return eng, reqs, megastep


def serve_chunked(torch, dev) -> dict:
    """The chunked path with prefix sharing: serve until every request is
    resolved."""
    eng, reqs, megastep = chunked_engine(torch, dev)
    K = 32
    repeats = sum(1 for i, r in enumerate(reqs)
                  if any(r.prompt == x.prompt for x in reqs[:i]))
    samples, step_ms, wall, launches, checks = drive(
        torch, dev, eng, reqs, megastep, limit=40)
    megasteps = len(step_ms)
    tokens = sum(len(r.out_tokens) for r in reqs)
    tot = {k: sum(x[k] for x in samples) for k in (
        "parked", "prefix_hits", "cow_copies", "prefill_chunks",
        "prefill_tokens", "gate_stalls", "tokens")}
    checks.update({
        "kernels_launched": all(launches[k] > 0 for k in (
            "qos_round_fused", "paged_decode", "paged_prefill")),
        "parked": tot["parked"] > 0,
        "prefix_hits": tot["prefix_hits"] > 0,
        "cow_copies": tot["cow_copies"] > 0,
        "prefill_chunks": tot["prefill_chunks"] > 0,
    })
    if not all(checks.values()):
        raise AssertionError(f"serve_chunked checks failed: {checks}")
    return {
        "requests": len(reqs), "exact_repeats": repeats,
        "finished": eng.stats.finished, "expired": eng.stats.expired,
        "preempted": eng.stats.preempted, "megasteps": megasteps,
        "rounds": megasteps * K, "busy_rounds": eng.stats.steps,
        "decode_tokens": tokens, **{f"sum_{k}": v for k, v in tot.items()},
        "admits_per_tenant": dict(eng.tenant_admitted),
        "megastep_ms": step_ms, "wall_s": wall,
        "decode_tokens_per_s": tokens / wall,
        "prompt_tokens_per_s": tot["prefill_tokens"] / wall,
        "ms_per_round": 1e3 * wall / (megasteps * K),
        "host_syncs": eng.stats.host_syncs, "launches": launches,
        "sync_debug_mode": "error", "checks": checks,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def serve_model_small(torch, dev) -> dict:
    """The single-tenant serving driver on the card (sema_batch pass in
    ``submit_batch`` with ``use_kernel``, decode kernel) against the same
    driver, trace and weights on the CPU (plain versions): the
    qwen2-0.5b smoke config, 10 requests over 3 slots."""
    import numpy as np

    from repro_torch.launch.serve import ModelServer
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    cpu = torch.device("cpu")
    base = ModelServer("qwen2-0.5b", 3, device=cpu)
    rng = np.random.default_rng(SEED)
    trace = [dict(rid=i, prompt=[int(x) for x in rng.integers(
        1, base.cfg.vocab, int(rng.integers(2, 9)))],
        max_new_tokens=int(rng.integers(2, 9))) for i in range(10)]
    runs = {}
    for d in (dev, cpu):
        params = _tree_to(base.params, d)
        server = ModelServer("qwen2-0.5b", 3, params=params, device=d)
        eng = ContinuousBatchingEngine(
            server.step_fn, server.prefill_request, 3, use_kernel=True,
            clock=lambda: 0.0, device=d)
        reqs = [Request(**t) for t in trace]
        eng.submit_batch(reqs[:6])
        samples = []
        for step in range(200):
            if step == 3:
                eng.submit_batch(reqs[6:])
            if step > 3 and eng.stats.finished == len(reqs):
                break
            eng.step(lambda lg: lg.argmax(-1))
            samples += eng.telemetry()["last_samples"]
        runs[d.type] = ([(r.out_tokens, r.ticket, r.bucket, r.observed_seq)
                         for r in reqs], samples, eng.stats.__dict__.copy())
    if runs["cuda"] != runs["cpu"]:
        raise AssertionError("single-tenant serve on the card != on the CPU")
    return {"requests": len(trace), "steps": len(runs["cuda"][1]),
            "tokens": sum(len(t[0]) for t in runs["cuda"][0]),
            "equal_to_cpu": True}


def _tree_to(tree, dev):
    """A nested dict/list of tensors copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def model_requests(vocab: int, seed: int = SEED) -> list:
    """The serve_model trace as ``Request`` keyword dicts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(*MODEL_PROMPT)))],
        max_new_tokens=int(rng.integers(*MODEL_NEW)))
        for i in range(MODEL_REQUESTS)]


def device_profile(torch, fn, calls: int = 1) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: kernel launches and
    device time per call (device-side kernel events only) and the top
    kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    return {"launches": sum(e.count for e in kernels) / calls,
            "device_ms": sum(e.self_device_time_total
                             for e in kernels) / 1e3 / calls,
            "top": [{"name": e.key[:80],
                     "ms": e.self_device_time_total / 1e3 / calls,
                     "count": e.count / calls} for e in top],
            "ms_by_kernel": {e.key: e.self_device_time_total / 1e3 / calls
                             for e in kernels},
            "per_launch": {e.key: (e.self_device_time_total / 1e3 / e.count,
                                   e.count) for e in kernels}}


def launches_per_call(torch, fn, name: str, calls: int = 20) -> float:
    """Kernel launches a call of ``fn`` by the wrapper's own counter
    (`build.LAUNCHES`), which counts each launch it makes."""
    from repro_torch.kernels import build

    before = build.LAUNCHES[name]
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (build.LAUNCHES[name] - before) / calls


def kernel_device_ms(torch, fn, name: str, calls: int = 200,
                     tries: int = 3) -> float:
    """Device time of one launch of the kernel ``name`` (``fn`` launches
    it once), the mean over the launches that ``calls`` calls under the
    profiler recorded: divided by the events seen, not by the calls made,
    since the profiler keeps fewer events than were launched (0.1–0.3 a
    call for the kernels launched through `ctypes`, none of 20 calls at
    times: then the calls are profiled again, up to ``tries`` times)."""
    for _ in range(tries):
        prof = device_profile(torch, fn, calls=calls)
        hits = [v for key, v in prof["per_launch"].items() if name in key]
        if hits:
            return sum(ms * n for ms, n in hits) / sum(n for _, n in hits)
    raise AssertionError(f"{name} not among the profiled kernels in "
                         f"{tries} profiles of {calls} calls")


def serve_model(torch, dev, cfg=None) -> dict:
    """The single-tenant path, by default at the full qwen2-0.5b config: two
    ``submit_batch`` waves (the sema_batch kernel), ``step()`` to
    completion (every decode through the decode-attention kernel; each
    prompt replayed through full-batch decode steps, as the reference's
    server does)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ModelServer
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    cfg = cfg or get_config("qwen2-0.5b")
    server = ModelServer("qwen2-0.5b", MODEL_SLOTS, max_len=MODEL_MAX_LEN,
                         seed=SEED, config=cfg, device=dev)
    eng = ContinuousBatchingEngine(server.step_fn, server.prefill_request,
                                   MODEL_SLOTS, use_kernel=True, device=dev)
    reqs = [Request(**t) for t in model_requests(cfg.vocab)]
    half = len(reqs) // 2
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.submit_batch(reqs[:half])
    step_ms, steps = [], 0
    while eng.stats.finished < len(reqs):
        if steps == MODEL_WAVE2_AT:
            eng.submit_batch(reqs[half:])
        if steps == 5000:
            raise AssertionError("serve_model did not finish every request")
        t1 = time.perf_counter()
        eng.step(lambda lg: lg.argmax(-1))
        step_ms.append(1e3 * (time.perf_counter() - t1))
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    tel = eng.telemetry()
    tokens = sum(len(r.out_tokens) for r in reqs)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    decode_calls = prompt_tokens + eng.stats.steps
    # launches of one full-batch decode step (one replayed prompt token
    # or one engine step), its device time and top kernels
    step_prof = device_profile(torch, server._decode)
    by_kernel = step_prof.pop("ms_by_kernel")
    step_prof.pop("per_launch")
    decode_kernel_ms = sum(ms for key, ms in by_kernel.items()
                           if "decode_attention_kernel" in key)
    checks = {
        "all_finished": eng.stats.finished == len(reqs),
        "full_length": all(len(r.out_tokens) == r.max_new_tokens
                           for r in reqs),
        "queue_depth_zero": tel["queue_depth"] == 0,
        "tokens_in_vocab": all(0 <= t < cfg.vocab for r in reqs
                               for t in r.out_tokens),
        "sema_batch_launched": launches["sema_batch"] > 0,
        "decode_attention_launched": launches["decode_attention"] > 0,
        "one_sync_per_step": eng.stats.host_syncs == steps,
    }
    if not all(checks.values()):
        raise AssertionError(f"serve_model checks failed: {checks}")
    return {
        "config": cfg.name, "layers": cfg.n_layers, "slots": MODEL_SLOTS,
        "max_len": MODEL_MAX_LEN, "requests": len(reqs), "steps": steps,
        "busy_steps": eng.stats.steps, "tokens": tokens,
        "prompt_tokens": prompt_tokens, "decode_calls": decode_calls,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "ms_per_step": 1e3 * wall / steps,
        "ms_per_decode_call": 1e3 * wall / decode_calls,
        "median_step_ms": sorted(step_ms)[len(step_ms) // 2],
        "backlog_scans": eng.stats.backlog_scans,
        "backlog_skipped": eng.stats.backlog_skipped,
        "host_syncs": eng.stats.host_syncs, "launches": launches,
        "launches_per_decode_step": step_prof["launches"],
        "device_ms_per_decode_step": step_prof["device_ms"],
        "decode_step_top_kernels": step_prof["top"],
        "decode_attention_kernel_ms_per_decode_step": decode_kernel_ms,
        "checks": checks,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def prefill_model(torch, dev, cfg=None) -> dict:
    """The full config's (by default) prefill (flash kernel) on B × S
    tokens, then
    decode steps (decode kernel), each held to a fresh prefill over the
    longer prefix within 2e-3."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tt

    cfg = cfg or get_config("qwen2-0.5b")
    B, S, extra = PREFILL_B, PREFILL_S, PREFILL_EXTRA
    params = tt.init_params(torch.Generator(device=dev).manual_seed(SEED),
                            cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (B, S + extra), generator=g,
                         device=dev)

    def fresh():
        return tt.init_caches(cfg, B, S + extra, torch.float32, device=dev)

    caches = fresh()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, caches = tt.prefill(params, cfg, {"tokens": toks[:, :S]}, caches)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    errs, decode_ms = [], []
    for t in range(extra):
        pos = torch.full((B, 1), S + t, dtype=torch.int32, device=dev)
        t1 = time.perf_counter()
        got, caches = tt.decode_step(params, cfg, toks[:, S + t:S + t + 1],
                                     pos, caches)
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t1))
        want, _ = tt.prefill(params, cfg, {"tokens": toks[:, :S + t + 1]},
                             fresh())
        errs.append(float((got - want).abs().max()))
        if not torch.allclose(got, want, atol=2e-3, rtol=2e-3):
            raise AssertionError(f"decode step {t} != prefill over the "
                                 f"longer prefix: {errs[-1]}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    checks = {
        "finite": bool(torch.isfinite(logits).all()),
        "shape": tuple(logits.shape) == (B, cfg.vocab),
        "flash_attention_launched": launches["flash_attention"] > 0,
        "decode_attention_launched": launches["decode_attention"] > 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"prefill_model checks failed: {checks}")
    return {"config": cfg.name, "B": B, "S": S, "decode_steps": extra,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "decode_vs_prefill_max_abs_err": errs, "tolerance": 2e-3,
            "launches": launches, "checks": checks,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def dense_ring_engine(torch, dev, *, vocab=151936, d=896,
                      n_req=RING_REQUESTS):
    """The dense-ring configuration, by default at qwen2-0.5b width: the
    engine with its model and ``n_req`` submitted requests, plus a
    function that runs one ``megastep(32)`` and returns its samples."""
    import numpy as np

    from repro_torch.serving import engine_state as es
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    K, DT = 32, 1.0
    clk = [0.0]
    eng = ContinuousBatchingEngine(
        None, None, RING_SLOTS, tenants=dict(WEIGHTS), use_kernel=True,
        clock=lambda: clk[0], backlog_cap=4096, prompt_cap=128, device=dev)
    eng.megastep_model = es.make_paged_attn_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, RING_SLOTS,
        RING_CAP, device=dev)
    rng = np.random.default_rng(SEED)
    reqs = [Request(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(16, 129)))],
        max_new_tokens=int(rng.integers(16, 129)),
        tenant_id=TENANTS[int(rng.integers(0, 3))],
        deadline=(DT * float(rng.integers(40, 320))
                  if rng.random() < 0.25 else None))
        for i in range(n_req)]
    eng.submit_batch(reqs)

    def megastep():
        eng.megastep(K, token_fn=es.paged_attn_token_fn,
                     admit_fn=es.paged_attn_admit_fn,
                     nows=[k * DT for k in range(K)])
        clk[0] += K * DT
        return eng.telemetry()["last_samples"]

    return eng, reqs, megastep


def serve_dense_ring(torch, dev) -> dict:
    """The dense-ring demo model in the QoS megastep at qwen2-0.5b width:
    one ring of 256 rows per slot, every decode through the
    decode-attention kernel (H = KV = 1, hd = 896), admission through
    the QoS kernel; served until every request resolves."""
    K = 32
    eng, reqs, megastep = dense_ring_engine(torch, dev)
    samples, step_ms, wall, launches, checks = drive(
        torch, dev, eng, reqs, megastep, limit=40)
    checks["kernels_launched"] = (launches["qos_round_fused"] > 0
                                  and launches["decode_attention"] > 0)
    if not all(checks.values()):
        raise AssertionError(f"serve_dense_ring checks failed: {checks}")
    tokens = sum(len(r.out_tokens) for r in reqs)
    return {"requests": len(reqs), "slots": RING_SLOTS, "ring": RING_CAP,
            "finished": eng.stats.finished, "expired": eng.stats.expired,
            "megasteps": len(step_ms), "rounds": len(step_ms) * K,
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ms_per_round": 1e3 * wall / (len(step_ms) * K),
            "host_syncs": eng.stats.host_syncs, "launches": launches,
            "sync_debug_mode": "error", "checks": checks,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


# ------------------------------------------ the host step() twin phases ---


def rid_step_fn(active):
    """The host counterpart of `engine_state.rid_token_fn`: logits that
    ARE the request-identity token (rid·1000 + tokens emitted)."""
    import numpy as np

    return np.array([r.rid * 1000 + len(r.out_tokens) for r in active],
                    np.int64)


def _ident(logits):
    return logits.astype("int64")


def rid_through(token_fn, vocab: int):
    """A megastep token function that runs ``token_fn``'s model round (its
    paged kernels write and read the pool; the rid tokens it is fed are
    taken modulo ``vocab``) and emits the rid tokens, so the megastep's
    streams are the host ``step()``'s rid streams."""
    from repro_torch.serving import engine_state as es

    def fn(model, state):
        sl = state.slots
        _, model = token_fn(model, state._replace(
            slots=sl._replace(token=sl.token % vocab)))
        return es.rid_token_fn(model, state)

    fn._chunk_window = getattr(token_fn, "_chunk_window", None)
    return fn


def step_requests(n_req: int, vocab: int, seed: int = SEED) -> list:
    """The serve trace (prompts and ``max_new`` 16–128, three tenants)
    with a quarter of the requests given deadlines on the 0.25 grid
    (10–320 virtual seconds), where the host's f64 and the card's f32
    deadline compares cannot disagree."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(16, 129)))],
        max_new_tokens=int(rng.integers(16, 129)),
        tenant_id=TENANTS[int(rng.integers(0, 3))],
        deadline=(0.25 * float(rng.integers(40, 1281))
                  if rng.random() < 0.25 else None))
        for i in range(n_req)]


def spans_view(spans: dict) -> dict:
    """Per request: the span's terminal, its event kinds in order and its
    critical-path breakdown (what the two serving paths must share; the
    buffers' insertion sequence numbers differ, since a megastep adds its
    expiries before the rounds' events)."""
    return {uid: (sp["terminal"], [e["kind"] for e in sp["events"]],
                  sp["breakdown"]) for uid, sp in spans.items()}


def _qos_state(eng) -> dict:
    from repro_torch.serving.engine_state import drain

    st = drain(eng.qos)
    return {f: getattr(st, f).tolist() for f in st._fields}


def _kv_sema(eng):
    from repro_torch.serving.engine_state import drain

    s = drain(eng._kv_sema)
    return (int(s.ticket), int(s.grant), s.bucket_seq.tolist())


def step_vs_megastep(torch, dev, *, S, trace, engine_kw, token_fn,
                     admit_fn=None, model=None, K=32, limit=64) -> dict:
    """The host ``step()`` and ``megastep(K)`` of two engines on one trace
    and one virtual clock (1.0 a round), each driven with the launch
    counts set to 0 just before and read just after: the megastep until
    every request resolves, then as many host steps as it ran rounds.
    Checks that the two paths are bit-identical (streams, rounds, the QoS
    state, the free pool, the block-semaphore mirror, every sample with
    its events, the trace spans) and that each host step with a live
    backlog launched the QoS kernel exactly once."""
    from repro_torch.kernels import ops
    from repro_torch.obs import build_spans
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    DT = 1.0
    clk_h, clk_m = [0.0], [0.0]
    eh = ContinuousBatchingEngine(rid_step_fn, lambda r: None, S,
                                  tenants=dict(WEIGHTS), use_kernel=True,
                                  clock=lambda: clk_h[0], device=dev,
                                  **engine_kw)
    em = ContinuousBatchingEngine(None, None, S, tenants=dict(WEIGHTS),
                                  use_kernel=True, clock=lambda: clk_m[0],
                                  device=dev, **engine_kw)
    em.megastep_model = model
    rh = [Request(**t) for t in trace]
    rm = [Request(**t) for t in trace]
    eh.submit_batch(rh)
    em.submit_batch(rm)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ms, mega_ms = [], []
    while not all(r.done_event.is_set() for r in rm):
        if len(mega_ms) == limit:
            raise AssertionError("the megastep did not resolve every "
                                 "request")
        t1 = time.perf_counter()
        em.megastep(K, token_fn=token_fn, admit_fn=admit_fn,
                    nows=[k * DT for k in range(K)])
        clk_m[0] += K * DT
        ms += em._last_samples
        mega_ms.append(1e3 * (time.perf_counter() - t1))
    torch.cuda.synchronize()
    mega_wall = time.perf_counter() - t0
    mega_launches = ops.launch_counts()

    rounds = len(mega_ms) * K
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hs, step_ms, backlog_steps = [], [], 0
    for j in range(rounds):
        clk_h[0] = j * DT
        backlog_steps += int(eh._tenant_live.sum() > 0)
        t1 = time.perf_counter()
        eh.step(_ident)
        step_ms.append(1e3 * (time.perf_counter() - t1))
        hs += eh._last_samples
    torch.cuda.synchronize()
    step_wall = time.perf_counter() - t0
    step_launches = ops.launch_counts()

    fields = ("out_tokens", "admit_round", "expire_round", "preempted",
              "expired", "first_tok_clock", "last_tok_clock", "finish_clock")
    diff = [r.rid for r, q in zip(rh, rm)
            if any(getattr(r, f) != getattr(q, f) for f in fields)]
    qos_h, qos_m = _qos_state(eh), _qos_state(em)
    checks = {
        "all_resolved": all(r.done_event.is_set() for r in rh + rm),
        "requests_equal": not diff,
        "qos_equal": qos_h == qos_m,
        "qos_free_equal": eh._qos_free == em._qos_free,
        "kv_free_equal": eh._kv_free_blocks == em._kv_free_blocks,
        "kv_sema_equal": _kv_sema(eh) == _kv_sema(em),
        "samples_equal": hs == ms,
        "spans_equal": spans_view(build_spans(eh._trace))
        == spans_view(build_spans(em._trace)),
        "health_zero": all(s["health"] == 0 for s in hs),
        "host_syncs": (eh.stats.host_syncs == rounds
                       and em.stats.host_syncs == len(mega_ms)),
        "one_qos_launch_per_step": (step_launches["qos_round_fused"]
                                    == backlog_steps > 0),
        "pool_drained": eh._kv_free_blocks == eh._kv_blocks,
        "finished_full_length": all(
            len(r.out_tokens) == r.max_new_tokens for r in rh
            if not r.expired),
    }
    out = {
        "requests": len(trace), "slots": S, "rounds": rounds,
        "megasteps": len(mega_ms), "finished": eh.stats.finished,
        "expired": eh.stats.expired, "preempted": eh.stats.preempted,
        "tokens": sum(len(r.out_tokens) for r in rh),
        "first_request_diff": diff[:5],
        "first_sample_diff": next(
            ([k, sorted(f for f in a if a[f] != b.get(f))]
             for k, (a, b) in enumerate(zip(hs, ms)) if a != b), None),
        "step_wall_s": step_wall, "ms_per_step": 1e3 * step_wall / rounds,
        "median_step_ms": sorted(step_ms)[len(step_ms) // 2],
        "max_step_ms": max(step_ms),
        "megastep_wall_s": mega_wall,
        "megastep_ms_per_round": 1e3 * mega_wall / rounds,
        "steps_with_backlog": backlog_steps,
        "qos_launches_per_step_with_backlog": (
            step_launches["qos_round_fused"] / max(backlog_steps, 1)),
        "qos_launches_per_step": step_launches["qos_round_fused"] / rounds,
        "launches_step": step_launches, "launches_megastep": mega_launches,
        "launches": {k: step_launches[k] + mega_launches[k]
                     for k in step_launches},
        "host_syncs_step": eh.stats.host_syncs,
        "host_syncs_megastep": em.stats.host_syncs,
        "gate_stalls": sum(s["gate_stalls"] for s in hs),
        "parked": sum(s["parked"] for s in hs),
        "prefix_hits": eh.stats.prefix_hits,
        "cow_copies": eh.stats.cow_copies,
        "admits_per_tenant": dict(eh.tenant_admitted),
    }
    return eh, em, out, checks


def serve_step(torch, dev, *, vocab=151936, d=896) -> dict:
    """The up-front configuration at full size on the card: 256 slots,
    ``kv_pool=(2048, 16, 32)``, ``prompt_cap=128``, tenants 4:2:1, ~1000
    requests, ``use_kernel=True``; the host ``step()`` with the rid step
    function against ``megastep(32)`` over the paged-pool model at
    qwen2-0.5b's width (its paged-decode kernel runs; the rid tokens are
    emitted)."""
    from repro_torch.serving import engine_state as es

    NB, BS, _ = SERVE_POOL
    model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    eh, em, out, checks = step_vs_megastep(
        torch, dev, S=SERVE_SLOTS, trace=step_requests(SERVE_REQUESTS,
                                                       vocab),
        engine_kw=dict(backlog_cap=4096, prompt_cap=128, kv_pool=SERVE_POOL),
        token_fn=rid_through(es.paged_pool_token_fn, vocab),
        admit_fn=es.paged_pool_admit_fn, model=model)
    launches = out["launches"]
    checks.update({
        "block_gate_stalled": out["gate_stalls"] > 0,
        "deadlines_hit": out["expired"] > 0,
        "kernels_launched": (launches["qos_round_fused"] > 0
                             and launches["paged_decode"] > 0),
    })
    if not all(checks.values()):
        raise AssertionError(f"serve_step checks failed: {checks} {out}")
    return {**out, "checks": checks, "sync_debug_mode": "error (megastep)",
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def serve_step_chunked(torch, dev, *, vocab=151936, d=896) -> dict:
    """The chunked configuration with prefix sharing at full size: 256
    slots, ``kv_pool=(4096, 16, 72)``, ``prompt_cap=1024``,
    ``chunked_prefill=(64, 1024, 6144)``, ``prefix_cache=8192``, the
    serve_chunked trace; the host ``step()`` with the rid step function
    against ``megastep(32)`` over the paged-pool model (its paged-prefill
    and paged-decode kernels run; the rid tokens are emitted).  Slots
    must park, prefixes hit and blocks copy on write; after the run the
    host replica must equal the device pool (refcounts, table, free
    queue)."""
    from repro_torch.serving import engine_state as es
    from repro_torch.serving.engine_state import drain

    NB, BS, _ = CHUNK_POOL
    model = es.make_paged_pool_model(
        torch.Generator(device=dev).manual_seed(SEED), vocab, d, NB, BS,
        device=dev)
    eh, em, out, checks = step_vs_megastep(
        torch, dev, S=CHUNK_SLOTS, trace=chunked_requests(CHUNK_REQUESTS,
                                                          vocab),
        engine_kw=dict(backlog_cap=4096, prompt_cap=CHUNK_PROMPT_CAP,
                       kv_pool=CHUNK_POOL, chunked_prefill=CHUNKED,
                       prefix_cache=PREFIX_ENTRIES),
        token_fn=rid_through(es.make_chunked_prefill_token_fn(CHUNKED[0]),
                             vocab),
        model=model, limit=40)
    rep = drain((eh._kv_hpool.refcnt, eh._kv_htbl, eh._kv_hpool.free_q,
                 eh._kv_hpool.gen))
    dev_pool = drain((em._kv_state.pool.refcnt, em._kv_state.tbl,
                      em._kv_state.pool.free_q, em._kv_state.pool.gen))
    launches = out["launches"]
    checks.update({
        "parked": out["parked"] > 0,
        "prefix_hits": out["prefix_hits"] > 0,
        "cow_copies": out["cow_copies"] > 0,
        "replica_equals_device_pool": all(
            (a == b).all() for a, b in zip(rep, dev_pool)),
        "kernels_launched": all(launches[k] > 0 for k in (
            "qos_round_fused", "paged_decode", "paged_prefill")),
    })
    if not all(checks.values()):
        raise AssertionError(f"serve_step_chunked checks failed: {checks} "
                             f"{out}")
    return {**out, "checks": checks,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def qos_model_requests(vocab: int, seed: int = SEED) -> list:
    """The serve_model_qos trace as ``Request`` keyword dicts: prompts and
    ``max_new`` 16–64 tokens, three tenants, a quarter with deadlines on
    the 0.25 grid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=[int(x) for x in rng.integers(
        1, vocab, int(rng.integers(*MODEL_PROMPT)))],
        max_new_tokens=int(rng.integers(*MODEL_NEW)),
        tenant_id=TENANTS[int(rng.integers(0, 3))],
        deadline=(0.25 * float(rng.integers(40, 401))
                  if rng.random() < 0.25 else None))
        for i in range(QOS_MODEL_REQUESTS)]


def serve_model_qos(torch, dev, cfg=None) -> dict:
    """The multi-tenant host ``step()`` at full model width:
    `launch.serve.ModelServer` over the full qwen2-0.5b config (by
    default; random weights from the seed), 8 slots, tenants 4:2:1,
    ``use_kernel=True``, 16 requests, against the same trace through a CPU
    engine with the rid step function: admission does not depend on the
    logits (requests finish at ``max_new``), so the admission and finish
    rounds, slots and every sample with its events must be equal; every
    logit must be finite."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import ModelServer
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    cfg = cfg or get_config("qwen2-0.5b")
    trace = qos_model_requests(cfg.vocab)
    server = ModelServer("qwen2-0.5b", MODEL_SLOTS, max_len=MODEL_MAX_LEN,
                         seed=SEED, config=cfg, device=dev)
    finite = []

    def step_fn(reqs):
        logits = server.step_fn(reqs)
        finite.append(bool(np.isfinite(logits).all()))
        return logits

    def prefill_fn(req):
        server.prefill_request(req)
        finite.append(bool(np.isfinite(req._last_logits).all()))

    runs = {}
    for kind in ("model", "rid"):
        d = dev if kind == "model" else torch.device("cpu")
        clk = [0.0]
        eng = ContinuousBatchingEngine(
            step_fn if kind == "model" else rid_step_fn,
            prefill_fn if kind == "model" else (lambda r: None),
            MODEL_SLOTS, tenants=dict(WEIGHTS), use_kernel=True,
            clock=lambda: clk[0], device=d)
        reqs = [Request(**t) for t in trace]
        if kind == "model":
            torch.cuda.synchronize()
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.submit_batch(reqs)
        samples, steps, backlog_steps = [], 0, 0
        while not all(r.done_event.is_set() for r in reqs):
            if steps == 5000:
                raise AssertionError("serve_model_qos did not resolve "
                                     "every request")
            clk[0] = float(steps)
            backlog_steps += int(eng._tenant_live.sum() > 0)
            eng.step(lambda lg: lg.argmax(-1) if kind == "model"
                     else _ident(lg))
            samples += eng._last_samples
            steps += 1
        if kind == "model":
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        runs[kind] = (eng, reqs, samples, time.perf_counter() - t0,
                      backlog_steps)
    (em, rm, sm, wall, backlog_steps), (ec, rc, sc, _, _) = \
        runs["model"], runs["rid"]
    view = [(r.admit_round, r.expire_round, r.slot, r.preempted, r.expired,
             len(r.out_tokens)) for r in rm]
    checks = {
        "all_resolved": all(r.done_event.is_set() for r in rm),
        "rounds_slots_equal": view == [
            (r.admit_round, r.expire_round, r.slot, r.preempted, r.expired,
             len(r.out_tokens)) for r in rc],
        "samples_equal": sm == sc,
        "stats_equal": all(getattr(em.stats, f) == getattr(ec.stats, f)
                           for f in ("admitted", "finished", "expired",
                                     "preempted", "steps", "host_syncs")),
        "logits_finite": all(finite) and bool(finite),
        "health_zero": all(s["health"] == 0 for s in sm),
        "finished_full_length": all(len(r.out_tokens) == r.max_new_tokens
                                    for r in rm if not r.expired),
        "tokens_in_vocab": all(0 <= t < cfg.vocab for r in rm
                               for t in r.out_tokens),
        "one_qos_launch_per_step": (launches["qos_round_fused"]
                                    == backlog_steps > 0),
        "decode_attention_launched": launches["decode_attention"] > 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"serve_model_qos checks failed: {checks}")
    steps = len(sm)
    tokens = sum(len(r.out_tokens) for r in rm)
    return {"config": cfg.name, "layers": cfg.n_layers, "slots": MODEL_SLOTS,
            "requests": len(trace), "steps": steps,
            "finished": em.stats.finished, "expired": em.stats.expired,
            "preempted": em.stats.preempted, "tokens": tokens,
            "wall_s": wall, "ms_per_step": 1e3 * wall / steps,
            "tokens_per_s": tokens / wall,
            "steps_with_backlog": backlog_steps,
            "qos_launches_per_step_with_backlog": (
                launches["qos_round_fused"] / max(backlog_steps, 1)),
            "qos_launches_per_step": launches["qos_round_fused"] / steps,
            "host_syncs": em.stats.host_syncs, "launches": launches,
            "checks": checks,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def profile_rounds(torch, megastep, ours) -> dict:
    """One warm megastep timed without the profiler, one under
    torch.profiler: device busy time (the sum of kernel times) over each
    wall time, launches, the top kernels and the ported ones."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    mine = {name: {"ms_per_launch": e.self_device_time_total / 1e3 / e.count,
                   "launches": e.count,
                   "share_of_busy": e.self_device_time_total / busy_us}
            for e in kernels for name in ours if name in e.key}
    launches = sum(e.count for e in kernels)
    return {"rounds": 32,
            "wall_ms_unprofiled": 1e3 * plain_wall,
            "wall_ms_profiled": 1e3 * wall,
            "device_busy_ms": busy_us / 1e3,
            "busy_share_of_unprofiled_wall": busy_us / 1e6 / plain_wall,
            "busy_share_of_profiled_wall": busy_us / 1e6 / wall,
            "kernel_launches": launches, "launches_per_round": launches / 32,
            "ported_kernels": mine,
            "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top]}


def chunk_plan_launches(torch, dev) -> int:
    """Kernel launches of one `chunk_plan` call at S = 256 (the loop's
    count does not depend on the data)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.prefill import banker_order, chunk_plan

    S = CHUNK_SLOTS
    g = torch.Generator(device=dev).manual_seed(SEED)

    def ints(lo, hi):
        return torch.randint(lo, hi, (S,), generator=g, device=dev,
                             dtype=torch.int32)

    busy = ints(0, 2) > 0
    pos, plen, mx, held = ints(0, 1024), ints(1, 1024), ints(16, 129), \
        ints(0, 72)
    zb = torch.zeros(S, dtype=torch.bool, device=dev)
    order = banker_order(held, ints(0, 8), ints(0, 99), busy)
    args = (order, busy, zb, zb, pos, plen, mx, held, 100, zb, held)
    kw = dict(chunk=CHUNKED[0], budget=CHUNKED[1], block_size=CHUNK_POOL[1])
    chunk_plan(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chunk_plan(*args, **kw)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def profile_megastep(torch, dev) -> dict:
    """Where one up-front megastep's time goes: the serve configuration
    with 400 requests (`profile_rounds`)."""
    _, _, megastep = serve_engine(torch, dev, n_req=400)
    return {"requests": 400, **profile_rounds(
        torch, megastep, ("qos_round_kernel", "paged_decode_kernel"))}


def profile_chunked(torch, dev) -> dict:
    """Where one chunked megastep's time goes: the serve_chunked
    configuration after two warm megasteps (prefill, sharing and parks
    under way), and the launches of the chunk plan's loop.  The paged
    decode calls of the timed megasteps are recorded (their ``lens`` and
    block tables, which the engine replaces rather than writes, read
    after the run) for the live tokens a launch serves and its bound: the
    bytes count each live pool block once, however many slots share it
    (`unique_live_tokens`), the operations each slot's tokens."""
    from repro_torch.kernels import ops

    _, _, megastep = chunked_engine(torch, dev)
    megastep()
    seen = []
    inner = ops._paged_decode.paged_decode

    def recorded(q, k_pool, v_pool, block_tbl, lens):
        seen.append((lens, block_tbl, k_pool.shape[0], k_pool.shape[1]))
        return inner(q, k_pool, v_pool, block_tbl, lens)

    ops._paged_decode.paged_decode = recorded
    try:
        res = profile_rounds(torch, megastep, ("qos_round_kernel",
                                               "paged_decode_kernel",
                                               "paged_prefill_kernel"))
    finally:
        ops._paged_decode.paged_decode = inner
    live = [int(ln.clamp(max=t.shape[1] * bs).sum())
            for ln, t, _, bs in seen]
    uniq = [unique_live_tokens(torch, ln, t, nb, bs)
            for ln, t, nb, bs in seen]
    hd, n = 896, max(len(live), 1)
    bounds = [_bound(2 * u * hd * 4 + 2 * CHUNK_SLOTS * hd * 4
                     + t.numel() * 4 + CHUNK_SLOTS * 4, 4 * v * hd)[0]
              for u, v, (_, t, _, _) in zip(uniq, live, seen)]
    plan = chunk_plan_launches(torch, dev)
    return {"requests": CHUNK_REQUESTS, **res,
            "paged_decode_live_tokens": {"calls": len(live),
                                         "mean": sum(live) / n,
                                         "max": max(live, default=0),
                                         "unique_mean": sum(uniq) / n},
            "paged_decode_bound_ms_mean": sum(bounds) / n,
            "chunk_plan_launches_per_round": plan,
            "chunk_plan_share_of_launches": plan / res["launches_per_round"]}


def unique_live_tokens(torch, lens, tbl, n_blocks: int, bs: int) -> int:
    """The pool tokens a paged-decode call must read at least once: for
    each pool block, the most live tokens any slot reads from it (a block
    shared by a prefix counts once)."""
    mb = tbl.shape[1]
    j = torch.arange(mb, device=tbl.device)
    n = (lens[:, None].clamp(max=mb * bs) - j[None] * bs).clamp(0, bs)
    ok = (tbl >= 0) & (n > 0)
    most = torch.zeros(n_blocks, dtype=torch.int64, device=tbl.device)
    most.scatter_reduce_(0, tbl[ok].long(), n[ok].long(), "amax")
    return int(most.sum())


def kernel_times(torch, dev, by_path, first_backlog_rows) -> list:
    """Each kernel against its plain version on the timed inputs (the max
    error goes into the row), then the times of the kernel, the plain
    version and a library call at the main path's shapes; the bound from
    these inputs.  ``by_path``: each main path's launch counts; a row's
    ``launches`` is their sum."""
    from repro_torch.kernels import ops, qos_admission

    rows = []
    launches = {k: sum(p[k] for p in by_path.values())
                for k in next(iter(by_path.values()))}

    def per_path(name):
        return {path: counts[name] for path, counts in by_path.items()}

    # QoS round: the serve path's first backlog (pow2 rows), 3 tenants,
    # T=256, max_units = 256 slots, through `ops.qos_round` as the engine
    # calls it (`now` and `free_units` as device scalars)
    N, S, T, U = first_backlog_rows, 3, 256, 256
    st, ids, tks, alive, dls, free = qos_case(
        torch, dev, seed=1, S=S, N=N, T=T, wrap=False, alive_density=0.9,
        free=64)
    now = torch.zeros((), device=dev)
    free_t = torch.full((), free, dtype=torch.int32, device=dev)

    def kernel():
        return ops.qos_round(st, ids, tks, alive, dls, now, free_t,
                             max_units=U)

    def plain():
        return qos_admission.qos_round_plain(st, ids, tks, alive, dls, now,
                                             free_t, U)

    got, want = kernel(), plain()
    q_err = qos_max_err(torch, got, want)
    if not qos_exact(torch, got, want):
        raise AssertionError(f"qos_round_fused != plain at N={N}: max "
                             f"|err| {q_err}")
    k_ms, p_ms = time_ms(kernel), time_ms(plain)
    # CUDA kernels a call issues: 20 calls under the profiler.  It keeps
    # fewer events than were launched, so the events a call are a lower
    # bound; the names say that no kernel but the round's ran
    prof = device_profile(torch, kernel, calls=20)
    q_bytes = (N * (4 + 8 + 1 + 4)          # rows: tenant, ticket, alive, dl
               + S * (4 * 8 + 2 * 4) + T * 8 + 16  # state, array, scalars
               + N * 2 + S * (3 * 8 + 4) + T * 8 + 4)  # masks, state',
    q_ops = 2 * S * U                        # array', left; a div + add
    q_bound = max(q_bytes / HBM_BYTES_PER_S, q_ops / F32_FLOPS) * 1e3
    rows.append({
        "name": "qos_round_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/qos_admission.cu",
        "replaces": "src/repro/kernels/qos_admission.py:249",
        "launches": launches["qos_round_fused"], "max_abs_err": q_err,
        "ms": k_ms, "kernel_device_ms": kernel_device_ms(
            torch, kernel, "qos_round_kernel"),
        "cuda_events_per_call": prof["launches"],
        "cuda_kernels_seen": sorted(k[:60] for k in prof["ms_by_kernel"]),
        "wrapper_launches_per_call": launches_per_call(torch, kernel,
                                                       "qos_round_fused"),
        "plain_ms": p_ms, "bound_ms": q_bound,
        "bound_by": ("bytes" if q_bytes / HBM_BYTES_PER_S
                     >= q_ops / F32_FLOPS else "operations"),
        "library_ms": None, "launches_by_path": per_path("qos_round_fused"),
        "host_us": host_split(torch, kernel),
        "shape": {"N": N, "tenants": S, "T": T, "max_units": U}})

    # paged decode at the serve path's shape (256 slots, H=KV=1, hd=896,
    # its pool, lens up to its longest request) and at the chunked path's
    # (the 4096-block pool all live, 72-block tables)
    NB, BS, MB = SERVE_POOL
    serve_args = paged_case(torch, dev, seed=11, S=SERVE_SLOTS, H=1, KV=1,
                            hd=896, NB=NB, BS=BS, MB=MB,
                            max_len=SERVE_MAX_LEN)
    row = paged_decode_times(torch, dev, serve_args)
    rows.append({
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:119",
        "launches": launches["paged_decode"], **row,
        "launches_by_path": per_path("paged_decode"),
        "at_chunked_shape": paged_decode_times(
            torch, dev, chunked_decode_case(torch, dev, seed=12))})
    rows.append(prefill_row(torch, dev, launches, per_path))
    rows += model_kernel_rows(torch, dev, launches, per_path)
    return rows


def paged_decode_times(torch, dev, args) -> dict:
    """The paged-decode kernel on ``args`` against its plain version (the
    max error), its wrapper's ms, one launch's device ms, the plain
    version's ms, the bound from the live tokens, SDPA's ms over the
    gathered cache, the wrapper's host µs a call and the cut."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref

    q, kp, vp, tbl, lens = args
    S, H, hd = q.shape
    KV = kp.shape[2]
    MB = tbl.shape[1]
    err = decode_paged_check(torch, args, "the timed inputs")
    k_ms = time_ms(lambda: pd.paged_decode(*args))
    kd_ms = kernel_device_ms(torch, lambda: pd.paged_decode(*args),
                             "paged_decode_kernel")
    p_ms = time_ms(lambda: pd.paged_decode_plain(*args), iters=5, warmup=1)
    kd, kpos = ref.paged_gather_kv(kp, tbl, lens)
    vd, _ = ref.paged_gather_kv(vp, tbl, lens)
    qh = q[:, :, None, :]                                   # (S, H, 1, hd)
    kh = kd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vh = vd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    mask = (kpos >= 0)[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    del kd, vd, kh, vh
    live = int(lens.clamp(max=MB * kp.shape[1]).sum())
    nbytes = (2 * live * KV * hd * 4          # live K and V rows, once
              + 2 * S * H * hd * 4            # q in, out
              + S * MB * 4 + S * 4)           # table, lens
    bound, by = _bound(nbytes, 4 * live * H * hd)  # q·k and p·v, 2 each
    kt, grid = pd._plans[(dev.index or 0, H, KV, hd, kp.shape[1], MB)]
    pieces = pd.split_plan(lens.tolist(), KV, kp.shape[1], MB, grid)
    return {"max_abs_err": err, "ms": k_ms, "kernel_device_ms": kd_ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms,
            "host_us": host_split(torch, lambda: pd.paged_decode(*args)),
            "cut": {"grid": grid, "key_rows": kt,
                    "blocks": sum(pd.block_costs(lens.tolist(), KV,
                                                 kp.shape[1], MB)),
                    "pieces": len(pieces),
                    "slots_cut": len({p[0] for p in pieces
                                      if p[4] is not None})},
            "shape": {"S": S, "H": H, "KV": KV, "hd": hd, "NB": kp.shape[0],
                      "BS": kp.shape[1], "MB": MB, "live_tokens": live}}


def prefill_row(torch, dev, launches, per_path) -> dict:
    """Paged prefill at the chunked path's shapes: S=256 slots, a 64-token
    chunk window, H=KV=1, hd=896, its 4096×16 pool and 72-block tables;
    32 slots carry a chunk (~1k tokens, the round's budget) at offsets up
    to 960, the rest are idle.  The library call is SDPA over the dense
    gathered cache (the pools after the chunk write) with each row's
    causal mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels import ref

    S, CT, H, KV, hd = CHUNK_SLOTS, CHUNKED[0], 1, 1, 896
    NB, BS, MB = CHUNK_POOL
    args, rows = prefill_case(torch, dev, seed=13, S=S, CT=CT, H=H, KV=KV,
                              hd=hd, NB=NB, BS=BS, MB=MB, active=32,
                              max_off=960)
    q, kc, vc, kp, vp, tbl, off, lens = args
    err = prefill_check(torch, args, rows, "the timed inputs")
    k_ms = time_ms(lambda: pp.paged_prefill(*args))
    kd_ms = kernel_device_ms(torch, lambda: pp.paged_prefill(*args),
                             "paged_prefill_kernel")
    # the cut of this round's key tiles among the launch's one wave
    costs, _ = pp.tile_costs(off.tolist(), lens.tolist(), CT, H, KV, BS, MB)
    grid = pp._grids[(dev.index or 0, S, hd, MB)]
    pieces = pp.split_plan(costs, grid)
    cut = {"grid": grid, "key_tiles": sum(costs),
           "active_tiles": sum(c > 0 for c in costs),
           "pieces": len(pieces),
           "tiles_cut": len({p[0] for p in pieces if p[4] is not None})}
    p_ms = time_ms(lambda: pp.paged_prefill_plain(*args), iters=3, warmup=1)
    # SDPA: q (S, H, CT, hd) over the gathered (S, KV, MB·BS, hd) cache,
    # key t visible to row j iff t <= off + j and j < len
    kd, _ = ref.paged_gather_kv(kp, tbl, off + lens)
    vd, _ = ref.paged_gather_kv(vp, tbl, off + lens)
    qh = q.permute(0, 2, 1, 3).contiguous()
    kh = kd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vh = vd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    j = torch.arange(CT, device=dev)[None, :, None]
    t = torch.arange(MB * BS, device=dev)[None, None, :]
    mask = ((t <= off[:, None, None] + j)
            & (j < lens[:, None, None]))[:, None]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    o64, l64 = off.double(), lens.double()
    rows_tok = float(lens.sum())
    b_bytes = (2 * float((o64 * (l64 > 0)).sum()) * KV * hd * 4  # prior K/V
               + 2 * rows_tok * KV * hd * 4      # chunk K/V read
               + rows_tok * H * hd * 4           # chunk q read
               + 2 * rows_tok * KV * hd * 4      # chunk K/V written
               + S * CT * H * hd * 4             # out written (zeros too)
               + S * MB * 4 + 2 * S * 4)         # table, off, lens
    b_ops = 4 * float((l64 * (o64 + (l64 + 1) / 2)).sum()) * H * hd
    bound = max(b_bytes / HBM_BYTES_PER_S, b_ops / F32_FLOPS) * 1e3
    return {
        "name": "paged_prefill", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_prefill.cu",
        "replaces": "src/repro/kernels/paged_prefill.py:166",
        "launches": launches["paged_prefill"], "max_abs_err": err,
        "ms": k_ms, "kernel_device_ms": kd_ms, "plain_ms": p_ms,
        "bound_ms": bound, "cut": cut,
        "bound_by": ("bytes" if b_bytes / HBM_BYTES_PER_S
                     >= b_ops / F32_FLOPS else "operations"),
        "library_ms": lib_ms, "launches_by_path": per_path("paged_prefill"),
        "host_us": host_split(torch, lambda: pp.paged_prefill(*args)),
        "shape": {"S": S, "CT": CT, "H": H, "KV": KV, "hd": hd, "NB": NB,
                  "BS": BS, "MB": MB, "chunk_tokens": int(rows_tok),
                  "active_slots": int((lens > 0).sum())}}


def _bound(nbytes: float, ops: float) -> tuple:
    """(bound ms, what bounds it) of work moving ``nbytes`` and doing
    ``ops`` f32 operations on one H100."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def model_kernel_rows(torch, dev, launches, per_path) -> list:
    """The single-tenant path's kernels at its shapes: ``sema_batch`` at
    serve_model's waves (N=16 requests, T=256); ``decode_attention`` at
    serve_model's decode (B=8 slots, a full 256-row ring, H=14, KV=2,
    hd=64); ``flash_attention`` at prefill_model's (B=4, S=256, causal).
    The library calls: none for ``sema_batch``; SDPA over the
    head-repeated cache with the visibility mask for decode; causal SDPA
    over head-repeated K/V for flash."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, \
        decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention, \
        flash_attention_plain
    from repro_torch.kernels.sema_batch import sema_batch, sema_batch_plain

    rows = []
    N, T = MODEL_REQUESTS // 2, 256
    args = sema_case(torch, dev, seed=31, N=N, T=T, post_n=0)
    err = sema_check(torch, args, "the timed inputs")
    s_bytes = (N * 1 + 4 * 4 + T * 4            # requests, scalars, array
               + N * (4 + 1 + 4 + 1) + 2 * 4 + T * 4)  # rows out, scalars,
    s_ops = 12 * N + 6 * T                       # array out; integer ops
    bound, by = _bound(s_bytes, s_ops)
    prof = device_profile(torch, lambda: sema_batch(*args), calls=20)
    rows.append({
        "name": "sema_batch", "route": "cuda",
        "source": "src/repro_torch/csrc/sema_batch.cu",
        "replaces": "src/repro/kernels/sema_batch.py:118",
        "launches": launches["sema_batch"], "max_abs_err": err,
        "ms": time_ms(lambda: sema_batch(*args)),
        "kernel_device_ms": kernel_device_ms(
            torch, lambda: sema_batch(*args), "sema_batch_kernel"),
        "cuda_events_per_call": prof["launches"],
        "cuda_kernels_seen": sorted(k[:60] for k in prof["ms_by_kernel"]),
        "wrapper_launches_per_call": launches_per_call(
            torch, lambda: sema_batch(*args), "sema_batch"),
        "plain_ms": time_ms(lambda: sema_batch_plain(*args)),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "launches_by_path": per_path("sema_batch"),
        "host_us": host_split(torch, lambda: sema_batch(*args)),
        "shape": {"N": N, "T": T, "post_n": 0}})

    B, C, H, KV, hd = MODEL_SLOTS, MODEL_MAX_LEN, 14, 2, 64
    (q, k, v, kpos, qpos), _ = decode_case(torch, dev, seed=33, B=B, C=C,
                                           H=H, KV=KV, hd=hd)
    kpos = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C) \
        .contiguous()
    qpos = torch.full((B,), C - 1, dtype=torch.int32, device=dev)
    err = decode_check(torch, (q, k, v, kpos, qpos), 0, "the timed inputs")
    vis = (kpos >= 0) & (qpos[:, None] - kpos >= 0)
    n_vis = float(vis.sum())                    # visible (row, key) pairs
    qh = q[:, :, None, :]
    kh = k.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vh = v.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    mask = vis[:, None, None, :]
    d_bytes = (2 * n_vis * KV * hd * 4 + 2 * B * H * hd * 4
               + B * C * 4 + B * 4)
    bound, by = _bound(d_bytes, 4 * n_vis * H * hd)
    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:102",
        "launches": launches["decode_attention"], "max_abs_err": err,
        "ms": time_ms(lambda: decode_attention(q, k, v, kpos, qpos)),
        "kernel_device_ms": kernel_device_ms(
            torch, lambda: decode_attention(q, k, v, kpos, qpos),
            "decode_attention_kernel"),
        "plain_ms": time_ms(lambda: decode_attention_plain(q, k, v, kpos,
                                                           qpos)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask)),
        "launches_by_path": per_path("decode_attention"),
        "host_us": host_split(torch, lambda: decode_attention(q, k, v, kpos,
                                                              qpos)),
        "shape": {"B": B, "C": C, "H": H, "KV": KV, "hd": hd,
                  "visible_keys": int(n_vis)}})

    B, S = PREFILL_B, PREFILL_S
    args = flash_case(torch, dev, seed=35, B=B, S=S, H=H, KV=KV, hd=hd)
    err = flash_check(torch, args, 0, "the timed inputs")
    q, k, v = args
    qh = q.permute(0, 2, 1, 3).contiguous()
    kh = k.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    vh = v.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1).contiguous()
    pairs = B * H * S * (S + 1) / 2             # causal (query, key) pairs
    f_bytes = (B * S * (2 * H + 2 * KV) * hd * 4)  # q, k, v in; out
    f_ops = 4 * pairs * hd
    # the kernel takes every product as 3xTF32 on the tensor cores; the
    # f32 pipe's bound beside it
    bound_f32, _ = _bound(f_bytes, f_ops)
    tb, to = f_bytes / HBM_BYTES_PER_S, 3 * f_ops / TF32_FLOPS
    bound, by = max(tb, to) * 1e3, ("bytes" if tb >= to
                                    else "operations (3xTF32)")
    # what one TF32 product per term would give: the plain version with
    # TF32 matmuls against itself in f32
    want = flash_attention_plain(q, k, v)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_err = float((flash_attention_plain(q, k, v) - want).abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:149",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "ms": time_ms(lambda: flash_attention(q, k, v)),
        "kernel_device_ms": kernel_device_ms(
            torch, lambda: flash_attention(q, k, v),
            "flash_attention_kernel"),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v)),
        "bound_ms": bound, "bound_by": by, "bound_ms_f32": bound_f32,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)),
        "launches_by_path": per_path("flash_attention"),
        "host_us": host_split(torch, lambda: flash_attention(q, k, v)),
        "one_tf32_product_max_abs_err": tf32_err,
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "hd": hd,
                  "causal": True}})
    return rows


def ab_times(tree: Path) -> dict:
    """The six redesigned kernels of the source tree ``tree`` (its
    ``src/repro_torch``, built into its own ``build/kernels``) at the main
    paths' shapes: paged decode at the up-front path's (S=256, hd=896,
    MB=32, ~31k live tokens) and the chunked path's (the 4096-block pool
    all live, MB=72); ``sema_batch`` at serve_model's waves (N=16,
    T=256); the QoS round through ``ops.qos_round`` at the serve path's
    first backlog (N=1024, 3 tenants, T=256, device scalars); paged
    prefill at the chunked path's (S=256, CT=64, hd=896, MB=72, 32 active
    slots); flash at prefill_model's (B=4, S=256, H=14, KV=2, hd=64,
    causal); decode at serve_model's (B=8, C=256, every key visible).
    Per kernel: the wrapper's ms (CUDA events over 20 calls), one
    launch's device ms (torch.profiler, divided by the launches it
    recorded) and the wrapper's host µs a call (200 calls enqueued).  And
    the ms a round of the up-front path (400 requests), the dense ring
    and the chunked path (400 requests), over megasteps 2–4.  Run in a
    process of its own, so that two trees' packages do not meet."""
    import os

    os.environ["REPRO_TORCH_BUILD_DIR"] = str(tree / "build" / "kernels")
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.sema_batch import sema_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    st, ids, tks, alive, dls, free = qos_case(
        torch, dev, seed=1, S=3, N=backlog_rows(SERVE_REQUESTS,
                                                SERVE_SLOTS)[0],
        T=256, wrap=False, alive_density=0.9, free=64)
    now = torch.zeros((), device=dev)
    free_t = torch.full((), free, dtype=torch.int32, device=dev)
    NB, BS, MB = CHUNK_POOL
    pargs, _ = prefill_case(torch, dev, seed=13, S=CHUNK_SLOTS,
                            CT=CHUNKED[0], H=1, KV=1, hd=896, NB=NB, BS=BS,
                            MB=MB, active=32, max_off=960)
    H, KV, hd = 14, 2, 64
    q, k, v = flash_case(torch, dev, seed=35, B=PREFILL_B, S=PREFILL_S, H=H,
                         KV=KV, hd=hd)
    (dq, dk, dv, _, _), _ = decode_case(torch, dev, seed=33, B=MODEL_SLOTS,
                                       C=MODEL_MAX_LEN, H=H, KV=KV, hd=hd)
    kpos = torch.arange(MODEL_MAX_LEN, dtype=torch.int32, device=dev) \
        .expand(MODEL_SLOTS, MODEL_MAX_LEN).contiguous()
    qpos = torch.full((MODEL_SLOTS,), MODEL_MAX_LEN - 1, dtype=torch.int32,
                      device=dev)
    NB, BS, MB = SERVE_POOL
    dserve = paged_case(torch, dev, seed=11, S=SERVE_SLOTS, H=1, KV=1,
                        hd=896, NB=NB, BS=BS, MB=MB, max_len=SERVE_MAX_LEN)
    dchunk = chunked_decode_case(torch, dev, seed=12)
    sargs = sema_case(torch, dev, seed=31, N=MODEL_REQUESTS // 2, T=256,
                      post_n=0)
    out = {}
    for name, kname, fn in (
            ("paged_decode_serve", "paged_decode_kernel",
             lambda: paged_decode(*dserve)),
            ("paged_decode_chunked", "paged_decode_kernel",
             lambda: paged_decode(*dchunk)),
            ("sema_batch", "sema_batch_kernel", lambda: sema_batch(*sargs)),
            ("qos_round_fused", "qos_round_kernel",
             lambda: ops.qos_round(st, ids, tks, alive, dls, now, free_t,
                                   max_units=256)),
            ("paged_prefill", "paged_prefill_kernel",
             lambda: pp.paged_prefill(*pargs)),
            ("flash_attention", "flash_attention_kernel",
             lambda: flash_attention(q, k, v)),
            ("decode_attention", "decode_attention_kernel",
             lambda: decode_attention(dq, dk, dv, kpos, qpos))):
        out[name] = {"ms": time_ms(fn),
                     "kernel_device_ms": kernel_device_ms(torch, fn, kname),
                     "host_us": host_split(torch, fn)["host_us"]}
    # ms a round of the three megastep paths: the same trace in both
    # trees, megasteps 2-4 (after one warm-up)
    for name, make in (("upfront_round_ms", lambda: serve_engine(
            torch, dev, n_req=400)), ("dense_ring_round_ms",
                                      lambda: dense_ring_engine(torch, dev)),
            ("chunked_round_ms", lambda: chunked_engine(torch, dev))):
        _, _, megastep = make()
        megastep()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            megastep()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / (3 * 32)
    return out


def kernels_ab(parent: Path) -> int:
    """``--ab-attention PARENT``: the six redesigned kernels (`ab_times`)
    of the source tree at PARENT (a ``git archive`` of an earlier commit)
    and of this tree, timed in turns on the one card (parent, this, this,
    parent), each in a process of its own; prints one JSON line."""
    runs = []
    for tree in (parent, ROOT, ROOT, parent):
        r = subprocess.run([sys.executable, __file__, "--ab-times",
                            str(tree)], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return r.returncode
        runs.append({"tree": str(tree),
                     **json.loads(r.stdout.strip().splitlines()[-1])})
    print(smi_line(), flush=True)
    print(json.dumps({"ab": runs}), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-times":
        print(json.dumps(ab_times(Path(sys.argv[2]).resolve())))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-attention":
        return kernels_ab(Path(sys.argv[2]).resolve())
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
                                   if "registers" in ln or "spill" in ln
                                   or "Function properties" in ln]}
                     for n, v in built.items()})

    t0 = time.perf_counter()
    checks = kernel_check(torch, dev)
    emit("kernel_check", seconds=time.perf_counter() - t0, results=checks)

    t0 = time.perf_counter()
    res2 = two_streams(torch, dev)
    emit("two_streams", seconds=time.perf_counter() - t0, kernels=res2)

    t0 = time.perf_counter()
    small = serve_small(torch, dev)
    emit("serve_small", seconds=time.perf_counter() - t0, **small)

    t0 = time.perf_counter()
    small = serve_small_chunked(torch, dev)
    emit("serve_small_chunked", seconds=time.perf_counter() - t0, **small)

    t0 = time.perf_counter()
    small = serve_model_small(torch, dev)
    emit("serve_model_small", seconds=time.perf_counter() - t0, **small)

    torch.cuda.reset_peak_memory_stats()
    res = serve(torch, dev)
    emit("serve", **res)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resc = serve_chunked(torch, dev)
    emit("serve_chunked", seconds=time.perf_counter() - t0, **resc)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resm = serve_model(torch, dev)
    emit("serve_model", seconds=time.perf_counter() - t0, **resm)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resp = prefill_model(torch, dev)
    emit("prefill_model", seconds=time.perf_counter() - t0, **resp)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resr = serve_dense_ring(torch, dev)
    emit("serve_dense_ring", seconds=time.perf_counter() - t0, **resr)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ress = serve_step(torch, dev)
    emit("serve_step", seconds=time.perf_counter() - t0, **ress)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ressc = serve_step_chunked(torch, dev)
    emit("serve_step_chunked", seconds=time.perf_counter() - t0, **ressc)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    resmq = serve_model_qos(torch, dev)
    emit("serve_model_qos", seconds=time.perf_counter() - t0, **resmq)

    t0 = time.perf_counter()
    prof = profile_megastep(torch, dev)
    emit("profile", seconds=time.perf_counter() - t0, **prof)

    t0 = time.perf_counter()
    prof = profile_chunked(torch, dev)
    emit("profile_chunked", seconds=time.perf_counter() - t0, **prof)

    rows = kernel_times(torch, dev, {"serve": res["launches"],
                                     "serve_chunked": resc["launches"],
                                     "serve_model": resm["launches"],
                                     "prefill_model": resp["launches"],
                                     "serve_dense_ring": resr["launches"],
                                     "serve_step": ress["launches"],
                                     "serve_step_chunked": ressc["launches"],
                                     "serve_model_qos": resmq["launches"]},
                        res["backlog_rows"][0])
    emit("kernels", kernels=rows)

    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
