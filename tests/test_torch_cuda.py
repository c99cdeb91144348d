"""The port's CUDA kernels against their plain versions on the card, at
small shapes.  A CUDA kernel has no CPU mode, so these tests are marked
``gpu`` and skip where no card is present; on a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.admission import functional_qos as fq
from repro_torch.core import u32
from repro_torch.kernels import ops, qos_admission, ref
from repro_torch.kernels.paged_decode import paged_decode

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("S,wrap,density", [(3, False, 0.8), (7, True, 0.9),
                                            (2, False, 0.0)])
def test_qos_kernel_bit_exact(cuda, S, wrap, density):
    rng = np.random.default_rng(S)
    N, T = 300, 64
    st = fq.make_qos(rng.uniform(0.5, 3, S), table_size=T, device=cuda)
    b = u32.u32(np.full(S, (1 << 32) - 40 if wrap else 5), device=cuda)
    st = st._replace(ticket=b, grant=b, consumed=b)
    ids = torch.as_tensor(rng.integers(0, S, N).astype(np.int32), device=cuda)
    st, tks, _, _ = fq.qos_take(st, ids, torch.ones(N, dtype=torch.bool,
                                                    device=cuda))
    alive = torch.as_tensor(rng.random(N) < density, device=cuda)
    dls = torch.as_tensor(np.where(rng.random(N) < 0.3, rng.uniform(-1, 1, N),
                                   np.inf).astype(np.float32), device=cuda)
    want = fq.qos_round(st, ids, tks, alive, dls, 0.0, 40, 32)
    got = qos_admission.qos_round_fused(st, ids, tks, alive, dls, 0.0, 40,
                                        max_units=32)
    for g, w in zip(got[0], want[0]):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("H,KV,hd", [(1, 1, 96), (4, 2, 64), (14, 2, 64)])
def test_paged_decode_kernel_close(cuda, H, KV, hd):
    rng = np.random.default_rng(hd)
    S, NB, BS, MB = 9, 64, 8, 6
    lens = rng.integers(0, MB * BS + 1, S).astype(np.int32)
    lens[0] = 0
    tbl = np.full((S, MB), -1, np.int32)
    ids, p = rng.permutation(NB), 0
    for s in range(S):
        nb = -(-int(lens[s]) // BS)
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((S, H, hd), generator=g, device=cuda)
    kp = torch.randn((NB, BS, KV, hd), generator=g, device=cuda)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device=cuda)
    args = (q, kp, vp, torch.as_tensor(tbl, device=cuda),
            torch.as_tensor(lens, device=cuda))
    ops.reset_launch_counts()
    got = ops.paged_decode(*args)
    assert ops.launch_counts()["paged_decode"] == 1
    torch.testing.assert_close(got, ref.paged_decode_ref(*args), atol=2e-5,
                               rtol=2e-5)
    assert not got[0].any()
    assert torch.equal(got, paged_decode(*args))


@pytest.mark.parametrize("H,KV,hd,BS", [(1, 1, 96, 4), (4, 2, 64, 8),
                                        (14, 2, 64, 16), (3, 3, 40, 4)])
def test_paged_prefill_kernel_close(cuda, H, KV, hd, BS):
    """Ragged mid-block offsets, idle slots and permuted tables: the pools
    bit-equal to the plain version (compared as int32 views, blocks off
    the chunk rows untouched), the outputs within 2e-5."""
    rng = np.random.default_rng(hd + BS)
    S, CT, NB, MB = 7, 9, 96, 10
    offs = rng.integers(0, 5 * BS, S).astype(np.int32)
    lens = rng.integers(0, CT + 1, S).astype(np.int32)
    lens[0] = 0
    lens[1] = CT
    tbl = np.full((S, MB), -1, np.int32)
    ids, p = rng.permutation(NB), 0
    for s in range(S):
        nb = -(-int(offs[s] + lens[s]) // BS)
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((S, CT, H, hd), generator=g, device=cuda)
    kc = torch.randn((S, CT, KV, hd), generator=g, device=cuda)
    vc = torch.randn((S, CT, KV, hd), generator=g, device=cuda)
    kp = torch.randn((NB, BS, KV, hd), generator=g, device=cuda)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device=cuda)
    t, o, ln = (torch.as_tensor(x, device=cuda) for x in (tbl, offs, lens))
    want, kw, vw = ref.paged_prefill_ref(q, kc, vc, kp, vp, t, o, ln)
    kp0 = kp.clone()
    ops.reset_launch_counts()
    got, kg, vg = ops.paged_prefill(q, kc, vc, kp, vp, t, o, ln)
    assert ops.launch_counts()["paged_prefill"] == 1
    assert kg is kp and vg is vp              # written in place
    assert torch.equal(kg.view(torch.int32), kw.view(torch.int32))
    assert torch.equal(vg.view(torch.int32), vw.view(torch.int32))
    written = {int(tbl[s, (offs[s] + j) // BS]) for s in range(S)
               for j in range(lens[s])}
    for b in set(range(NB)) - written:
        assert torch.equal(kg[b], kp0[b])
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert not got[0].any()


@pytest.mark.parametrize("N,T,post_n", [(1, 64, 0), (7, 64, 3),
                                        (1000, 256, 256), (3000, 64, 69)])
def test_sema_batch_kernel_bit_exact(cuda, N, T, post_n):
    """Tickets straddling 2³², post_n up to past T, N past one tile."""
    from repro_torch.kernels.sema_batch import sema_batch, sema_batch_plain

    rng = np.random.default_rng(N + T)
    req = torch.as_tensor(rng.random(N) < 0.7, device=cuda)
    seq = u32.u32(rng.integers(0, 1 << 32, T), device=cuda)
    scal = [u32.u32(x, device=cuda) for x in
            ((1 << 32) - 200, (1 << 32) - 150, post_n, 0x9E3779B9)]
    ops.reset_launch_counts()
    got = ops.sema_batch(scal[0], scal[1], seq, req, scal[2], scal[3])
    assert ops.launch_counts()["sema_batch"] == 1
    want = sema_batch_plain(scal[0], scal[1], seq, req, scal[2], scal[3])
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(-1), w.reshape(-1))
    again = sema_batch(scal[0], scal[1], seq, req, scal[2], scal[3])
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("H,KV,hd,window,rolling", [
    (14, 2, 64, 0, False), (14, 2, 64, 5, True), (1, 1, 896, 0, True),
    (4, 4, 40, 3, False)])
def test_decode_attention_kernel_close(cuda, H, KV, hd, window, rolling):
    """Empty rows, windows and out-of-order ring positions (C not a
    multiple of the tile), within 2e-5 of the plain version."""
    from repro_torch.kernels.decode_attention import decode_attention_plain

    rng = np.random.default_rng(hd + window)
    B, C = 5, 100
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    if rolling:
        pos = np.tile(((np.arange(C) + 37) % C).astype(np.int32), (B, 1))
    pos[0, 60:] = -1
    pos[1] = -1
    q_pos = rng.integers(0, C, B).astype(np.int32)
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((B, H, hd), generator=g, device=cuda)
    k = torch.randn((B, C, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, C, KV, hd), generator=g, device=cuda)
    kp, qp = (torch.as_tensor(x, device=cuda) for x in (pos, q_pos))
    ops.reset_launch_counts()
    got = ops.decode_attention(q, k, v, kp, qp, window=window)
    assert ops.launch_counts()["decode_attention"] == 1
    want = decode_attention_plain(q, k, v, kp, qp, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, k, v, kp, qp, window=window),
        atol=2e-5, rtol=2e-5)
    assert not got[1].any()


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,window", [
    (2, 77, 77, 14, 2, 64, 0), (1, 130, 130, 4, 1, 64, 16),
    (2, 33, 50, 2, 2, 40, 0), (1, 64, 64, 8, 8, 128, 7),
    (1, 20, 20, 4, 1, 256, 0)])
def test_flash_attention_kernel_close(cuda, B, Sq, Sk, H, KV, hd, window):
    """Ragged Sq and Sk, GQA stacking, windows and wide heads, within 2e-5
    of the plain version and of `ref.mha_ref`."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=cuda)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(
        got, ref.mha_ref(q, k, v, window=window), atol=2e-5,
        rtol=2e-5)


@pytest.mark.parametrize("case", ["window", "early-query", "empty-rows",
                                  "ragged-unaligned"])
def test_decode_attention_split_long_cache(cuda, case):
    """The split-K kernel over a 2048-row cache (8 splits of 256 rows at
    B=8, KV=2) with wholly masked splits, within 2e-5 of the plain
    version: one launch per call, a row with no key outputs 0, and the
    merge's arrival counters are left at zero."""
    from repro_torch.kernels import decode_attention as da

    rng = np.random.default_rng(len(case))
    B, C, H, KV, hd, window = 8, 2048, 14, 2, 64, 0
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    q_pos = np.full(B, C - 1, np.int32)
    if case == "window":
        window = 100
    elif case == "early-query":
        q_pos = rng.integers(0, 300, B).astype(np.int32)
    elif case == "empty-rows":
        pos[0, 700:] = -1
        pos[1] = -1
    else:                      # C off the split, hd % 4 != 0, an offset view
        C, hd = 2000, 18
        pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
        q_pos = rng.integers(0, C, B).astype(np.int32)
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((B, H, hd), generator=g, device=cuda)
    if case == "ragged-unaligned":
        flat = torch.randn(2 * B * C * KV * hd + 1, generator=g, device=cuda)
        k = flat[1:1 + B * C * KV * hd].view(B, C, KV, hd)
        v = flat[1 + B * C * KV * hd:].view(B, C, KV, hd)
    else:
        k = torch.randn((B, C, KV, hd), generator=g, device=cuda)
        v = torch.randn((B, C, KV, hd), generator=g, device=cuda)
    kp, qp = (torch.as_tensor(x, device=cuda) for x in (pos, q_pos))
    ops.reset_launch_counts()
    got = ops.decode_attention(q, k, v, kp, qp, window=window)
    assert ops.launch_counts()["decode_attention"] == 1
    want = da.decode_attention_plain(q, k, v, kp, qp, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    if case == "empty-rows":
        assert not got[1].any()
    torch.cuda.synchronize()
    assert not _stream_counters("decode_attention", cuda).any()
    assert torch.equal(da.decode_attention(q, k, v, kp, qp, window=window),
                       got)
    # a call is one kernel on the card: no merge launch, no memset
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            da.decode_attention(q, k, v, kp, qp, window=window)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    assert [e.key for e in kernels if e.count] and all(
        "decode_attention_kernel" in e.key for e in kernels)


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 512, 14, 2, 64, 0), (1, 512, 14, 2, 64, 200), (1, 300, 8, 2, 256, 0),
    (2, 45, 6, 3, 18, 0), (1, 70, 4, 4, 16, 9)])
def test_flash_attention_tensor_core_shapes(cuda, B, S, H, KV, hd, window):
    """The tensor-core kernel at G = 7 over S = 512 (16 query tiles,
    with and without a window), at hd = 256 with G = 4 (two output
    slices per warp) and at head widths off the 16-byte copy (hd = 18)
    and small (16): within 2e-5 of the plain version, one launch."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(S + hd)
    q = torch.randn((B, S, H, hd), generator=g, device=cuda)
    k = torch.randn((B, S, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, S, KV, hd), generator=g, device=cuda)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v, window=window), atol=2e-5,
        rtol=2e-5)


def _stream_counters(name, dev):
    """The arrival counters kernel ``name`` launched with on the current
    stream of ``dev``; fails if its launches left none there."""
    from repro_torch.kernels import build

    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (name, idx, torch._C._cuda_getCurrentRawStream(idx))
    assert key in build._arrivals, f"{name}: no counters on {key}"
    return build._arrivals[key]


def _one_kernel(fn, name, calls=20):
    """Run ``fn`` ``calls`` times under the profiler; assert every CUDA
    kernel event is ``name`` (no torch op ran on the card around it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count]
    assert kernels and all(name in e.key for e in kernels), \
        [e.key for e in kernels]


@pytest.mark.parametrize("case", ["wrap", "idle-tenants", "all-dead",
                                  "one-row", "row-limit"])
def test_qos_round_one_launch_bit_exact(cuda, case):
    """`ops.qos_round` on the card as the engine calls it — ``now`` and
    ``free_units`` as device scalars, N as it comes (not a power of two)
    — is one kernel and nothing else, bit-exact to the plain round:
    tickets straddling 2³², tenants with no rows, an all-dead backlog,
    one row, and the 16384-row limit of one CTA (one past it raises)."""
    rng = np.random.default_rng(len(case))
    S, N, T, mu, density = 5, 1000, 256, 64, 0.8
    if case == "all-dead":
        density = 0.0
    elif case == "one-row":
        N = 1
    elif case == "row-limit":
        N = qos_admission.MAX_ROWS
    st = fq.make_qos(rng.uniform(0.5, 3, S), table_size=T, device=cuda)
    b = u32.u32(np.full(S, (1 << 32) - 300), device=cuda)
    st = st._replace(ticket=b, grant=b, consumed=b)
    ids = rng.integers(0, S, N).astype(np.int32)
    if case == "idle-tenants":
        ids = np.where(ids % 2 == 1, 0, ids).astype(np.int32)
    ids = torch.as_tensor(ids, device=cuda)
    st, tks, _, _ = fq.qos_take(st, ids, torch.ones(N, dtype=torch.bool,
                                                    device=cuda))
    alive = torch.as_tensor(rng.random(N) < density, device=cuda)
    dls = torch.as_tensor(np.where(rng.random(N) < 0.2, rng.uniform(-1, 1, N),
                                   np.inf).astype(np.float32), device=cuda)
    now = torch.zeros((), device=cuda)
    free = torch.full((), 50, dtype=torch.int32, device=cuda)
    want = fq.qos_round(st, ids, tks, alive, dls, now, free, mu)
    ops.reset_launch_counts()
    got = ops.qos_round(st, ids, tks, alive, dls, now, free, max_units=mu)
    assert ops.launch_counts()["qos_round_fused"] == 1
    for g, w in zip(got[0], want[0]):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert g.dtype == w.dtype and torch.equal(g, w)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    # the CPU path over the padded backlog gives the same integers
    cpu = ops.qos_round(*(convert_tree_cpu(x) for x in (
        st, ids, tks, alive, dls)), 0.0, 50, max_units=mu)
    for g, w in zip([*got[0], *got[1:]], [*cpu[0], *cpu[1:]]):
        assert torch.equal(g.cpu(), w)
    _one_kernel(lambda: ops.qos_round(st, ids, tks, alive, dls, now, free,
                                      max_units=mu), "qos_round_kernel")
    if case == "row-limit":
        one = torch.ones(1, dtype=torch.bool, device=cuda)
        with pytest.raises(ValueError, match="16384"):
            ops.qos_round(st, torch.cat([ids, ids[:1]]),
                          torch.cat([tks, tks[:1]]), torch.cat([alive, one]),
                          torch.cat([dls, dls[:1]]), now, free, max_units=mu)


def convert_tree_cpu(x):
    """A tensor or a NamedTuple of tensors, copied to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return type(x)(*[t.cpu() for t in x])


@pytest.mark.parametrize("H,KV,hd,BS,MB", [(1, 1, 896, 16, 72),
                                           (14, 2, 64, 16, 40),
                                           (4, 2, 40, 8, 70),
                                           (3, 3, 18, 4, 160)])
def test_paged_prefill_split_long_table(cuda, H, KV, hd, BS, MB):
    """The split-K kernel over tables of 640 keys and more, the round's
    key tiles cut among one wave of CTAs (tiles cut in pieces and
    merged): offsets across block edges, no prior tokens, idle slots, -1
    entries past each slot's blocks, G > 1 and head widths off the
    16-byte copy (hd = 18).  Pools bit-equal to the plain version, outputs
    within 2e-5; a call is one kernel, and two calls back to back leave
    the arrival counters at zero with the same result."""
    from repro_torch.kernels import paged_prefill as pp

    rng = np.random.default_rng(hd + MB)
    S, CT = 9, 20
    offs = rng.integers(0, MB * BS - CT, S).astype(np.int32)
    offs[2] = MB * BS - CT           # a chunk at the table's end
    offs[3] = 0                      # no prior tokens
    offs[4] = BS * 5                 # block-aligned
    lens = rng.integers(1, CT + 1, S).astype(np.int32)
    lens[0] = 0                      # idle
    lens[1] = CT
    NB = sum(-(-int(o + n) // BS) for o, n in zip(offs, lens)) + 8
    tbl = np.full((S, MB), -1, np.int32)
    ids, p = rng.permutation(NB), 0
    for s in range(S):
        nb = -(-int(offs[s] + lens[s]) // BS)
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((S, CT, H, hd), generator=g, device=cuda)
    kc = torch.randn((S, CT, KV, hd), generator=g, device=cuda)
    vc = torch.randn((S, CT, KV, hd), generator=g, device=cuda)
    kp = torch.randn((NB, BS, KV, hd), generator=g, device=cuda)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device=cuda)
    t, o, ln = (torch.as_tensor(x, device=cuda) for x in (tbl, offs, lens))
    want, kw, vw = ref.paged_prefill_ref(q, kc, vc, kp, vp, t, o, ln)
    ops.reset_launch_counts()
    got, kg, vg = ops.paged_prefill(q, kc, vc, kp, vp, t, o, ln)
    assert ops.launch_counts()["paged_prefill"] == 1
    assert torch.equal(kg.view(torch.int32), kw.view(torch.int32))
    assert torch.equal(vg.view(torch.int32), vw.view(torch.int32))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert not got[0].any()
    again, _, _ = pp.paged_prefill(q, kc, vc, kp, vp, t, o, ln)
    torch.cuda.synchronize()
    assert not _stream_counters("paged_prefill", cuda).any()
    assert torch.equal(again, got)
    costs, _ = pp.tile_costs(offs, lens, CT, H, KV, BS, MB)
    grid = pp._grids[(q.device.index, S, hd, MB)]
    assert any(p[4] is not None for p in pp.split_plan(costs, grid))
    _one_kernel(lambda: pp.paged_prefill(q, kc, vc, kp, vp, t, o, ln),
                "paged_prefill_kernel")


def test_model_on_the_card_matches_the_cpu(cuda):
    """The qwen2-0.5b smoke model's prefill and decode on the card (flash
    and decode kernels) against the same weights on the CPU, 2e-4."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen2-0.5b")
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    toks = torch.randint(0, cfg.vocab, (3, 21),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda):
        p = convert.tree_from_jax(_to_numpy_tree(params), device=dev)
        caches = tt.init_caches(cfg, 3, 32, torch.float32, device=dev)
        lg, caches = tt.prefill(p, cfg, {"tokens": toks[:, :20].to(dev)},
                                caches)
        pos = torch.full((3, 1), 20, dtype=torch.int32, device=dev)
        ld, _ = tt.decode_step(p, cfg, toks[:, 20:].to(dev), pos, caches)
        out[str(dev)] = (lg.cpu(), ld.cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b, a, atol=2e-4, rtol=2e-4)


def _to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy_tree(v) for v in tree]
    return tree.numpy()


def _paged_decode_args(dev, seed, S, H, KV, hd, BS, MB, lens):
    """q and pools on ``dev``; each slot's blocks from a permutation of
    the pool, -1 past them."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    need = [min(-(-int(n) // BS), MB) for n in lens]
    NB = sum(need) + 3
    tbl = np.full((S, MB), -1, np.int32)
    ids, p = rng.permutation(NB), 0
    for s, nb in enumerate(need):
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((S, H, hd), generator=g, device=dev)
    kp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    vp = torch.randn((NB, BS, KV, hd), generator=g, device=dev)
    return (q, kp, vp, torch.as_tensor(tbl, device=dev),
            torch.as_tensor(lens, device=dev))


@pytest.mark.parametrize("S,H,KV,hd,BS,MB,long", [
    (40, 1, 1, 896, 16, 72, 1152),    # the chunked path's head and table
    (24, 14, 2, 64, 16, 40, 640),     # qwen2-0.5b's heads, G = 7
    (12, 16, 1, 1024, 16, 12, 192),   # the widest group and head
    (20, 3, 1, 18, 4, 60, 240),       # a head off the 16-byte copy
    (16, 2, 2, 40, 24, 9, 5000)])     # BS = 24, a length past the table
def test_paged_decode_split_one_launch(cuda, S, H, KV, hd, BS, MB, long):
    """The one-wave split-K kernel with slots cut across CTAs: ragged
    lengths, idle slots, one slot at (or past) its full table; within
    2e-5 of the plain version, idle slots 0, one kernel a call, and two
    calls back to back leave the arrival counters at zero with the same
    result."""
    from repro_torch.kernels import paged_decode as pd

    rng = np.random.default_rng(S + hd)
    lens = rng.integers(0, MB * BS + 1, S)
    lens[0] = 0
    lens[1] = long
    args = _paged_decode_args(cuda, hd, S, H, KV, hd, BS, MB, lens)
    ops.reset_launch_counts()
    got = ops.paged_decode(*args)
    assert ops.launch_counts()["paged_decode"] == 1
    torch.testing.assert_close(got, ref.paged_decode_ref(*args), atol=2e-5,
                               rtol=2e-5)
    assert not got[0].any()
    again = pd.paged_decode(*args)
    torch.cuda.synchronize()
    assert not _stream_counters("paged_decode", cuda).any()
    assert torch.equal(again, got)
    kt, grid = pd._plans[(torch.cuda.current_device(), H, KV, hd, BS, MB)]
    assert any(p[4] is not None
               for p in pd.split_plan(lens, KV, BS, MB, grid))
    _one_kernel(lambda: pd.paged_decode(*args), "paged_decode_kernel")


@pytest.mark.parametrize("form", ["carriers", "ints", "mixed"])
def test_sema_batch_one_launch_bit_exact(cuda, form):
    """The pass as one CUDA kernel and nothing else, whatever form the
    scalars take (device carriers, Python ints, or ticket and grant
    carriers with post_n and salt ints as ``submit_batch`` passes them):
    bit-exact to the plain version across 2³², the outputs in the plain
    version's dtypes and views of one buffer."""
    from repro_torch.kernels.sema_batch import sema_batch, sema_batch_plain

    rng = np.random.default_rng(len(form))
    N, T = 1500, 256
    req = torch.as_tensor(rng.random(N) < 0.7, device=cuda)
    seq = u32.u32(rng.integers(0, 1 << 32, T), device=cuda)
    vals = ((1 << 32) - 500, (1 << 32) - 450, 7, 0x9E3779B9)
    scal = [u32.u32(x, device=cuda) for x in vals]
    if form == "ints":
        scal = list(vals)
    elif form == "mixed":
        scal[2:] = vals[2:]
    args = (scal[0], scal[1], seq, req, scal[2], scal[3])
    got = sema_batch(*args)
    want = sema_batch_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    assert len({t.untyped_storage().data_ptr() for t in got}) == 1
    _one_kernel(lambda: sema_batch(*args), "sema_batch_kernel")


@pytest.mark.parametrize("name", ["decode_attention", "paged_prefill",
                                  "paged_decode"])
def test_split_k_kernels_on_two_streams(cuda, name):
    """A split-K kernel launched on two streams in turns, on different
    inputs, with no sync between: every launch within 2e-5 of the plain
    version, and each stream with arrival counters of its own."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp

    def inputs(seed):
        rng = np.random.default_rng(seed)
        g = torch.Generator(device=cuda).manual_seed(seed)
        if name == "decode_attention":
            B, C, H, KV, hd = 8, 2048, 14, 2, 64
            pos = torch.arange(C, dtype=torch.int32, device=cuda)
            qp = torch.as_tensor(rng.integers(1000, C, B).astype(np.int32),
                                 device=cuda)
            return (torch.randn((B, H, hd), generator=g, device=cuda),
                    torch.randn((B, C, KV, hd), generator=g, device=cuda),
                    torch.randn((B, C, KV, hd), generator=g, device=cuda),
                    pos.expand(B, C).contiguous(), qp)
        if name == "paged_decode":
            S, MB, BS = 64, 72, 16
            lens = rng.integers(0, MB * BS + 1, S)
            return _paged_decode_args(cuda, seed, S, 1, 1, 896, BS, MB,
                                      lens)
        S, CT, MB, BS, hd = 16, 20, 40, 16, 128
        offs = rng.integers(0, MB * BS - CT, S).astype(np.int32)
        lens = rng.integers(1, CT + 1, S).astype(np.int32)
        NB = sum(-(-int(o + n) // BS) for o, n in zip(offs, lens))
        tbl = np.full((S, MB), -1, np.int32)
        ids, p = rng.permutation(NB), 0
        for s in range(S):
            nb = -(-int(offs[s] + lens[s]) // BS)
            tbl[s, :nb] = ids[p:p + nb]
            p += nb
        return (torch.randn((S, CT, 1, hd), generator=g, device=cuda),
                torch.randn((S, CT, 1, hd), generator=g, device=cuda),
                torch.randn((S, CT, 1, hd), generator=g, device=cuda),
                torch.randn((NB, BS, 1, hd), generator=g, device=cuda),
                torch.randn((NB, BS, 1, hd), generator=g, device=cuda),
                *(torch.as_tensor(x, device=cuda) for x in (tbl, offs,
                                                            lens)))

    kernel, plain = {
        "decode_attention": (da.decode_attention, da.decode_attention_plain),
        "paged_prefill": (lambda *a: pp.paged_prefill(*a)[0],
                          lambda *a: pp.paged_prefill_plain(*a)[0]),
        "paged_decode": (pd.paged_decode, pd.paged_decode_plain)}[name]
    xs = [inputs(1), inputs(2)]
    want = [plain(*x) for x in xs]
    streams = [torch.cuda.Stream(cuda) for _ in xs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
    got = [[], []]
    for _ in range(6):
        for i, (st, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(st):
                got[i].append(kernel(*x))
    torch.cuda.synchronize()
    for i in range(2):
        for g in got[i]:
            torch.testing.assert_close(g, want[i], atol=2e-5, rtol=2e-5)
    raw = {st.cuda_stream for st in streams}
    assert len({k[2] for k in build._arrivals
                if k[0] == name and k[2] in raw}) == 2


STEP_MODES = {
    "qos": dict(),
    "paged": dict(kv_pool=(16, 4)),
    "sharing": dict(kv_pool=(16, 4, 8), chunked_prefill=(5, 9, 16),
                    prompt_cap=32, prefix_cache=8),
}


@pytest.mark.parametrize("mode", sorted(STEP_MODES))
def test_host_step_on_the_card_matches_the_cpu(cuda, mode):
    """The multi-tenant host ``step()`` with kernel admission on the card
    (one launch of the QoS kernel each step with a live backlog) against
    the same engine on the CPU (the plain round): the streams and rounds,
    every sample with its events, the QoS state and, under sharing, the
    replica of the pool bit-equal."""
    from repro_torch.kernels import build
    from repro_torch.serving.engine_state import drain
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, \
        Request

    rng = np.random.default_rng(5)
    trace = [dict(rid=i, prompt=[7] * 8 + [1 + i % 3] * int(rng.integers(
        0, 5)), max_new_tokens=1 + int(rng.integers(0, 6)),
        tenant_id=("gold", "bronze")[i % 2],
        deadline=0.25 * int(rng.integers(2, 20)) if i % 3 == 0 else None)
        for i in range(12)]

    def rid_step(active):
        return np.array([r.rid * 1000 + len(r.out_tokens) for r in active],
                        np.int64)

    runs = []
    for dev in (cuda, torch.device("cpu")):
        clk = [0.0]
        eng = ContinuousBatchingEngine(
            rid_step, lambda r: None, 4, tenants={"gold": 2.0,
                                                  "bronze": 1.0},
            use_kernel=True, clock=lambda: clk[0], device=dev,
            **STEP_MODES[mode])
        reqs = [Request(**t) for t in trace]
        eng.submit_batch(reqs)
        before, backlog, samples = build.LAUNCHES["qos_round_fused"], 0, []
        for k in range(40):
            clk[0] = k * 0.25
            backlog += int(eng._tenant_live.sum() > 0)
            eng.step(lambda lg: lg.astype(np.int64))
            samples += eng._last_samples
        launched = build.LAUNCHES["qos_round_fused"] - before
        state = [eng.qos] + ([eng._kv_hpool, eng._kv_htbl]
                             if mode == "sharing" else [])
        runs.append(([(r.out_tokens, r.admit_round, r.expire_round)
                      for r in reqs], samples,
                     [np.asarray(x).tolist() for x in _leaves(drain(state))]))
        if dev.type == "cuda":
            assert launched == backlog > 0
    assert all(r.done_event.is_set() for r in reqs)
    assert runs[0] == runs[1]


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [y for x in tree for y in _leaves(x)]
    return [tree]
