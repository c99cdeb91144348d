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


_LSE_CASES = {"one-split": (64, 256), "serve": (8, 256), "split8": (8, 2048),
              "split64": (1, 2048), "no-key-shard": (8, 512)}


@pytest.mark.parametrize("case", list(_LSE_CASES))
def test_decode_attention_lse_close(cuda, case):
    """The kernel's log-sum-exp output (``return_lse=True``) within 2e-5
    of the plain version's, −inf where it is: one split a row (B=64), the
    serving shape (8 splits), a 2048-row cache in 8 and in 64 splits, and
    a shard whose first rows see no key (every key past the query, or
    empty: lse −inf, out 0).  The output equals the default call's bit
    for bit; one launch a call."""
    from repro_torch.kernels import decode_attention as da

    B, C = _LSE_CASES[case]
    H, KV, hd = 14, 2, 64
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    q_pos = np.full(B, C - 1, np.int32)
    if case == "no-key-shard":
        pos[:4] += C          # keys this shard holds lie past the query
        pos[4] = -1
    g = torch.Generator(device=cuda).manual_seed(C + B)
    q = torch.randn((B, H, hd), generator=g, device=cuda)
    k = torch.randn((B, C, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, C, KV, hd), generator=g, device=cuda)
    kp, qp = (torch.as_tensor(x, device=cuda) for x in (pos, q_pos))
    ops.reset_launch_counts()
    got, lse = ops.decode_attention(q, k, v, kp, qp, return_lse=True)
    assert ops.launch_counts()["decode_attention"] == 1
    want, want_lse = da.decode_attention_plain(q, k, v, kp, qp,
                                               return_lse=True)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    fin = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[fin], want_lse[fin], atol=2e-5, rtol=2e-5)
    assert torch.equal(got, da.decode_attention(q, k, v, kp, qp))
    nsplit = {"one-split": 1, "split64": 64}.get(case)
    if nsplit:
        assert da.split_plan(B, C, KV, sms)[0] == nsplit
    if case == "no-key-shard":
        assert torch.isneginf(lse[:5]).all() and not got[:5].any()
        assert torch.isfinite(lse[5:]).all()


def test_sharded_decode_merge_on_the_card(cuda):
    """A 2048-row cache cut into 4 sequence shards, as the ranks of
    ``model = 4`` hold it: each shard through the kernel with its
    log-sum-exp, merged by `lse_merge`, within 2e-5 of the whole cache's
    kernel call (rows with no key on some shards, one with none)."""
    from repro_torch.parallel.shard_attention import lse_merge

    B, C, H, KV, hd, M = 4, 2048, 14, 2, 64, 4
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    pos[1, 700:] = -1
    pos[2] = -1
    q_pos = np.array([C - 1, C - 1, C - 1, 900], np.int32)
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((B, H, hd), generator=g, device=cuda)
    k = torch.randn((B, C, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, C, KV, hd), generator=g, device=cuda)
    kp, qp = (torch.as_tensor(x, device=cuda) for x in (pos, q_pos))
    whole = ops.decode_attention(q, k, v, kp, qp)
    n = C // M
    parts = [ops.decode_attention(q, k[:, r * n:(r + 1) * n].contiguous(),
                                  v[:, r * n:(r + 1) * n].contiguous(),
                                  kp[:, r * n:(r + 1) * n].contiguous(), qp,
                                  return_lse=True) for r in range(M)]
    got = lse_merge(torch.stack([o for o, _ in parts]),
                    torch.stack([lse for _, lse in parts]))
    torch.testing.assert_close(got, whole, atol=2e-5, rtol=2e-5)
    assert not got[2].any()


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


def _kernel_names(fn, calls=5, tries=3) -> list:
    """The CUDA kernel events that ``calls`` calls of ``fn`` record under
    the profiler, by name (profiled again, up to ``tries`` times, while
    it records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count]
        if names:
            return names
    return []


def _one_kernel(fn, name, calls=20, tries=3):
    """Run ``fn`` ``calls`` times under the profiler; assert every CUDA
    kernel event is ``name`` (no torch op ran on the card around it).
    The profiler at times records no kernel event of a run at all; then
    the calls are profiled again, up to ``tries`` times (as
    `chip_smoke.kernel_device_ms` does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count]
        if kernels:
            break
    assert kernels and all(name in e.key for e in kernels), \
        [e.key for e in kernels]


@pytest.mark.parametrize("case", ["wrap", "idle-tenants", "all-dead",
                                  "one-row", "row-limit"])
def test_qos_round_one_launch_bit_exact(cuda, case):
    """`ops.qos_round` on the card as the engine calls it — ``now`` and
    ``free_units`` as device scalars, N as it comes (not a power of two)
    — is one kernel launch, bit-exact to the plain round: tickets
    straddling 2³², tenants with no rows, an all-dead backlog, one row
    (one CTA's kernel and nothing else), and one row past the one-CTA
    kernel's 16384 (the large path: the ticket order sorted by torch,
    then the large kernel)."""
    rng = np.random.default_rng(len(case))
    S, N, T, mu, density = 5, 1000, 256, 64, 0.8
    if case == "all-dead":
        density = 0.0
    elif case == "one-row":
        N = 1
    elif case == "row-limit":
        N = qos_admission.MAX_ROWS + 1
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
    if case != "row-limit":
        _one_kernel(lambda: ops.qos_round(st, ids, tks, alive, dls, now,
                                          free, max_units=mu),
                    "qos_round_kernel")
    else:
        assert qos_admission.large_path(N, S)
        names = _kernel_names(lambda: ops.qos_round(
            st, ids, tks, alive, dls, now, free, max_units=mu))
        assert any("qos_round_large_kernel" in k for k in names), names


@pytest.mark.parametrize("S,N,case", [(300, 20000, "general"),
                                      (300, 20000, "wrap"),
                                      (1024, 4096, "all-dead"),
                                      (3, 16385, "zero-free"),
                                      (257, 64, "idle-tenants")])
def test_qos_large_path_bit_exact(cuda, S, N, case):
    """Past the one-CTA kernel's tenants or rows the wrapper takes the
    large path: bit-exact to the plain round, to its CPU twin
    `ref.qos_round_large_ref`, and over a K=4 scan to
    `ref.qos_round_scan_ref`."""
    rng = np.random.default_rng(S + N)
    T, mu = 256, 64
    st = fq.make_qos(rng.uniform(0.5, 3, S), table_size=T, device=cuda)
    b = u32.u32(np.full(S, (1 << 32) - N // (2 * S) if case == "wrap"
                        else 7), device=cuda)
    st = st._replace(ticket=b, grant=b, consumed=b,
                     dead=torch.as_tensor(rng.integers(0, 4, S), device=cuda))
    ids = rng.integers(0, S, N).astype(np.int32)
    if case == "idle-tenants":
        ids = (ids // 7 * 7).astype(np.int32)
    ids = torch.as_tensor(ids, device=cuda)
    st, tks, _, _ = fq.qos_take(st, ids, torch.ones(N, dtype=torch.bool,
                                                    device=cuda))
    density = 0.0 if case == "all-dead" else 0.8
    alive = torch.as_tensor(rng.random(N) < density, device=cuda)
    dls = torch.as_tensor(np.where(rng.random(N) < 0.2, rng.uniform(-1, 1, N),
                                   np.inf).astype(np.float32), device=cuda)
    free = 0 if case == "zero-free" else 200
    assert qos_admission.large_path(N, S)
    want = fq.qos_round(st, ids, tks, alive, dls, 0.0, free, mu)
    got = qos_admission.qos_round_fused(st, ids, tks, alive, dls, 0.0, free,
                                        max_units=mu)
    twin = ref.qos_round_large_ref(*(convert_tree_cpu(x) for x in (
        st, ids, tks, alive, dls)), 0.0, free, mu)
    for g, w, c in zip([*got[0], *got[1:]], [*want[0], *want[1:]],
                       [*twin[0], *twin[1:]]):
        if g.dtype == torch.float32:
            g, w, c = (x.view(torch.int32) for x in (g, w, c))
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert torch.equal(g.cpu(), c)
    nows = torch.linspace(-0.5, 1.0, 4, device=cuda)
    released = torch.tensor([0, 3, 1, 8], dtype=torch.int32, device=cuda)
    free0 = torch.full((), 16, dtype=torch.int32, device=cuda)
    want = ref.qos_round_scan_ref(st, ids, tks, alive, dls, nows, free0,
                                  released, mu)
    got = qos_admission.qos_round_scan(st, ids, tks, alive, dls, nows, free0,
                                       released, max_units=mu)
    for g, w in zip(got[0], want["state"]):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
    for g, k in zip(got[1:], ("admit_round", "expire_round", "free")):
        assert torch.equal(g, want[k])


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
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return _to_numpy_tree(tree._asdict())
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


_CHUNKED = dict(kv_pool=(16, 4), chunked_prefill=(5, 9, 16))
RUNG_CASES = {
    # name: (engine keywords, megastep?, corruption (kind, delta, arg))
    "host-upfront": (STEP_MODES["paged"], False, [("kv_counter", -2, 0)]),
    "host-sharing": (STEP_MODES["sharing"], False, [("kv_counter", -1, 0)]),
    "device-chunked": (_CHUNKED, True, [("double_release", 0, 0),
                                        ("bit_flip", 1, 2)]),
    "device-sharing": (STEP_MODES["sharing"], True, [("bit_flip", 3, 1),
                                                     ("kv_counter", 2, 0)]),
}


@pytest.mark.parametrize("name", sorted(RUNG_CASES))
def test_quarantine_and_audit_on_the_card_match_the_cpu(cuda, name):
    """The recovery rungs on a CUDA engine (its QoS kernel and, on the
    megastep, its paged kernels ran before the corruption) against the
    same calls on a CPU engine: the same fault target, ``audit_kv``
    report, quarantined requests, exit audit, pool, table and mirrors,
    and the same samples for the rounds after the repair."""
    from repro_torch.resilience import FaultEvent, apply_fault, exit_audit
    from repro_torch.serving.engine_state import drain, rid_token_fn
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, \
        Request

    kw, mega, corrupt = RUNG_CASES[name]
    sharing = "prefix_cache" in kw
    rng = np.random.default_rng(2)
    trace = [dict(rid=i, prompt=[1 + i % 7] * int(rng.integers(1, 19)),
                  max_new_tokens=1 + int(rng.integers(0, 10)),
                  tenant_id=("gold", "bronze")[i % 2]) for i in range(12)]

    def rid_step(active):
        return np.array([r.rid * 1000 + len(r.out_tokens) for r in active],
                        np.int64)

    def rounds(eng, clk, start, n):
        if mega:
            eng.megastep(n, token_fn=rid_token_fn, nows=[
                (start + k) * 0.25 for k in range(n)])
            return list(eng._last_samples)
        out = []
        for k in range(start, start + n):
            clk[0] = k * 0.25
            eng.step(lambda lg: lg.astype(np.int64))
            out += eng._last_samples
        return out

    runs = []
    for dev in (cuda, torch.device("cpu")):
        clk = [0.0]
        eng = ContinuousBatchingEngine(
            rid_step, lambda r: None, 4, tenants={"gold": 2.0,
                                                  "bronze": 1.0},
            use_kernel=True, clock=lambda: clk[0], watchdog=3, device=dev,
            **{"prompt_cap": 32, **kw})
        reqs = [Request(**t) for t in trace]
        eng.submit_batch(reqs)
        rounds(eng, clk, 0, 4)
        applied = [apply_fault(eng, FaultEvent(round=4, kind=k, delta=d,
                                               arg=a))
                   for k, d, a in corrupt]
        broken = exit_audit(eng)
        rep = eng.audit_kv()
        victims = [s for s in rep["victims"] if s in eng.active] or \
            sorted(eng.active)[:1]
        gone = [eng.quarantine(s).rid for s in victims]
        healed = exit_audit(eng)
        kv = eng._kv_state if mega else (
            (eng._kv_hpool, eng._kv_htbl) if sharing else ())
        state = drain((eng.qos, eng._kv_sema, kv))
        after = rounds(eng, clk, 4, 4)
        runs.append((applied, broken, rep, gone, healed,
                     [np.asarray(x).tolist() for x in _leaves(state)],
                     eng._kv_free_blocks, after,
                     [(r.out_tokens, r.slot) for r in reqs]))
    assert not runs[0][1]["ok"] and runs[0][4]["ok"]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 259, 24, 8, 64, 0), (2, 259, 16, 16, 128, 0),
    (1, 2304, 16, 1, 256, 2048), (1, 300, 16, 1, 256, 100)])
def test_flash_attention_block_kind_heads(cuda, B, S, H, KV, hd, window):
    """The flash kernel at the heads of the other block kinds' configs:
    granite-moe (G = 3), deepseek-moe (hd = 128, G = 1) and
    recurrentgemma (MQA, G = 16 at hd = 256: one query position a tile)
    with its 2048 window binding at S = 2304; within 2e-5 of the plain
    version, one launch."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn((B, S, H, hd), generator=g, device=cuda)
    k = torch.randn((B, S, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, S, KV, hd), generator=g, device=cuda)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, window=window)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v, window=window), atol=2e-5,
        rtol=2e-5)


@pytest.mark.parametrize("H,KV,hd", [(24, 8, 64), (16, 16, 128),
                                     (16, 1, 256)])
def test_decode_attention_block_kind_heads(cuda, H, KV, hd):
    """The decode kernel at the same heads over a 2048-row rolling ring
    whose queries lie up to 2048 positions past it, so that a 2048 window
    masks the oldest keys; within 2e-5 of the plain version."""
    from repro_torch.kernels.decode_attention import decode_attention_plain

    B, C, window = 8, 2048, 2048
    rng = np.random.default_rng(hd)
    pos = np.tile(((np.arange(C) + 37) % C).astype(np.int32), (B, 1))
    pos[0, C // 2:] = -1
    q_pos = (rng.integers(0, C, B) + C // 2).astype(np.int32)
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = torch.randn((B, H, hd), generator=g, device=cuda)
    k = torch.randn((B, C, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, C, KV, hd), generator=g, device=cuda)
    kp, qp = (torch.as_tensor(x, device=cuda) for x in (pos, q_pos))
    got = ops.decode_attention(q, k, v, kp, qp, window=window)
    torch.testing.assert_close(
        got, decode_attention_plain(q, k, v, kp, qp, window=window),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "xlstm-350m"])
def test_block_kinds_on_the_card_match_the_cpu(cuda, arch):
    """The other block kinds' smoke models on the card against the same
    weights on the CPU (prefill, then a decode step; 2e-4), the decode
    step free of host syncs (`set_sync_debug_mode("error")`)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer as tt

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
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
        tok = toks[:, 20:].to(dev)
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            ld, _ = tt.decode_step(p, cfg, tok, pos, caches)
        finally:
            if dev != "cpu":
                torch.cuda.set_sync_debug_mode(0)
        out[str(dev)] = (lg.cpu(), ld.cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b, a, atol=2e-4, rtol=2e-4)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One `make_train_step` step of the qwen2-0.5b smoke config on the
    card against the same step on the CPU from the same weights (TF32
    off): the loss and ``grad_norm`` within 1e-4 relative, the gradient
    (Adam's first moment) within 1e-4 of each leaf's largest magnitude,
    every updated parameter within 1e-5 relative plus 0.01·lr where its
    gradient element exceeds 1e3·eps and within one step (lr) elsewhere
    (Adam's first step moves a weight by lr·g/(|g| + eps): near eps the
    rounding of g reaches the weight at full scale), as
    `chip_smoke.train_parity` holds the eight smoke configs."""
    from repro_torch.configs.registry import ShapeSpec, get_smoke_config
    from repro_torch.optim.adamw import AdamWConfig, leaves
    from repro_torch.parallel import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("qwen2-0.5b")
    shape = ShapeSpec("t", 32, 4, "train")
    sc = steps.default_step_config(cfg, shape, param_dtype=torch.float32)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = steps.make_train_state(torch.Generator().manual_seed(0), cfg,
                                   sc, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (4, 32)))
             for k in ("tokens", "labels")}
    out = {}
    for dev in ("cpu", cuda):
        st = convert.tree_from_jax(_to_numpy_tree(state._asdict()),
                                   device=dev)
        st = steps.TrainState(st["params"], steps.OptState(**st["opt"]), {})
        st, m = steps.make_train_step(cfg, shape, sc, opt)(
            st, {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = (m["loss"].cpu(), m["grad_norm"].cpu(),
                         [p.cpu() for p in leaves(st.params)],
                         [mu.cpu() for mu in leaves(st.opt.mu)])
    (l0, g0, p0, m0), (l1, g1, p1, m1) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(l1, l0, atol=0, rtol=1e-4)
    torch.testing.assert_close(g1, g0, atol=0, rtol=1e-4)
    for a, b, mu, mu1 in zip(p0, p1, m0, m1):
        assert (mu1 - mu).abs().max() <= 1e-4 * mu.abs().max()
        well = mu.abs() > 1e3 * opt.eps * (1 - opt.beta1)
        err = (b - a).abs() - 1e-5 * a.abs()
        assert err[well].max() <= 0.01 * opt.lr
        assert err.max() <= opt.lr


def test_toy_cluster_on_the_card_matches_the_cpu(cuda):
    """The router's chaos scenario (4 replicas, a seeded cluster plan with
    a kill, a straggler, a KV partition and a leaked ticket, standby and
    snapshots) with every replica engine on the card (its QoS kernel each
    megastep round) against the same scenario on the CPU: streams, shed
    reasons, stats, events, the reaper's actions, the lease and engine
    audits and the spans per request bit-equal."""
    import shutil

    from repro_torch.kernels import build
    from repro_torch.resilience import FaultPlan
    from repro_torch.serving.router import toy_cluster, toy_workload

    def run(dev, seed):
        r = toy_cluster(4, seed=seed, device=dev, standby=True,
                        snapshot_every=4,
                        plan=FaultPlan.cluster(seed, rounds=8, n_replicas=4))
        r.submit_batch(toy_workload(10, seed=seed + 1))
        try:
            rep = r.run(max_rounds=150)
        finally:
            for x in r.replicas:
                shutil.rmtree(x.rz.ckpt.dir, ignore_errors=True)
        spans = {rid: (sp["terminal"],
                       [(g["name"], g["replica"]) for g in sp["segments"]],
                       sp["replicas"])
                 for rid, sp in r.cluster_spans().items()}
        return (rep, dict(r.completed), dict(r.shed), list(r.events),
                [(a.lease, a.ticket, a.action, a.age)
                 for a in r.reaper.actions], spans)

    for seed in (0, 866):
        before = build.LAUNCHES["qos_round_fused"]
        card = run(cuda, seed)
        assert build.LAUNCHES["qos_round_fused"] > before
        assert card == run(torch.device("cpu"), seed)
        if seed == 866:  # the reference's fault, reproduced on the card
            assert card[1][5] == [5000, 5001, 5002]


# ------------------------------------------------- bf16 instantiations ---

# a bf16 kernel against its plain version in bf16: within BF16_ULPS bf16
# ulps of each output row's largest magnitude (both round P to bf16,
# against running maxima taken at different points) and within the outer
# BF16_TOL; the log-sum-exp within BF16_LSE_TOL
BF16_ULPS, BF16_TOL, BF16_LSE_TOL = 2.0, 2.0 ** -7, 1e-5


def _bf16_close(got, want):
    assert got.dtype == want.dtype
    g, w = got.float(), want.float()
    top = w.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulps = (g - w).abs() / torch.exp2(torch.floor(torch.log2(top)) - 7)
    assert bool((ulps <= BF16_ULPS).all()), float(ulps.max())
    torch.testing.assert_close(g, w, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("H,KV,hd,window,rolling", [
    (14, 2, 64, 0, False), (14, 2, 64, 5, True), (1, 1, 896, 0, True),
    (4, 4, 40, 3, False), (24, 8, 64, 0, True), (16, 16, 128, 0, False),
    (16, 1, 256, 50, True), (4, 2, 18, 0, False)])
def test_decode_attention_bf16_close(cuda, H, KV, hd, window, rolling):
    """The decode kernel's bf16 instantiation at the f32 cases' shapes
    (and the block kinds' heads, and hd = 18 off the 16-byte copy):
    bf16 in, bf16 out, within `_bf16_close`'s limits of the plain
    version in bf16, one launch of the bf16 kernel and none of the f32
    one; a row with no key outputs 0."""
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
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, H, hd), (B, C, KV, hd), (B, C, KV, hd)))
    kp, qp = (torch.as_tensor(x, device=cuda) for x in (pos, q_pos))
    ops.reset_launch_counts()
    got = ops.decode_attention(q, k, v, kp, qp, window=window)
    counts = ops.launch_counts()
    assert counts["decode_attention_bf16"] == 1
    assert counts["decode_attention"] == 0
    _bf16_close(got, decode_attention_plain(q, k, v, kp, qp, window=window))
    assert not got[1].any()


@pytest.mark.parametrize("case", list(_LSE_CASES))
def test_decode_attention_bf16_lse_close(cuda, case):
    """``return_lse`` on bf16 inputs: the output stays f32 (a partial to
    merge) and the log-sum-exp f32, within `_bf16_close`'s limits and
    `BF16_LSE_TOL` of the plain version's, −inf where it is; the default call's bf16 output is the
    partial rounded.  The cases of the f32 test, their split counts."""
    from repro_torch.kernels import decode_attention as da

    B, C = _LSE_CASES[case]
    H, KV, hd = 14, 2, 64
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    q_pos = np.full(B, C - 1, np.int32)
    if case == "no-key-shard":
        pos[:4] += C
        pos[4] = -1
    g = torch.Generator(device=cuda).manual_seed(C + B)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, H, hd), (B, C, KV, hd), (B, C, KV, hd)))
    kp, qp = (torch.as_tensor(x, device=cuda) for x in (pos, q_pos))
    got, lse = ops.decode_attention(q, k, v, kp, qp, return_lse=True)
    want, want_lse = da.decode_attention_plain(q, k, v, kp, qp,
                                               return_lse=True)
    assert got.dtype == lse.dtype == torch.float32
    _bf16_close(got, want)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want_lse))
    fin = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[fin], want_lse[fin], atol=BF16_LSE_TOL,
                               rtol=0.0)
    assert torch.equal(da.decode_attention_bf16(q, k, v, kp, qp),
                       got.to(torch.bfloat16))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,window", [
    (2, 77, 77, 14, 2, 64, 0), (1, 130, 130, 4, 1, 64, 16),
    (2, 33, 50, 2, 2, 40, 0), (1, 64, 64, 8, 8, 128, 7),
    (1, 20, 20, 4, 1, 256, 0), (2, 512, 512, 14, 2, 64, 0),
    (1, 512, 512, 14, 2, 64, 200), (1, 300, 300, 8, 2, 256, 0),
    (2, 45, 45, 6, 3, 18, 0), (1, 70, 70, 4, 4, 16, 9),
    (2, 259, 259, 24, 8, 64, 0), (2, 259, 259, 16, 16, 128, 0),
    (1, 2304, 2304, 16, 1, 256, 2048)])
def test_flash_attention_bf16_close(cuda, B, Sq, Sk, H, KV, hd, window):
    """The flash kernel's bf16 path at the f32 cases' shapes: ragged Sq
    and Sk, GQA stacking, windows, hd from 16 to 256 (18 and 40 off the
    16-byte copy and the k16 step), the block kinds' heads — hd 64, 128
    and 256 on the wgmma kernel, the others on the mma.sync
    instantiation; bf16 out within `_bf16_close`'s limits of the plain
    version in bf16, one launch of the bf16 kernel and none of the f32
    one."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    g = torch.Generator(device=cuda).manual_seed(Sq + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, window=window)
    counts = ops.launch_counts()
    assert counts["flash_attention_bf16"] == 1
    assert counts["flash_attention"] == 0
    _bf16_close(got, flash_attention_plain(q, k, v, window=window))


def test_attention_kernels_refuse_other_dtypes(cuda):
    """An fp16 (or mixed) input on the card raises: the routing takes f32
    and bf16 only (TypeError), the bf16-only wrappers take only bf16 and
    a cache only of q's dtype (ValueError) — nothing is cast and nothing
    falls back to the plain version."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    h = torch.float16
    q = torch.zeros((2, 14, 64), dtype=h, device=cuda)
    k = torch.zeros((2, 32, 2, 64), dtype=h, device=cuda)
    kp = torch.zeros((2, 32), dtype=torch.int32, device=cuda)
    qp = torch.zeros(2, dtype=torch.int32, device=cuda)
    qf = torch.zeros((2, 8, 14, 64), dtype=h, device=cuda)
    kf = torch.zeros((2, 8, 2, 64), dtype=h, device=cuda)
    ops.reset_launch_counts()
    for fn in (ops.decode_attention, da.decode_attention):
        with pytest.raises(TypeError, match="float16"):
            fn(q, k, k, kp, qp)
    for fn in (ops.flash_attention, fa.flash_attention):
        with pytest.raises(TypeError, match="float16"):
            fn(qf, kf, kf)
    with pytest.raises(ValueError):
        da.decode_attention_bf16(q, k, k, kp, qp)
    with pytest.raises(ValueError):
        fa.flash_attention_bf16(qf, kf, kf)
    with pytest.raises(ValueError):   # bf16 queries over an f32 cache
        ops.decode_attention(q.to(torch.bfloat16), k.float(), k.float(), kp,
                             qp)
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("hd,kernel", [(64, "decode_tc_kernel"),
                                       (128, "decode_tc_kernel"),
                                       (256, "decode_attention_kernel"),
                                       (40, "decode_attention_kernel")])
def test_decode_attention_bf16_routes_by_head_width(cuda, hd, kernel):
    """The bf16 decode takes the tensor-core kernel where hd is a
    multiple of 16 up to 128 and the CUDA-core instantiation elsewhere;
    both hold the plain version within `_bf16_close`'s limits over a
    2048-row cache in 8 splits (B=8, KV=2), the merge in the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import decode_attention_plain

    B, C, H, KV = 8, 2048, 14, 2
    pos = torch.arange(C, dtype=torch.int32, device=cuda).repeat(B, 1)
    pos[0, C // 3:] = -1
    qp = torch.full((B,), C - 1, dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((B, H, hd), (B, C, KV, hd), (B, C, KV, hd)))
    names = []
    for _ in range(3):   # the profiler drops events, whole profiles at times
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                got = ops.decode_attention(q, k, v, pos, qp, window=700)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count]
        if names:
            break
    assert any(kernel in n for n in names), names
    _bf16_close(got, decode_attention_plain(q, k, v, pos, qp, window=700))


# the wgmma kernel (csrc/flash_attention_sm90.cu): hd 64, 128, 256; G =
# H / KV of 1, 2, 7, 8, 16 and 128; causal and windowed; Sq != Sk; S off
# the 128- and 64-key tiles and off a CTA's 128 // G positions; B > 1;
# rows with no visible key (Sq past Sk + window, whole CTAs of them)
_WGMMA_CASES = [
    (1, 129, 129, 4, 4, 64, 0), (2, 300, 300, 14, 2, 64, 0),
    (1, 1000, 1000, 14, 2, 64, 256), (2, 200, 333, 16, 2, 64, 0),
    (1, 333, 200, 32, 2, 64, 0), (1, 20, 20, 128, 1, 64, 0),
    (1, 300, 100, 14, 2, 64, 50), (1, 257, 257, 4, 2, 128, 0),
    (2, 190, 190, 16, 16, 128, 0), (1, 500, 500, 56, 7, 128, 100),
    (1, 300, 300, 14, 2, 128, 0), (1, 2304, 2304, 16, 1, 256, 2048),
    (2, 150, 150, 8, 4, 256, 0), (1, 130, 130, 7, 1, 256, 0),
    (1, 400, 150, 16, 1, 256, 60)]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,window", _WGMMA_CASES)
def test_flash_attention_bf16_wgmma_close(cuda, B, Sq, Sk, H, KV, hd,
                                          window):
    """The wgmma kernel against the plain version in bf16 within
    `_bf16_close`'s limits, its route counted (`ops.flash_routes`) beside
    one ``flash_attention_bf16`` launch and no f32 one; a row that sees no
    key outputs exact zeros."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(Sq * 7 + hd + H)
    q = torch.randn((B, Sq, H, hd), generator=g, device=cuda)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=cuda)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=cuda)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    assert fa.wgmma_route(q, k, v)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, window=window)
    counts = ops.launch_counts()
    assert counts["flash_attention_bf16"] == 1
    assert counts["flash_attention"] == 0
    assert ops.flash_routes() == {"wgmma": 1, "mma_sync": 0}
    _bf16_close(got, fa.flash_attention_plain(q, k, v, window=window))
    if window:
        blind = Sk + window - 1   # positions from here on see no key
        if blind < Sq:
            assert not got[:, blind:].any()


@pytest.mark.parametrize("case", ["hd16", "hd40", "hd96", "unaligned"])
def test_flash_attention_bf16_routes_by_shape(cuda, case):
    """Shapes outside the wgmma kernel's take the mma.sync instantiation:
    a head width other than 64, 128, 256; q 2 bytes off a 16-byte
    boundary (TMA's rule).  Each is counted on its route and holds the
    plain version."""
    from repro_torch.kernels import flash_attention as fa

    B, S, H, KV, hd = 1, 100, 14, 2, 64
    if case.startswith("hd"):
        hd = int(case[2:])
    g = torch.Generator(device=cuda).manual_seed(5)
    n = B * S * H * hd
    if case == "unaligned":
        buf = torch.randn(n + 1, generator=g, device=cuda).to(torch.bfloat16)
        q = buf[1:].view(B, S, H, hd)
        assert q.is_contiguous() and q.data_ptr() % 16 == 2
    else:
        q = torch.randn((B, S, H, hd), generator=g,
                        device=cuda).to(torch.bfloat16)
    k, v = (torch.randn((B, S, KV, hd), generator=g,
                        device=cuda).to(torch.bfloat16) for _ in range(2))
    assert not fa.wgmma_route(q, k, v)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v)
    assert ops.flash_routes() == {"wgmma": 0, "mma_sync": 1}
    assert ops.launch_counts()["flash_attention_bf16"] == 1
    _bf16_close(got, fa.flash_attention_plain(q, k, v))
