"""The arithmetic of the redesigned paged-decode and ``sema_batch`` kernels,
on the CPU, against the JAX package's Pallas kernels run in interpret mode.
A CUDA kernel cannot run here, so these hold its plain twins:

* `ref.paged_decode_split_ref` — ``csrc/paged_decode.cu``'s cut of the
  round's live pool blocks among one wave of CTAs
  (`paged_decode.split_plan`), the per-piece partials and the log-sum-exp
  merge — against JAX's ``paged_decode`` and its blockwise oracle within
  1e-5 (the split merges in another order than the one-block-at-a-time
  recurrence): ragged lengths with 0 and MB·BS, -1 table tails, G ∈ {1, 2,
  7}, grids of 1, 3 and 7 CTAs and more CTAs than blocks; and
  `split_plan` at the engine's shapes and at edge shapes.
* `ops.sema_batch` on the CPU with the carrier interface the kernel takes
  — scalars as int64 tensors or ints, the waiting array as int64
  carriers — bit-equal to JAX's ``sema_batch`` in interpret mode across
  the 2³² wrap, its outputs in the dtypes the kernel writes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_decode import paged_decode as j_paged_decode
from repro.kernels.sema_batch import sema_batch as j_sema_batch
from repro_torch.core import u32
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_decode import block_costs, split_plan

TOL = 1e-5
H100_SMS = 132


def _decode_case(seed, S, H, KV, hd, BS, MB, lens, holes=False):
    """q and pools from a numpy seed; each slot's blocks from a
    permutation of the pool, -1 past them (and, with ``holes``, a -1
    inside a slot's live blocks: read as block 0, as the reference reads
    it)."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    need = [-(-int(n) // BS) for n in lens]
    NB = sum(need) + 4
    q = rng.normal(size=(S, H, hd)).astype(np.float32)
    kp = rng.normal(size=(NB, BS, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, KV, hd)).astype(np.float32)
    ids = rng.permutation(NB)
    tbl = np.full((S, MB), -1, np.int32)
    p = 0
    for s, nb in enumerate(need):
        tbl[s, :nb] = ids[p:p + nb]
        p += nb
    if holes:
        s = int(np.argmax(need))
        tbl[s, need[s] // 2] = -1
    return q, kp, vp, tbl, lens


DECODE_CASES = {
    # name: (S, H, KV, hd, BS, MB, lens, grid, holes)
    "g1-one-cta": (5, 1, 1, 16, 4, 6, [0, 24, 7, 1, 13], 1, False),
    "g1-grid3": (5, 1, 1, 16, 4, 6, [0, 24, 7, 1, 13], 3, False),
    "g2-grid7": (6, 4, 2, 8, 4, 5, [20, 0, 3, 17, 20, 9], 7, False),
    "g7-grid3": (4, 14, 2, 8, 8, 4, [32, 5, 0, 19], 3, True),
    "g7-grid7-holes": (4, 7, 1, 12, 4, 8, [32, 31, 2, 0], 7, True),
    # more CTAs than blocks: one block a CTA
    "g2-wide-grid": (4, 2, 1, 8, 4, 5, [20, 0, 6, 11], 132, False),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_split_decode_matches_jax_paged_decode(name):
    """Per-piece partials and the log-sum-exp merge against JAX's Pallas
    ``paged_decode`` in interpret mode and its blockwise oracle within
    1e-5; idle slots output 0; with more than one CTA, slots are cut
    across CTAs (with more CTAs than blocks, a block a CTA)."""
    S, H, KV, hd, BS, MB, lens, grid, holes = DECODE_CASES[name]
    args = _decode_case(len(name), S, H, KV, hd, BS, MB, lens, holes)
    jargs = tuple(jnp.asarray(x) for x in args)
    pallas = np.asarray(j_paged_decode(*jargs, interpret=True))
    oracle = np.asarray(jref.paged_decode_ref(*jargs))
    got, parts = ref.paged_decode_split_ref(
        *(torch.as_tensor(x) for x in args), grid)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(
        got, ref.paged_decode_ref(*(torch.as_tensor(x) for x in args)),
        atol=TOL, rtol=TOL)
    cut = [p for p in parts if p[0][4] is not None]
    assert bool(cut) == (grid > 1)
    for s, n in enumerate(lens):
        if n == 0:
            assert not got[s].any()
    for (pr, k0, k1, _, _), m, l, acc in parts:
        assert k1 > k0 and bool(torch.isfinite(m).all())
        assert m.shape == l.shape == (H // KV,) and acc.shape == (H // KV, hd)


def _check_plan(lens, KV, BS, MB, grid):
    """Every live block on exactly one CTA, the CTAs' loads within one of
    each other, a cut pair's partials in distinct (CTA, slot) places."""
    costs = block_costs(lens, KV, BS, MB)
    pieces = split_plan(lens, KV, BS, MB, grid)
    seen, places, load = {}, set(), {}
    for pr, k0, k1, b, slot in pieces:
        assert 0 <= k0 < k1 <= costs[pr] and 0 <= b < grid
        seen.setdefault(pr, []).append((k0, k1))
        load[b] = load.get(b, 0) + k1 - k0
        if slot is not None:
            assert (b, slot) not in places
            places.add((b, slot))
    for pr, c in enumerate(costs):
        runs = sorted(seen.get(pr, []))
        assert sum(k1 - k0 for k0, k1 in runs) == c
        assert all(x[1] == y[0] for x, y in zip(runs, runs[1:]))
    if load:
        assert max(load.values()) - min(load.values()) <= 1
        assert len(load) == min(sum(costs), grid)
    return pieces


@pytest.mark.parametrize("shape", ["up-front", "chunked"])
@pytest.mark.parametrize("grid", [H100_SMS, 2 * H100_SMS])
def test_decode_split_plan_at_the_engine_shapes(shape, grid):
    """The two main paths' rounds, S = 256 slots, H = KV = 1, BS = 16:
    the up-front pool's 32-block tables holding up to 256 tokens a slot
    (~31k live tokens), and the chunked pool's 72-block tables with the
    4096 blocks all live (slots of 0 to 72 blocks).  Every CTA within one
    block of W / grid; a slot longer than a CTA's share is cut across
    CTAs (in the chunked round, the longest is)."""
    rng = np.random.default_rng(grid)
    S, BS = 256, 16
    if shape == "up-front":
        MB = 32
        lens = rng.integers(0, 257, S)
    else:
        MB = 72
        lens = np.minimum(rng.exponential(256, S), MB * BS).astype(np.int64)
        lens[:8] = 0
        lens[-1] = MB * BS
    pieces = _check_plan(lens, 1, BS, MB, grid)
    costs = block_costs(lens, 1, BS, MB)
    share = -(-sum(costs) // grid)
    long = {pr for pr, c in enumerate(costs) if c > share}
    assert long or shape == "up-front"
    assert all(p[4] is not None for p in pieces if p[0] in long)


@pytest.mark.parametrize("lens,KV,BS,MB,grid", [
    ([0] * 8, 1, 16, 72, 132),        # all idle: no piece
    ([5], 1, 4, 8, 1),                # one slot, one CTA
    ([1152], 1, 16, 72, 132),         # one slot over 72 CTAs
    ([2000, 3], 2, 16, 72, 7),        # a length past the table: MB blocks
    ([9, 0, 1, 0, 33], 2, 4, 9, 132),  # fewer blocks than CTAs
    ([36, 36, 36], 1, 4, 9, 5),       # cuts at both ends of a CTA's range
    ([1] * 300, 1, 16, 4, 7)])        # many one-block slots a CTA
def test_decode_split_plan_edges(lens, KV, BS, MB, grid):
    _check_plan(lens, KV, BS, MB, grid)


@pytest.mark.parametrize("grid", [1, 2, 6])
def test_split_decode_twin_matches_the_oracle_long_table(grid):
    """Over a 160-block table (one slot at its full 640 tokens, G = 3),
    the split reference cut for 1, 2 and 6 CTAs agrees with the unsplit
    plain version within 1e-5."""
    S, H, KV, hd, BS, MB = 3, 3, 1, 8, 4, 160
    args = _decode_case(grid, S, H, KV, hd, BS, MB, [640, 77, 0])
    targs = tuple(torch.as_tensor(x) for x in args)
    got, _ = ref.paged_decode_split_ref(*targs, grid)
    torch.testing.assert_close(got, ref.paged_decode_ref(*targs), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("base", [(1 << 32) - 300, 12345])
@pytest.mark.parametrize("form", ["int64", "int", "mixed"])
def test_sema_batch_carriers_match_jax(base, form):
    """The kernel's carrier interface on the plain path: the four scalars
    as one-element int64 tensors, as ints, or mixed as ``submit_batch``
    passes them (ticket and grant carriers, post_n and salt ints), the
    waiting array as int64 carriers;
    bit-equal to JAX's ``sema_batch`` in interpret mode, with a batch that
    crosses the 2³² wrap, and every output in the dtype the kernel writes
    (u32 carriers int64, buckets int32, masks bool)."""
    rng = np.random.default_rng(base % 97)
    N, T = 700, 64
    req = rng.random(N) < 0.7
    seq = rng.integers(0, 1 << 32, T, dtype=np.uint64).astype(np.uint32)
    scal = [base, base + 40, 37, 0x9E3779B9]

    def carrier(x, i):
        x &= u32.MASK32
        if form == "int" or (form == "mixed" and i >= 2):
            return x
        return torch.tensor(x, dtype=torch.int64)

    got = ops.sema_batch(carrier(scal[0], 0), carrier(scal[1], 1),
                         u32.u32(seq), torch.as_tensor(req),
                         carrier(scal[2], 2), carrier(scal[3], 3))
    want = j_sema_batch(*(jnp.uint32(x & u32.MASK32) for x in scal[:2]),
                        jnp.asarray(seq), jnp.asarray(req),
                        jnp.uint32(scal[2]), jnp.uint32(scal[3]),
                        interpret=True)
    dtypes = (torch.int64,) * 4 + (torch.bool, torch.int32, torch.bool)
    for g, w, dt in zip(got, want, dtypes):
        assert g.dtype == dt
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))
    assert got[0].dim() == 0 and got[1].dim() == 0
