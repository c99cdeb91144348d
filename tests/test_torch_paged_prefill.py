"""The port's paged-prefill plain version (`repro_torch.kernels.ref.
paged_prefill_ref`, and `kernels.ops.paged_prefill` on the CPU) against
the JAX package's blockwise oracle and its interpret-mode Pallas kernel,
on the cases of tests/test_paged_prefill.py: ragged mid-block offsets,
idle slots, GQA groups of 1 and 2, permuted tables; the writeback's
targets and isolation; split invariance of the pools.

The pools are compared bit for bit (the writes are copies).  The outputs
agree within atol = rtol = 1e-5 in f32: the port sums in another order
than XLA (batched matmuls over slots and heads)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from _hypothesis_shim import given, settings, strategies as st

from repro.kernels import ref as jref
from repro.kernels.paged_prefill import paged_prefill as j_paged_prefill
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)


def _mk(seed, S, CT, H, KV, hd, NB, BS, MB, offs, lens):
    """The inputs of tests/test_paged_prefill.py's ``_mk`` as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, CT, H, hd)).astype(np.float32)
    kc = rng.standard_normal((S, CT, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((S, CT, KV, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, BS, KV, hd)).astype(np.float32)
    perm = rng.permutation(NB)
    tbl = np.full((S, MB), -1, np.int32)
    n = 0
    for s in range(S):
        for i in range(-(-(int(offs[s]) + int(lens[s])) // BS)):
            tbl[s, i] = perm[n]
            n += 1
    return (q, kc, vc, kp, vp, tbl, np.asarray(offs, np.int32),
            np.asarray(lens, np.int32))


def _compare(args):
    """Port plain version and CPU dispatch vs the JAX oracle and the
    interpret-mode kernel.  Returns the port's ``(out, kp', vp')``."""
    want = [np.asarray(x) for x in jref.paged_prefill_ref(
        *map(jnp.asarray, args))]
    pallas = [np.asarray(x) for x in j_paged_prefill(
        *map(jnp.asarray, args), interpret=True)]
    t = [torch.as_tensor(x) for x in args]
    got = [x.numpy() for x in tref.paged_prefill_ref(*t)]
    via_ops = [x.numpy() for x in ops.paged_prefill(*t)]
    for ref_out in (want, pallas):
        np.testing.assert_allclose(got[0], ref_out[0], **TOL)
        np.testing.assert_array_equal(got[1], ref_out[1])
        np.testing.assert_array_equal(got[2], ref_out[2])
    for a, b in zip(via_ops, got):
        np.testing.assert_array_equal(a, b)
    # the plain version leaves its inputs alone
    np.testing.assert_array_equal(t[3].numpy(), args[3])
    return got


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**32 - 1))
def test_paged_prefill_plain_matches_jax_property(seed):
    """Random ragged offsets (mid-block starts included) and lengths, idle
    slots (len 0), GQA group 1 or 2, permuted tables."""
    rng = np.random.default_rng(seed)
    S, CT, KV, hd = 4, 8, 2, 8
    H = KV * int(rng.integers(1, 3))
    NB, BS, MB = 32, 4, 8
    offs = rng.integers(0, 16, S)
    lens = rng.integers(0, CT + 1, S)
    lens = np.where(offs + lens > MB * BS, 0, lens)
    lens[0] = 0                      # an idle slot every time
    offs[1] = 4 * int(rng.integers(0, 4)) + 2   # a mid-block start
    lens[1] = CT
    got = _compare(_mk(seed, S, CT, H, KV, hd, NB, BS, MB, offs, lens))
    assert not got[0][0].any()       # idle slots emit exactly zero


@pytest.mark.parametrize("H,KV", [(1, 1), (2, 2), (4, 2)])
def test_paged_prefill_writeback_targets_and_isolation(H, KV):
    """Every chunk token lands at its table slot and nothing else moves:
    other slots' blocks and unallocated blocks are bit-identical."""
    S, CT, hd = 2, 6, 4
    NB, BS, MB = 16, 4, 8
    offs, lens = np.asarray([3, 0]), np.asarray([5, 4])
    args = _mk(7, S, CT, H, KV, hd, NB, BS, MB, offs, lens)
    _, kp2, vp2 = _compare(args)
    q, kc, vc, kp, vp, tbl, _, _ = args
    touched = set()
    for s in range(S):
        for t in range(int(offs[s]), int(offs[s] + lens[s])):
            b, r = int(tbl[s, t // BS]), t % BS
            touched.add(b)
            np.testing.assert_array_equal(kp2[b, r], kc[s, t - int(offs[s])])
            np.testing.assert_array_equal(vp2[b, r], vc[s, t - int(offs[s])])
    for b in range(NB):
        if b not in touched:
            np.testing.assert_array_equal(kp2[b], kp[b])
            np.testing.assert_array_equal(vp2[b], vp[b])


@pytest.mark.parametrize("splits", [[11], [4, 4, 3], [1, 5, 2, 3],
                                    [2, 2, 2, 2, 2, 1]])
def test_chunked_prefill_split_invariance(splits):
    """One prompt through the plain version in any chunk split: every
    chunk's rows match the JAX oracle run on the same split, the pools
    equal the JAX pools after every chunk, and the final pool content is
    the same for every split (bit for bit)."""
    P, H, KV, hd = 11, 4, 2, 8
    NB, BS = 16, 4
    rng = np.random.default_rng(3)
    qf = rng.standard_normal((1, P, H, hd)).astype(np.float32)
    kf = rng.standard_normal((1, P, KV, hd)).astype(np.float32)
    vf = rng.standard_normal((1, P, KV, hd)).astype(np.float32)
    tbl = np.asarray([[2, 7, 5, -1]], np.int32)
    tk = torch.zeros((NB, BS, KV, hd))
    tv = torch.zeros((NB, BS, KV, hd))
    jk, jv = jnp.asarray(tk.numpy()), jnp.asarray(tv.numpy())
    CT = max(splits)
    off = 0
    for ln in splits:
        pad = ((0, 0), (0, CT - ln), (0, 0), (0, 0))
        qc, kc, vc = (np.pad(x[:, off:off + ln], pad) for x in (qf, kf, vf))
        o_a, len_a = np.asarray([off], np.int32), np.asarray([ln], np.int32)
        jo, jk, jv = jref.paged_prefill_ref(
            *map(jnp.asarray, (qc, kc, vc)), jk, jv, jnp.asarray(tbl),
            jnp.asarray(o_a), jnp.asarray(len_a))
        to, tk, tv = tref.paged_prefill_ref(
            *map(torch.as_tensor, (qc, kc, vc)), tk, tv,
            torch.as_tensor(tbl), torch.as_tensor(o_a),
            torch.as_tensor(len_a))
        np.testing.assert_allclose(to.numpy()[0, :ln], np.asarray(jo)[0, :ln],
                                   **TOL)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        off += ln
    _, k1, v1 = tref.paged_prefill_ref(
        *map(torch.as_tensor, (qf, kf, vf)), torch.zeros_like(tk),
        torch.zeros_like(tv), torch.as_tensor(tbl),
        torch.as_tensor(np.asarray([0], np.int32)),
        torch.as_tensor(np.asarray([P], np.int32)))
    blocks = tbl[0, :3]
    np.testing.assert_array_equal(tk.numpy()[blocks], k1.numpy()[blocks])
    np.testing.assert_array_equal(tv.numpy()[blocks], v1.numpy()[blocks])
