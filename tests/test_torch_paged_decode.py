"""The port's paged-decode plain version and gather path
(`repro_torch.kernels.ref`, `kernels.ops.paged_decode` on the CPU) against
the JAX package's blockwise oracle, its interpret-mode Pallas kernel and
its dense gather path.  Tolerance atol = rtol = 1e-5 in f32: the port sums
in another order than XLA (batched matmuls over rows)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_decode import paged_decode as j_paged_decode
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, S, H, KV, hd, NB, BS, MB):
    """Ragged lens (one empty slot, one full table), permuted pool ids,
    -1 past each slot's blocks."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(S, H, hd)).astype(np.float32)
    kp = rng.normal(size=(NB, BS, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, KV, hd)).astype(np.float32)
    lens = rng.integers(0, MB * BS + 1, size=S).astype(np.int32)
    lens[0] = 0
    lens[-1] = MB * BS
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
    return q, kp, vp, tbl, lens


SHAPES = {
    # name: (S, H, KV, hd, NB, BS, MB)
    "mha-1head": (5, 1, 1, 16, 32, 4, 5),
    "gqa-4q-2kv": (6, 4, 2, 16, 64, 4, 6),
    "mha-4head": (4, 4, 4, 8, 16, 8, 3),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_paged_decode_plain_matches_jax_oracle_and_kernel(name):
    q, kp, vp, tbl, lens = _case(3, *SHAPES[name])
    want = np.asarray(jref.paged_decode_ref(*map(jnp.asarray,
                                                 (q, kp, vp, tbl, lens))))
    pallas = np.asarray(j_paged_decode(*map(jnp.asarray,
                                            (q, kp, vp, tbl, lens)),
                                       interpret=True))
    t = [torch.as_tensor(x) for x in (q, kp, vp, tbl, lens)]
    got = tref.paged_decode_ref(*t).numpy()
    via_ops = ops.paged_decode(*t).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_array_equal(via_ops, got)
    assert not got[lens == 0].any()  # empty slots emit exactly zero


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_gather_path_matches_jax(name):
    """`paged_gather_kv` is a copy (bit-equal); `decode_attention_ref`
    over it matches JAX's and the blockwise plain version."""
    q, kp, vp, tbl, lens = _case(4, *SHAPES[name])
    jk, jpos = jref.paged_gather_kv(jnp.asarray(kp), jnp.asarray(tbl),
                                    jnp.asarray(lens))
    jv, _ = jref.paged_gather_kv(jnp.asarray(vp), jnp.asarray(tbl),
                                 jnp.asarray(lens))
    tk, tpos = tref.paged_gather_kv(torch.as_tensor(kp), torch.as_tensor(tbl),
                                    torch.as_tensor(lens))
    tv, _ = tref.paged_gather_kv(torch.as_tensor(vp), torch.as_tensor(tbl),
                                 torch.as_tensor(lens))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    qpos = np.maximum(lens - 1, 0)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jk, jv, jpos, jnp.asarray(qpos)))
    got = tref.decode_attention_ref(torch.as_tensor(q), tk, tv, tpos,
                                    torch.as_tensor(qpos)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    blockwise = tref.paged_decode_ref(
        *[torch.as_tensor(x) for x in (q, kp, vp, tbl, lens)]).numpy()
    np.testing.assert_allclose(blockwise, got, **TOL)
