"""The arithmetic of the two attention kernels' designs, on the CPU, against
the JAX package's Pallas kernels run in interpret mode (as
`tests/test_kernels.py` runs them), within the port's f32 tolerance of
2e-5.  A CUDA kernel cannot run here, so these hold its plain twins in
`repro_torch.kernels.ref`:

* `tf32_split` rounds as ``cvt.rna.tf32.f32`` does (nearest, ties away
  from zero), and ``hi + lo`` keeps what a TF32 product alone drops;
* `blockwise_attention` with ``einsum=einsum_3xtf32`` — every product of
  ``csrc/flash_attention.cu`` taken as 3xTF32 on 32-key tiles — against
  JAX's ``flash_attention_fwd`` at G = 7 (hd = 64) and hd = 40, with and
  without a window; one TF32 product per term misses the tolerance;
* `decode_attention_split_ref` — ``csrc/decode_attention.cu``'s per-split
  ``(m, l, acc)`` and log-sum-exp merge — against JAX's
  ``decode_attention`` with wholly masked splits (empty rows, a window, a
  rolling ring, an early query), a row with no key (output 0) and C not
  a multiple of the split; and the split plan the wrapper hands the
  kernel at the main paths' shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention_fwd as j_flash
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import split_plan

TOL = 2e-5
H100_SMS = 132


def test_tf32_split_rounds_like_cvt_rna():
    """Nearest with ties away from zero on the 10-bit mantissa; the low
    13 bits of both halves clear; hi + lo within 2⁻²² of x."""
    one = 1.0
    ulp = 2.0 ** -10                       # a TF32 ulp at 1.0
    cases = {one + ulp / 2: one + ulp,     # a tie rounds away
             -(one + ulp / 2): -(one + ulp),
             one + ulp / 2 - 2.0 ** -23: one,
             one + 1.5 * ulp: one + 2 * ulp,   # away, not to even
             3.0: 3.0, 0.0: 0.0}
    x = torch.tensor(list(cases), dtype=torch.float32)
    hi, lo = ref.tf32_split(x)
    assert hi.tolist() == list(cases.values())
    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.standard_normal(4096).astype(np.float32) * 37)
    hi, lo = ref.tf32_split(y)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    assert float(((hi - y).abs() / y.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -22


def _einsum_1xtf32(eq, a, b):
    """One TF32 product per term (what a plain TF32 MMA gives)."""
    return torch.einsum(eq, ref.tf32_split(a)[0], ref.tf32_split(b)[0])


def _flash_inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (1, 64, 14, 2, 64, 0),     # qwen2-0.5b's group of 7
    (1, 64, 14, 2, 64, 24),
    (2, 64, 4, 2, 40, 0),      # hd not a multiple of 8·4
    (1, 96, 4, 1, 40, 33)])
def test_3xtf32_flash_matches_jax_flash(B, S, H, KV, hd, window):
    """The flash kernel's arithmetic (32-key tiles, every product 3xTF32)
    against JAX's Pallas flash kernel in interpret mode, within 2e-5."""
    q, k, v = _flash_inputs(S + hd + window, B, S, H, KV, hd)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window, block_q=32,
                              block_k=32, interpret=True))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    got = ref.blockwise_attention(tq, tk, tv, pos, pos, window=window,
                                  kv_block=32, einsum=ref.einsum_3xtf32)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_one_tf32_product_misses_the_tolerance():
    """Why 3xTF32: at qwen2-0.5b's group (G = 7, hd = 64) one TF32
    product per term is off by far more than 2e-5; three are within."""
    B, S, H, KV, hd = 1, 64, 14, 2, 64
    q, k, v = (torch.as_tensor(x) for x in _flash_inputs(5, B, S, H, KV, hd))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    want = ref.mha_ref(q.double(), k.double(), v.double()).float()
    errs = {name: float((ref.blockwise_attention(
        q, k, v, pos, pos, kv_block=32, einsum=fn) - want).abs().max())
        for name, fn in (("1x", _einsum_1xtf32), ("3x", ref.einsum_3xtf32))}
    assert errs["3x"] < TOL / 4
    assert errs["1x"] > 10 * TOL


def _decode_case(case, rng):
    """(q, k, v, kv_pos, q_pos, window, nsplit) of one masking case."""
    B, C, H, KV, hd, window, nsplit = 4, 100, 14, 2, 64, 0, 4
    kv_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    q_pos = np.full(B, C - 1, np.int32)
    if case == "empty-rows":       # half a row empty, a row with no key
        kv_pos[0, 40:] = -1
        kv_pos[1] = -1
    elif case == "window":         # all but the last split masked
        window = 7
    elif case == "rolling":        # ring positions out of order
        kv_pos = np.tile(((np.arange(C) + 37) % C).astype(np.int32), (B, 1))
        q_pos = np.array([99, 50, 3, 70], np.int32)
        window = 30
    elif case == "early-query":    # the query sees only the first split
        q_pos = np.array([0, 5, 24, 30], np.int32)
    elif case == "ragged":         # C not a multiple of the split
        C, nsplit, hd = 259, 9, 40
        kv_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
        kv_pos[2, 200:] = -1
        q_pos = np.array([258, 100, 258, 31], np.int32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    return q, k, v, kv_pos, q_pos, window, nsplit


@pytest.mark.parametrize("case", ["empty-rows", "window", "rolling",
                                  "early-query", "ragged"])
def test_split_decode_matches_jax_decode(case):
    """Per-split partials and the log-sum-exp merge against JAX's Pallas
    decode kernel in interpret mode, within 2e-5; wholly masked splits
    carry (−inf, 0, 0) and a row with no key outputs 0."""
    q, k, v, kv_pos, q_pos, window, nsplit = _decode_case(
        case, np.random.default_rng(len(case)))
    want = np.asarray(j_decode(*(jnp.asarray(x) for x in (
        q, k, v, kv_pos, q_pos)), window=window, block_k=32, interpret=True))
    got, (m, l, acc) = ref.decode_attention_split_ref(
        *(torch.as_tensor(x) for x in (q, k, v, kv_pos, q_pos)),
        window=window, nsplit=nsplit)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    empty = torch.isinf(m)
    assert not l[empty].any() and not acc[empty].any()
    assert bool((m[empty] < 0).all())
    if case in ("window", "early-query", "rolling"):
        assert empty.any()            # some split saw no key
    if case == "empty-rows":
        assert not got[1].any()
        assert bool(empty[1].all())


@pytest.mark.parametrize("B,C,KV,want", [
    (8, 256, 2, (8, 32)),        # serve_model: 128 CTAs
    (64, 256, 1, (2, 128)),      # the dense ring: 128 CTAs
    (4, 259, 2, (9, 32)),        # prefill_model's check: a ragged split
    (8, 2048, 2, (8, 256)),      # a long cache
    (256, 256, 1, (1, 256)),     # a full wave of rows: no split
    (1, 10, 1, (1, 32))])        # a short cache: one split
def test_split_plan(B, C, KV, want):
    """The wrapper's plan: about one wave of 132 SMs, at least 32 rows a
    split, no empty split; the split reference agrees with the unsplit
    one at that plan."""
    nsplit, R = split_plan(B, C, KV, H100_SMS)
    assert (nsplit, R) == want
    assert (nsplit - 1) * R < C <= nsplit * R or C <= R
    rng = np.random.default_rng(C)
    G, hd = 2, 8
    q = torch.as_tensor(rng.standard_normal((1, KV * G, hd)),
                        dtype=torch.float32)
    kv = torch.as_tensor(rng.standard_normal((1, C, KV, hd)),
                         dtype=torch.float32)
    kv_pos = torch.arange(C, dtype=torch.int32)[None]
    q_pos = torch.tensor([C - 1], dtype=torch.int32)
    got, _ = ref.decode_attention_split_ref(q, kv, kv, kv_pos, q_pos,
                                            nsplit=nsplit, rows=R)
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, kv, kv, kv_pos, q_pos), atol=TOL,
        rtol=TOL)
