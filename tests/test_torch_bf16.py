"""The port at the reference's production dtype, bf16, on the CPU: the
converters carry bf16 trees bit for bit, the plain attention versions
round P as the reference rounds it, the activations, the MoE and the
recurrent blocks round where JAX's do, and the serve steps at the
default `StepConfig` (bf16 parameters, bf16 caches) agree with JAX's for
every block kind.

"One bf16 ulp" below is the spacing of bf16 at the largest magnitude of
an output row (the head dimension of one (row, position, head)): the
error an output picks up where the two sides round one P element apart,
or round the output from f32 sums taken in another order.  The plain
versions hold to the reference within it and are bit-equal on at least
99.5% of the outputs, except where the arithmetic itself differs: the
decode kernel's split-K cut rounds each run's P against that run's own
maximum, which no one-pass reference does, so `decode_attention_split_ref`
is bit-equal to JAX at one split and within one ulp at more.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_smoke_config as j_smoke
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention_fwd as j_flash
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.parallel import steps as jsteps
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ShapeSpec
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import transformer as tt
from repro_torch.parallel import steps as tsteps
from repro_torch.parallel.shard_attention import lse_merge

BF16_EQUAL = 0.995        # share of outputs bit-equal to the reference
LOGIT_TOL = 5e-2          # serve steps: logits, × max |logit|
KV_TOL = 5e-2             # serve steps: K/V, × each leaf's max |value|
# serve steps: an f32 state leaf (the xLSTM cells, the RG-LRU's h) within
# STATE_YARD × the gap bf16 opens in JAX's own states at that step (the
# largest of JAX bf16 against JAX f32 over the config's f32 leaves, × each
# leaf's max): the port and JAX each round to bf16 at their own points,
# so by the triangle inequality two runs each that far from f32 stay
# within twice it of each other
STATE_YARD = 2.0


def _jb(x):
    return jnp.asarray(x, jnp.bfloat16)


def _tb(x):
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _row_ulp(want: np.ndarray) -> np.ndarray:
    """bf16's spacing at each row's largest magnitude (rows along the
    last axis), broadcast over the row."""
    top = np.abs(want).max(-1, keepdims=True)
    return np.exp2(np.floor(np.log2(np.maximum(top, 1e-30))) - 7)


def _hold(got, want, *, equal_share=BF16_EQUAL):
    """``got`` (port, bf16) within one bf16 ulp of ``want`` (JAX, bf16)
    row by row, and bit-equal on at least ``equal_share`` of the
    outputs.  Returns the bit-equal share."""
    assert got.dtype == torch.bfloat16
    a, b = _f32(got), _f32(want)
    assert a.shape == b.shape
    err = np.abs(a - b) / _row_ulp(b)
    assert err.max() <= 1.0, f"{err.max()} ulps"
    share = float(np.mean(a == b))
    assert share >= equal_share, share
    return share


# ------------------------------------------------------------ converters ---


def _uint16(tree) -> list:
    return [np.asarray(x).view(np.uint16)
            for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("what", ["params", "caches"])
def test_bf16_trees_cross_bit_for_bit(what):
    """A bf16 parameter tree (qwen2-0.5b smoke, drawn in `StepConfig`'s
    param dtype) and a bf16 cache tree (its rings filled with random
    bf16 values, subnormals, ±0 and ±inf among them) through
    `convert.params_from_jax` / `caches_from_jax` and back through
    `convert.tree_to_numpy`: every leaf keeps its dtype, bf16 leaves are
    ``torch.bfloat16`` on the port's side and bit-equal as uint16 views."""
    cfg = j_smoke("qwen2-0.5b")
    if what == "params":
        tree = jt.init_params(jax.random.PRNGKey(0), cfg,
                              jsteps.StepConfig().param_dtype)
        port = convert.params_from_jax(tree, device="cpu")
    else:
        tree = jt.init_caches(cfg, 2, 16, jnp.bfloat16)
        rng = np.random.default_rng(0)
        special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -3e-39],
                           np.float32)

        def fill(x):
            if x.dtype != jnp.bfloat16:
                return x
            v = rng.standard_normal(x.shape).astype(np.float32).ravel()
            v[:special.size] = special
            return jnp.asarray(v.reshape(x.shape), jnp.bfloat16)

        tree = jax.tree.map(fill, tree)
        port = convert.caches_from_jax(tree, device="cpu")
    j_leaves = jax.tree_util.tree_leaves(tree)
    t_leaves = jax.tree_util.tree_leaves(port)
    assert len(j_leaves) == len(t_leaves)
    n_bf16 = 0
    for j, t in zip(j_leaves, t_leaves):
        if j.dtype == jnp.bfloat16:
            n_bf16 += 1
            assert t.dtype == torch.bfloat16
    assert n_bf16 > 0
    back = convert.tree_to_numpy(port)
    for j, b in zip(_uint16(tree), _uint16(back)):
        np.testing.assert_array_equal(b, j)
    for j, b in zip(j_leaves, jax.tree_util.tree_leaves(back)):
        assert np.asarray(b).dtype == (ml_dtypes.bfloat16
                                       if j.dtype == jnp.bfloat16
                                       else np.asarray(j).dtype)


# ------------------------------------------------------- plain attention ---


def _prefill_inputs(B=2, S=300, H=14, KV=2, hd=64, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    return q, k, v, np.tile(np.arange(S, dtype=np.int32), (B, 1))


def _decode_inputs(B=8, C=448, H=14, KV=2, hd=64, seed=1):
    """A rolling ring (positions rotated by 37), one row half empty, the
    queries at random positions, the last at C − 1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, C, KV, hd)).astype(np.float32)
            for _ in range(2))
    kp = np.tile(((np.arange(C) + 37) % C).astype(np.int32), (B, 1))
    kp[0, C // 2:] = -1
    qp = rng.integers(0, C, B).astype(np.int32)
    qp[-1] = C - 1
    return q, k, v, kp, qp


@pytest.mark.parametrize("window,kv_block", [(0, 1024), (37, 128)])
def test_blockwise_attention_bf16_matches_jax(window, kv_block):
    """`ref.blockwise_attention` on bf16 q/k/v (B=2, S=300, H=14, KV=2,
    hd=64) against `repro.models.layers.blockwise_attention`, one KV
    block and three (the last ragged), with and without a window."""
    q, k, v, pos = _prefill_inputs()
    want = jl.blockwise_attention(_jb(q), _jb(k), _jb(v), jnp.asarray(pos),
                                  jnp.asarray(pos), window=window,
                                  kv_block=kv_block)
    got = tref.blockwise_attention(_tb(q), _tb(k), _tb(v),
                                   torch.as_tensor(pos),
                                   torch.as_tensor(pos), window=window,
                                   kv_block=kv_block)
    _hold(got, want)


@pytest.mark.parametrize("window", [0, 37])
@pytest.mark.parametrize("heads", [(14, 2, 64), (4, 1, 256)])
def test_flash_plain_bf16_matches_pallas(window, heads):
    """`flash_attention.flash_attention_plain` (the flash kernel's plain
    version) on bf16 inputs against JAX's Pallas `flash_attention_fwd`
    in interpret mode: qwen2-0.5b's heads (G=7) and gemma3's (hd=256,
    G=4), S=256, causal, with and without a window."""
    H, KV, hd = heads
    q, k, v, _ = _prefill_inputs(B=1, S=256, H=H, KV=KV, hd=hd, seed=hd)
    want = j_flash(_jb(q), _jb(k), _jb(v), window=window, interpret=True)
    got = flash_attention_plain(_tb(q), _tb(k), _tb(v), window=window)
    _hold(got, want)


@pytest.mark.parametrize("window", [0, 100])
def test_single_query_attention_bf16_matches_jax(window):
    """`ref.single_query_attention` over a bf16 rolling ring (B=8,
    C=448) against `repro.models.layers.single_query_attention`."""
    q, k, v, kp, qp = _decode_inputs()
    want = jl.single_query_attention(_jb(q[:, None]), _jb(k), _jb(v),
                                     jnp.asarray(qp[:, None]),
                                     jnp.asarray(kp), window=window)
    got = tref.single_query_attention(_tb(q[:, None]), _tb(k), _tb(v),
                                      torch.as_tensor(qp[:, None]),
                                      torch.as_tensor(kp), window=window)
    _hold(got, want)


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("heads", [(14, 2, 64), (16, 1, 256)])
def test_decode_plain_bf16_matches_pallas(window, heads):
    """`decode_attention.decode_attention_plain` (the decode kernel's
    plain version) over a bf16 rolling ring against JAX's Pallas
    `decode_attention` in interpret mode: qwen2-0.5b's heads and
    recurrentgemma's (G=16, hd=256)."""
    H, KV, hd = heads
    q, k, v, kp, qp = _decode_inputs(H=H, KV=KV, hd=hd)
    want = j_decode(_jb(q), _jb(k), _jb(v), jnp.asarray(kp),
                    jnp.asarray(qp), window=window, interpret=True)
    got = decode_attention_plain(_tb(q), _tb(k), _tb(v),
                                 torch.as_tensor(kp), torch.as_tensor(qp),
                                 window=window)
    _hold(got, want)


@pytest.mark.parametrize("nsplit", [1, 4, 7])
@pytest.mark.parametrize("window", [0, 100])
def test_decode_split_ref_bf16_matches_pallas(nsplit, window):
    """`ref.decode_attention_split_ref` (the decode kernel's split-K
    arithmetic) at bf16 against JAX's Pallas `decode_attention` with one
    KV block a run: bit-equal on ≥ 99.5% at one split; at 4 and 7 splits
    each run rounds its P against its own maximum, so the share is
    lower (~75–90%) but every output stays within one bf16 ulp."""
    q, k, v, kp, qp = _decode_inputs()
    C = k.shape[1]
    R = -(-C // nsplit)
    want = j_decode(_jb(q), _jb(k), _jb(v), jnp.asarray(kp),
                    jnp.asarray(qp), window=window, block_k=R,
                    interpret=True)
    got, (m, l, acc) = tref.decode_attention_split_ref(
        _tb(q), _tb(k), _tb(v), torch.as_tensor(kp), torch.as_tensor(qp),
        window=window, nsplit=nsplit)
    assert m.dtype == l.dtype == acc.dtype == torch.float32
    _hold(got, want, equal_share=BF16_EQUAL if nsplit == 1 else 0.5)


@pytest.mark.parametrize("runs", [2, 4])
def test_lse_partials_merge_bf16(runs):
    """`decode_attention_plain(..., return_lse=True)` on bf16 sequence
    runs of a ring gives f32 partials beside f32 log-sum-exps; merged by
    `lse_merge` and rounded once, they are within one bf16 ulp of the
    whole ring's bf16 output (a run that sees no key weighs 0)."""
    q, k, v, kp, qp = _decode_inputs()
    kp[1, :k.shape[1] // 4] = -1   # at 4 runs, row 1's first sees no key
    args = [_tb(q), _tb(k), _tb(v), torch.as_tensor(kp),
            torch.as_tensor(qp)]
    whole = decode_attention_plain(*args)
    C = k.shape[1]
    n = C // runs
    parts = [decode_attention_plain(
        args[0], args[1][:, r * n:(r + 1) * n].contiguous(),
        args[2][:, r * n:(r + 1) * n].contiguous(),
        args[3][:, r * n:(r + 1) * n].contiguous(), args[4],
        return_lse=True) for r in range(runs)]
    assert all(o.dtype == lse.dtype == torch.float32 for o, lse in parts)
    merged = lse_merge(torch.stack([o for o, _ in parts]),
                       torch.stack([lse for _, lse in parts]))
    _hold(merged.to(torch.bfloat16), jnp.asarray(_f32(whole), jnp.bfloat16),
          equal_share=0.5)


# ------------------------------------------------------------ serve steps ---


def _configs(name):
    """(JAX config, port config): a smoke config, or gemma3's with
    windows of 4 and 8 tokens (rolling rings, sandwich norms, GeGLU,
    embedding scale) as `tests/test_torch_model.py` builds it."""
    if name != "gemma3-windowed":
        return j_smoke(name), t_smoke(name)
    cfgs = []
    for base, get in ((jbase, j_smoke), (tbase, t_smoke)):
        cfgs.append(dataclasses.replace(
            get("gemma3-1b"), num_units=2,
            unit=(base.Block("attn", window=4, rope_theta=10_000.0),
                  base.Block("attn", window=0, rope_theta=1_000_000.0)),
            suffix=(base.Block("attn", window=8, rope_theta=10_000.0),)))
    return tuple(cfgs)


def _leaves_by_path(tree) -> dict:
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _rel_gap(a, b) -> float:
    """max |a − b| over b's largest magnitude, both taken as f32."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _state_yard(jc, jc32) -> float:
    """The gap bf16 opens in JAX's own f32 state leaves: the largest
    `_rel_gap` of JAX's bf16 caches against its f32 run's over the f32
    leaves (0 where there are none)."""
    want, f32 = _leaves_by_path(jc), _leaves_by_path(jc32)
    return max([_rel_gap(w, f32[k]) for k, w in want.items()
                if np.asarray(w).dtype == np.float32], default=0.0)


def _caches_close(tc, jc, state_tol=0.0):
    """Every leaf of JAX's dtype; bf16 leaves (K/V, conv tails) within
    `KV_TOL` of each leaf's largest magnitude, f32 leaves (recurrent
    cells) within ``state_tol`` of it, positions and cursors bit-equal."""
    want = _leaves_by_path(jc)
    got = _leaves_by_path(convert.tree_to_numpy(tc))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        w = np.asarray(w)
        assert g.dtype == w.dtype, key
        if w.dtype == ml_dtypes.bfloat16:
            assert _rel_gap(g, w) <= KV_TOL, key
        elif w.dtype == np.float32:
            assert _rel_gap(g, w) <= state_tol, (key, _rel_gap(g, w),
                                                 state_tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


def _logits_close(got, want):
    g, w = _f32(got), np.asarray(want, np.float32)
    assert got.dtype == torch.float32
    assert np.abs(g - w).max() <= LOGIT_TOL * np.abs(w).max()


_j_init = jax.jit(jt.init_params, static_argnums=(1, 2))

RECURRENT = ("recurrentgemma-9b", "xlstm-350m")


@pytest.mark.parametrize("name", ["qwen2-0.5b", "gemma3-windowed",
                                  "granite-moe-3b-a800m", "deepseek-moe-16b",
                                  *RECURRENT])
def test_serve_steps_at_default_step_config_match_jax(name):
    """`parallel.steps.make_prefill_step` and three `make_decode_step`s at
    `StepConfig()` — bf16 parameters drawn by JAX and carried across,
    bf16 caches — against JAX's steps on the same inputs: logits within
    5e-2 × max |logit|, K/V and the conv tails within 5% of each leaf's
    largest magnitude, the f32 recurrent cells within `STATE_YARD` × the
    gap JAX's own bf16 states open from its f32 run's (JAX's steps run
    a second time on the same parameters cast to f32), every leaf of
    JAX's dtype, ``pos`` and ``ptr`` bit-equal (B=2, a prefill of 16 into
    24-slot rings: gemma3's 4- and 8-token windows roll).  The MoE
    configs route the same experts as JAX (`tests/test_torch_moe.py`
    holds the routing on bf16 inputs) at their own capacity factor."""
    jc, tc = _configs(name)
    sc_j, sc_t = jsteps.StepConfig(), tsteps.StepConfig()
    assert sc_t.param_dtype == torch.bfloat16
    B, S, C, extra = 2, 16, 24, 3
    params = _j_init(jax.random.PRNGKey(0), jc, sc_j.param_dtype)
    tp = convert.params_from_jax(params, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S + extra))
    pshape = ShapeSpec("prefill", S, B, "prefill")
    dshape = ShapeSpec("decode", C, B, "decode")
    j_pre = jax.jit(jsteps.make_prefill_step(jc, pshape, sc_j))
    j_dec = jax.jit(jsteps.make_decode_step(jc, dshape, sc_j))
    t_pre = tsteps.make_prefill_step(tc, pshape, sc_t)
    t_dec = tsteps.make_decode_step(tc, dshape, sc_t)
    recurrent = name in RECURRENT
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jcache = jt.init_caches(jc, B, C, jnp.bfloat16)
    jc32 = jt.init_caches(jc, B, C, jnp.float32)
    tcache = tt.init_caches(tc, B, C, torch.bfloat16, device="cpu")
    batch = {"tokens": jnp.asarray(toks[:, :S])}
    jlog, jcache = j_pre(params, batch, jcache)
    if recurrent:
        _, jc32 = j_pre(p32, batch, jc32)
    with torch.no_grad():
        tlog, tcache = t_pre(tp, {"tokens": torch.as_tensor(toks[:, :S])},
                             tcache)
    _logits_close(tlog, jlog)
    _caches_close(tcache, jcache, STATE_YARD * _state_yard(jcache, jc32))
    for t in range(extra):
        tok = jnp.asarray(toks[:, S + t:S + t + 1])
        pos = jnp.full((B, 1), S + t, jnp.int32)
        jlog, jcache = j_dec(params, tok, pos, jcache)
        if recurrent:
            _, jc32 = j_dec(p32, tok, pos, jc32)
        with torch.no_grad():
            tlog, tcache = t_dec(tp, torch.as_tensor(np.array(tok)),
                                 torch.as_tensor(np.array(pos)), tcache)
        _logits_close(tlog, jlog)
        _caches_close(tcache, jcache,
                      STATE_YARD * _state_yard(jcache, jc32))


# ------------------------------------------------- block kinds at bf16 ----
#
# Where the port's blocks parted from JAX's on bf16 inputs: ``F.silu`` /
# ``F.gelu`` round once where XLA rounds each op of ``jax.nn.silu`` /
# ``gelu`` to bf16, and XLA takes the last bf16 op before a cast to f32
# in f32 (the sLSTM's gate sum, the RG-LRU's conv output and gate).


def _rng_bf16(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return _jb(x.astype(np.float32))


@pytest.mark.parametrize("fn", ["silu", "gelu", "gelu-widened"])
def test_activations_bf16_bit_equal_jax(fn):
    """`models.layers.silu` / `gelu` on 200 000 bf16 values (σ = 3)
    against jitted ``jax.nn.silu`` / ``jax.nn.gelu``: bit-equal; the
    widened gelu against ``jax.nn.gelu(x).astype(float32)``."""
    from repro_torch.models import layers as tl
    x = _rng_bf16((200_000,), 0, 3.0)
    xt = torch.as_tensor(_f32(x)).to(torch.bfloat16)
    if fn == "silu":
        want, got = jax.jit(jax.nn.silu)(x), tl.silu(xt)
    elif fn == "gelu":
        want, got = jax.jit(jax.nn.gelu)(x), tl.gelu(xt)
    else:
        want = jax.jit(lambda v: jax.nn.gelu(v).astype(jnp.float32))(x)
        got = tl.gelu(xt, widen=True)
        assert got.dtype == torch.float32
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_moe_bf16_matches_jax(arch):
    """`moe_forward` on bf16 parameters and inputs (B=2, S=16, its
    capacity factor) against JAX's: the experts picked, the tickets and
    ``admitted`` bit-equal (the router runs in f32 on both sides), the
    output bit-equal on ≥ 99.5% and within one bf16 ulp of each row's
    largest magnitude, the aux sums within 1e-6."""
    from repro.core import functional as jf
    from repro.models import moe as jmoe
    from repro_torch.core import u32
    from repro_torch.models import moe as tmoe
    cfg = j_smoke(arch)
    p = jmoe.init_moe(jax.random.PRNGKey(0), cfg.d_model, cfg.n_experts,
                      cfg.d_expert, cfg.top_k, cfg.n_shared, cfg.d_shared,
                      jnp.bfloat16, n_experts_pad=cfg.n_experts_pad)
    tp = convert.params_from_jax(p, device="cpu")
    x = _rng_bf16((2, 16, cfg.d_model), 1)
    xt = torch.as_tensor(_f32(x)).to(torch.bfloat16)
    N, k, E = 32, cfg.top_k, cfg.n_experts
    cap = tmoe.capacity_of(N, k, E, cfg.capacity_factor)
    logits = jnp.einsum("nd,de->ne", x.reshape(N, -1).astype(jnp.float32),
                        p["router"])
    _, j_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    _, j_tk, j_adm = jf.take_batch_multi(
        jf.make_multi_sema(jnp.full((E,), cap, jnp.uint32)),
        j_idx.reshape(-1), jnp.ones((N * k,), bool))
    _, _, _, t_idx = tmoe.route(tp, xt.reshape(N, -1), k)
    t_tk, t_adm = tmoe.admit(t_idx.reshape(1, -1), E, cap)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(u32.to_numpy(t_tk[0]), np.asarray(j_tk))
    np.testing.assert_array_equal(t_adm[0].numpy(), np.asarray(j_adm))
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_forward(
        p, x, top_k=k, capacity_factor=cfg.capacity_factor))(p, x)
    with torch.no_grad():
        tout, taux = tmoe.moe_forward(tp, xt, top_k=k,
                                      capacity_factor=cfg.capacity_factor)
    _hold(tout, jout)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   atol=1e-6, rtol=1e-6, err_msg=key)


def _block_case(kind):
    """(JAX init, JAX forward, port forward) of one recurrent block at
    D=64 (the smoke configs' width), 4 heads."""
    from repro.models import rglru as jr
    from repro.models import xlstm as jx
    from repro_torch.models import rglru as tr
    from repro_torch.models import xlstm as tx
    D, H = 64, 4
    return {
        "mlstm": (lambda k: jx.init_mlstm(k, D, H, jnp.bfloat16),
                  lambda p, x: jx.mlstm_forward(p, x, H),
                  lambda p, x: tx.mlstm_forward(p, x, H)),
        "slstm": (lambda k: jx.init_slstm(k, D, H, jnp.bfloat16),
                  lambda p, x: jx.slstm_forward(p, x, H),
                  lambda p, x: tx.slstm_forward(p, x, H)),
        "rglru": (lambda k: jr.init_rglru_block(k, D, D, jnp.bfloat16),
                  jr.rglru_block_forward, tr.rglru_block_forward),
    }[kind]


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "rglru"])
def test_recurrent_block_bf16_matches_jax(kind):
    """One mLSTM, sLSTM or RG-LRU block on bf16 parameters and inputs
    (B=2, S=16, D=64) from the zero state against JAX's jitted block.
    The conv tails are bf16 and bit-equal.  The RG-LRU's output is
    bit-equal; the mLSTM's within one bf16 ulp and bit-equal on ≥
    99.5%, its cells within 1e-3 of each leaf's max (an eighth of a
    bf16 ulp); the sLSTM's cells within 1e-5 (its gate products agree
    and only the f32 transcendentals differ, XLA's against torch's), its
    output — after a residual sum XLA normalises unrounded (ROADMAP
    queue 3) — within `STATE_YARD` × the gap JAX's own bf16 output opens
    from JAX's f32 run on the same parameters; the RG-LRU's ``h``
    within 1e-5 (the scans associate their products differently)."""
    init, jfwd, tfwd = _block_case(kind)
    p = init(jax.random.PRNGKey(1))
    x = _rng_bf16((2, 16, 64), 0)
    jout, jst = jax.jit(jfwd)(p, x)
    tp = convert.params_from_jax(p, device="cpu")
    with torch.no_grad():
        tout, tst = tfwd(tp, torch.as_tensor(_f32(x)).to(torch.bfloat16))
    assert set(tst) == set(jst)
    for key, w in jst.items():
        assert convert.tree_to_numpy(tst[key]).dtype == np.asarray(w).dtype
    if "conv" in jst:
        np.testing.assert_array_equal(_f32(tst["conv"]), _f32(jst["conv"]))
    cells = [key for key in jst if key != "conv"]
    if kind == "rglru":
        np.testing.assert_array_equal(_f32(tout), _f32(jout))
    elif kind == "mlstm":
        _hold(tout, jout)
    else:
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
        out32, _ = jax.jit(jfwd)(p32, x.astype(jnp.float32))
        assert (_rel_gap(_f32(tout), _f32(jout))
                <= STATE_YARD * _rel_gap(_f32(jout), out32))
    cell_tol = 1e-3 if kind == "mlstm" else 1e-5
    for key in cells:
        assert _rel_gap(_f32(tst[key]), _f32(jst[key])) <= cell_tol, key
