"""The port's model stack (`repro_torch.models`) against the JAX package's
(`repro.models`) on the same parameters, carried across by
`convert.params_from_jax`:

* ``prefill`` and three ``decode_step``s: logits within 1e-4 (f32, TF32
  off; the two frameworks sum in other orders), caches equal (positions
  and cursors exactly, K/V and recurrent states within 1e-5), on the
  qwen2-0.5b smoke config, on a gemma3 smoke config with 4- and 8-token
  windows (rolling ring caches, sandwich norms, GeGLU, embedding scale),
  and on the smoke configs of the other block kinds: granite-moe (MoE,
  E_pad > E), deepseek-moe (a dense prefix block, shared experts),
  recurrentgemma (RG-LRU units, a windowed attention block, an RG-LRU
  suffix) and xlstm (mLSTM + sLSTM);
* the port's own prefill/decode consistency (`tests/test_arch_smoke.py`'s
  check: decoding token t equals a fresh prefill over the longer prefix,
  atol = rtol = 2e-3; MoE capacity depends on the batch by design, so the
  MoE configs run at ``capacity_factor=16`` there, as in that test);
* the audio and vision frontends' ``prefill`` and the ``"train"`` mode's
  hidden state against JAX (``test_unported_parts_raise``, the name kept
  from when these parts raised);
* the plain attention paths — `blockwise_attention` and the flash wrapper
  against JAX's `mha_ref`, `single_query_attention` and the decode
  wrapper against JAX's `decode_attention_ref`, with windows, GQA and
  rolling positions — within 1e-5.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

torch.backends.cuda.matmul.allow_tf32 = False


SMOKE = ["qwen2-0.5b", "granite-moe-3b-a800m", "deepseek-moe-16b",
         "recurrentgemma-9b", "xlstm-350m"]
CONFIGS = SMOKE[:1] + ["gemma3-windowed"] + SMOKE[1:]
_j_init = jax.jit(jt.init_params, static_argnums=1)
_j_prefill = jax.jit(jt.prefill, static_argnums=1)
_j_decode = jax.jit(jt.decode_step, static_argnums=1)


def _configs(name):
    """(JAX config, port config) of the same model."""
    if name in SMOKE:
        return j_smoke(name), t_smoke(name)
    cfgs = []
    for base, get in ((jbase, j_smoke), (tbase, t_smoke)):
        cfgs.append(dataclasses.replace(
            get("gemma3-1b"), num_units=2,
            unit=(base.Block("attn", window=4, rope_theta=10_000.0),
                  base.Block("attn", window=0, rope_theta=1_000_000.0)),
            suffix=(base.Block("attn", window=8, rope_theta=10_000.0),)))
    return tuple(cfgs)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _caches_equal(tc, jc):
    jl = jax.tree_util.tree_leaves_with_path(jc)
    flat = {jax.tree_util.keystr(p): v for p, v in jl}
    n = 0

    def walk(t, key):
        nonlocal n
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{key}['{k}']")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{key}[{i}]")
        else:
            n += 1
            want = np.asarray(flat[key])
            if want.dtype == np.float32:
                np.testing.assert_allclose(_np(t), want, atol=1e-5, rtol=1e-5,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(_np(t), want, err_msg=key)

    walk(tc, "")
    assert n == len(flat)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_jax(name):
    jc, tc = _configs(name)
    B, S, C, extra = 2, 16, 24, 3
    params = _j_init(jax.random.PRNGKey(0), jc)
    tp = convert.params_from_jax(params, device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S + extra))
    jcache = jt.init_caches(jc, B, C, jnp.float32)
    tcache = tt.init_caches(tc, B, C, torch.float32, device="cpu")
    jl, jcache = _j_prefill(params, jc, {"tokens": jnp.asarray(toks[:, :S])},
                            jcache)
    tl_, tcache = tt.prefill(tp, tc, {"tokens": torch.as_tensor(
        toks[:, :S])}, tcache)
    np.testing.assert_allclose(_np(tl_), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _caches_equal(tcache, jcache)
    for t in range(extra):
        tok = toks[:, S + t:S + t + 1]
        pos = np.full((B, 1), S + t, np.int32)
        jl, jcache = _j_decode(params, jc, jnp.asarray(tok),
                                  jnp.asarray(pos), jcache)
        tl_, tcache = tt.decode_step(tp, tc, torch.as_tensor(tok),
                                     torch.as_tensor(pos), tcache)
        np.testing.assert_allclose(_np(tl_), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4, err_msg=f"decode step {t}")
        _caches_equal(tcache, jcache)


def test_decode_from_carried_caches():
    """Caches carried from JAX (`convert.caches_from_jax`) decode to JAX's
    logits: the layouts agree leaf for leaf."""
    jc, tc = _configs("qwen2-0.5b")
    B, S, C = 3, 9, 16
    params = jt.init_params(jax.random.PRNGKey(3), jc)
    toks = np.random.default_rng(3).integers(0, jc.vocab, (B, S + 1))
    jcache = jt.init_caches(jc, B, C, jnp.float32)
    _, jcache = jt.prefill(params, jc, {"tokens": jnp.asarray(toks[:, :S])},
                           jcache)
    tcache = convert.caches_from_jax(jcache, device="cpu")
    _caches_equal(tcache, jcache)
    pos = np.full((B, 1), S, np.int32)
    jl, _ = jt.decode_step(params, jc, jnp.asarray(toks[:, S:]),
                           jnp.asarray(pos), jcache)
    tl_, _ = tt.decode_step(convert.params_from_jax(params, device="cpu"), tc,
                            torch.as_tensor(toks[:, S:]),
                            torch.as_tensor(pos), tcache)
    np.testing.assert_allclose(_np(tl_), np.asarray(jl), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "recurrentgemma-9b",
                                  "xlstm-350m"])
def test_decode_from_carried_recurrent_caches(name):
    """Caches of every block kind carried from JAX after a prefill (ring
    caches, RG-LRU, mLSTM and sLSTM states stacked on the unit axis)
    decode to JAX's logits and caches."""
    jc, tc = _configs(name)
    B, S, C = 2, 9, 16
    params = _j_init(jax.random.PRNGKey(4), jc)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (B, S + 1))
    jcache = jt.init_caches(jc, B, C, jnp.float32)
    _, jcache = _j_prefill(params, jc, {"tokens": jnp.asarray(toks[:, :S])},
                           jcache)
    tcache = convert.caches_from_jax(jcache, device="cpu")
    _caches_equal(tcache, jcache)
    pos = np.full((B, 1), S, np.int32)
    jl, jcache = _j_decode(params, jc, jnp.asarray(toks[:, S:]),
                               jnp.asarray(pos), jcache)
    tl_, tcache = tt.decode_step(convert.params_from_jax(params,
                                                         device="cpu"),
                                 tc, torch.as_tensor(toks[:, S:]),
                                 torch.as_tensor(pos), tcache)
    np.testing.assert_allclose(_np(tl_), np.asarray(jl), atol=1e-4, rtol=1e-4)
    _caches_equal(tcache, jcache)


@pytest.mark.parametrize("name,cf", [("granite-moe-3b-a800m", 1.25),
                                     ("deepseek-moe-16b", 0.5)])
def test_forward_hidden_aux_matches_jax(name, cf):
    """``forward_hidden`` returns the MoE blocks' summed aux beside
    ``(h, caches)``, as the reference's does: within 1e-6, overflow
    included (``capacity_factor`` 0.5 drops assignments)."""
    jc, tc = (dataclasses.replace(c, capacity_factor=cf)
              for c in _configs(name))
    B, S = 2, 12
    params = _j_init(jax.random.PRNGKey(5), jc)
    x = np.random.default_rng(5).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jh, _, jaux = jax.jit(lambda *a: jt.forward_hidden(
        *a, "prefill", remat="none"), static_argnums=1)(
            params, jc, jnp.asarray(x), jnp.asarray(pos),
            jt.init_caches(jc, B, S, jnp.float32))
    th, _, taux = tt.forward_hidden(
        convert.params_from_jax(params, device="cpu"), tc, torch.as_tensor(x),
        torch.as_tensor(pos), tt.init_caches(tc, B, S, torch.float32,
                                             device="cpu"), "prefill")
    np.testing.assert_allclose(_np(th), np.asarray(jh), atol=1e-5, rtol=1e-5)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    if cf < 1:
        assert float(taux["overflow_frac"]) > 0


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_decode_consistency(name):
    """Prefill + decode(t) == prefill over the longer prefix, token by
    token for 3 steps, on the port alone with its own random weights."""
    _, cfg = _configs(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    B, S, extra = 2, 16, 3
    params = tt.init_params(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S + extra)))
    caches = tt.init_caches(cfg, B, S + extra, torch.float32, device="cpu")
    _, caches = tt.prefill(params, cfg, {"tokens": toks[:, :S]}, caches)
    for t in range(extra):
        pos = torch.full((B, 1), S + t, dtype=torch.int32)
        got, caches = tt.decode_step(params, cfg, toks[:, S + t:S + t + 1],
                                     pos, caches)
        fresh = tt.init_caches(cfg, B, S + extra, torch.float32, device="cpu")
        want, _ = tt.prefill(params, cfg, {"tokens": toks[:, :S + t + 1]},
                             fresh)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3,
                                   rtol=2e-3, err_msg=f"step {t}")


def test_window_prefill_longer_than_the_ring():
    """A prefill of S tokens into a ring of C < S rows with C not dividing
    S (gemma3-windowed, windows 4 and 8, S = 18): the port puts token t
    in slot t mod C, the slot its append writes at cursor t, so decoding
    equals a fresh prefill over the longer prefix.  The reference writes
    the last C tokens in slots 0..C−1, so its first append overwrites a
    key still inside the window and its decode drifts from its own
    prefill (ROADMAP queue 3).  Both hold the same keys: the port's ring
    is JAX's rolled by S mod C."""
    jc, tc = _configs("gemma3-windowed")
    B, S, extra = 2, 18, 3
    params = _j_init(jax.random.PRNGKey(6), jc)
    tp = convert.params_from_jax(params, device="cpu")
    toks = np.random.default_rng(6).integers(0, jc.vocab, (B, S + extra))
    jcache = jt.init_caches(jc, B, S + extra, jnp.float32)
    tcache = tt.init_caches(tc, B, S + extra, torch.float32, device="cpu")
    _, jcache = _j_prefill(params, jc, {"tokens": jnp.asarray(toks[:, :S])},
                           jcache)
    _, tcache = tt.prefill(tp, tc, {"tokens": torch.as_tensor(toks[:, :S])},
                           tcache)
    rings = 0
    for u in range(jc.num_units):
        for b in ("b0", "b1"):
            jr, tr_ = jcache["units"][b], tcache["units"][b]
            C = jr["k"].shape[2]
            shift = S % C if S > C else 0
            rings += shift > 0
            for name in ("k", "v", "pos"):
                np.testing.assert_allclose(
                    _np(tr_[name][u]),
                    np.roll(np.asarray(jr[name][u]), shift, axis=1),
                    atol=1e-5, rtol=1e-5, err_msg=f"{u} {b} {name}")
    assert rings == jc.num_units        # the window-4 block of each unit
    j_drift = []
    for t in range(extra):
        tok = toks[:, S + t:S + t + 1]
        pos = np.full((B, 1), S + t, np.int32)
        jl, jcache = _j_decode(params, jc, jnp.asarray(tok), jnp.asarray(pos),
                               jcache)
        tl_, tcache = tt.decode_step(tp, tc, torch.as_tensor(tok),
                                     torch.as_tensor(pos), tcache)
        jw, _ = _j_prefill(params, jc,
                           {"tokens": jnp.asarray(toks[:, :S + t + 1])},
                           jt.init_caches(jc, B, S + extra, jnp.float32))
        np.testing.assert_allclose(_np(tl_), np.asarray(jw), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {t}")
        j_drift.append(float(np.abs(np.asarray(jl) - np.asarray(jw)).max()))
    assert j_drift[0] > 1e-2, j_drift


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))


@pytest.mark.parametrize("causal,window,H,KV,Sq,Sk", [
    (True, 0, 4, 2, 13, 13), (True, 5, 4, 1, 21, 21), (False, 0, 2, 2, 7, 11),
    (False, 3, 6, 3, 9, 9), (True, 0, 7, 1, 40, 40), (True, 0, 2, 2, 7, 11)])
def test_plain_flash_paths_match_mha_ref(causal, window, H, KV, Sq, Sk):
    """`blockwise_attention` (several KV blocks, ragged last block), the
    flash wrapper's CPU path (causal only, as its kernel) and the port's
    `mha_ref` against JAX's `mha_ref`."""
    q, k, v = _qkv(H * 31 + Sq, 2, Sq, Sk, H, KV, 16)
    want = np.asarray(jref.mha_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    qp = torch.arange(Sq, dtype=torch.int32).expand(2, Sq)
    kp = torch.arange(Sk, dtype=torch.int32).expand(2, Sk)
    outs = [tl.blockwise_attention(tq, tk, tv, qp, kp, window=window,
                                   kv_block=4, causal=causal),
            tref.mha_ref(tq, tk, tv, causal=causal, window=window)]
    if causal:
        outs.append(ops.flash_attention(tq, tk, tv, window=window))
    for got in outs:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["dense", "window", "rolling", "gqa-ragged"])
def test_plain_decode_paths_match_decode_ref(case):
    """`single_query_attention`, the decode wrapper's CPU path and the
    port's `decode_attention_ref` against JAX's `decode_attention_ref`:
    empty rows (-1), windows, out-of-order ring positions (masking by
    value, `tests/test_kernels.py`'s rolling case) and a row that sees no
    key (output 0)."""
    rng = np.random.default_rng(len(case))
    B, C, H, KV, hd = 3, 8, 4, 2, 16
    window = 0
    kv_pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    q_pos = np.full(B, C - 1, np.int32)
    if case == "window":
        window = 3
    elif case == "rolling":
        kv_pos = np.tile(((np.arange(C) + 5) % 11).astype(np.int32), (B, 1))
        q_pos = np.array([7, 10, 3], np.int32)
    elif case == "gqa-ragged":
        H, KV = 6, 1
        kv_pos[0, 5:] = -1
        kv_pos[1] = -1            # no key at all
        q_pos = np.array([4, 2, 6], np.int32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    want = np.asarray(jref.decode_attention_ref(
        *(jnp.asarray(x) for x in (q, k, v, kv_pos, q_pos)), window=window))
    tq, tk, tv, tkp, tqp = (torch.as_tensor(x)
                            for x in (q, k, v, kv_pos, q_pos))
    got_sq = tl.single_query_attention(tq[:, None], tk, tv, tqp[:, None], tkp,
                                       window=window)[:, 0]
    for got in (got_sq,
                ops.decode_attention(tq, tk, tv, tkp, tqp, window=window),
                tref.decode_attention_ref(tq, tk, tv, tkp, tqp,
                                          window=window)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if case == "gqa-ragged":
        assert not got_sq[1].any()


@pytest.mark.parametrize("what", ["audio", "frontend", "train"])
def test_unported_parts_raise(what):
    """The three parts that once raised as unported now match JAX on the
    same parameters: ``prefill`` of the audio frontend (musicgen-medium,
    frame embeddings) and of the vision frontend (internvl2-1b, patch
    embeddings before the tokens) — logits within 1e-4, caches as in
    `test_prefill_and_decode_match_jax` — and the hidden state and aux of
    ``forward_hidden`` in the ``"train"`` mode (qwen2-0.5b, no caches)
    within 1e-5."""
    arch = {"audio": "musicgen-medium", "frontend": "internvl2-1b",
            "train": "qwen2-0.5b"}[what]
    jc, tc = j_smoke(arch), t_smoke(arch)
    params = _j_init(jax.random.PRNGKey(0), jc)
    tp = convert.params_from_jax(params, device="cpu")
    rng = np.random.default_rng(2)
    B, S = 2, 16
    if what == "train":
        x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        jh, _, jaux = jax.jit(lambda p, x_, q: jt.forward_hidden(
            p, jc, x_, q, None, "train"))(params, jnp.asarray(x),
                                          jnp.asarray(pos))
        th, caches, taux = tt.forward_hidden(tp, tc, torch.as_tensor(x),
                                             torch.as_tensor(pos), None,
                                             "train")
        assert caches is None
        np.testing.assert_allclose(_np(th), np.asarray(jh), atol=1e-5,
                                   rtol=1e-5)
        assert {k: float(v) for k, v in taux.items()} == \
            {k: float(v) for k, v in jaux.items()}
        return
    if what == "audio":
        batch = {"frame_embeds": rng.standard_normal(
            (B, S, jc.d_model)).astype(np.float32)}
        C = S + 8
    else:
        batch = {"tokens": rng.integers(0, jc.vocab, (B, S)),
                 "patch_embeds": rng.standard_normal(
                     (B, jc.n_patches, jc.d_model)).astype(np.float32)}
        C = S + jc.n_patches + 8
    jl, jcache = _j_prefill(params, jc, {k: jnp.asarray(v)
                                         for k, v in batch.items()},
                            jt.init_caches(jc, B, C, jnp.float32))
    tl_, tcache = tt.prefill(tp, tc, {k: torch.as_tensor(v)
                                      for k, v in batch.items()},
                             tt.init_caches(tc, B, C, torch.float32,
                                            device="cpu"))
    np.testing.assert_allclose(_np(tl_), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _caches_equal(tcache, jcache)


def test_init_params_and_caches_default_to_the_card():
    """`init_params` and `init_caches` resolve ``device=None`` as the
    port's other factories do: the card, raising where CUDA is absent;
    ``device="cpu"`` builds here."""
    cfg = t_smoke("qwen2-0.5b")
    if torch.cuda.is_available():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tt.init_params(gen, cfg)
        caches = tt.init_caches(cfg, 1, 4, torch.float32)
        assert params["embed"].device.type == "cuda"
        assert caches["units"]["b0"]["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="init_params.*device='cpu'"):
        tt.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="init_caches.*device='cpu'"):
        tt.init_caches(cfg, 1, 4, torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    caches = tt.init_caches(cfg, 1, 4, torch.float32, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert caches["units"]["b0"]["k"].device.type == "cpu"
