"""The pieces of the port's meshed serve steps that one process can hold
against JAX: the log-sum-exp merge of sequence shards
(`repro_torch.parallel.shard_attention.lse_merge` over the decode
kernel's plain version with ``return_lse``), the per-shard ring writes
(`repro_torch.models.cache.prefill_shard` / `ring_write_shard`) emulated
shard by shard against the single-device writes and JAX's, and the
stand-ins for every model input (`parallel.steps.input_specs`,
`abstract_train_state`) against JAX's ``ShapeDtypeStruct``s.

M shards are emulated by cutting one cache's rows into M runs, as
`sharding.placements` cuts them over the ``seq_kv`` mesh axes; the
four-rank run of the same code is `tests/test_torch_mesh_serve.py`."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.configs.registry import shapes_for as jax_shapes_for
from repro.models.cache import kv_cache_append as jax_kv_cache_append
from repro.models.cache import kv_cache_write_prefill as jax_write_prefill
from repro.models.layers import single_query_attention as jax_sqa
from repro.parallel import steps as jax_steps
from repro_torch.checkpoint.manager import path_leaves
from repro_torch.configs.registry import ARCH_IDS, get_smoke_config, shapes_for
from repro_torch.kernels import ops, ref
from repro_torch.models.cache import (kv_cache_append, kv_cache_write_prefill,
                                      make_kv_cache, prefill_shard,
                                      ring_write_shard)
from repro_torch.parallel import steps
from repro_torch.parallel.shard_attention import lse_merge

TOL = 1e-5


def _case(name: str, B=3, C=64, H=4, KV=2, hd=16, seed=0):
    """q (B, H, hd), a cache (B, C, KV, hd) and its positions, the query
    positions and the window of a named case."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    pos = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    q_pos = np.full(B, C - 1, np.int32)
    window = 0
    if name == "empty-shards":   # rows 0 and 1: no key past row 10 / none
        pos[0, 10:] = -1
        pos[1] = -1
    elif name == "window":
        window = 7
    elif name == "rolling":      # a wrapped ring: slot s holds C + s − 29
        pos = np.tile(np.where(np.arange(C) < 29, np.arange(C) + C,
                               np.arange(C)).astype(np.int32), (B, 1))
        q_pos = np.full(B, C + 28, np.int32)
        window = 40
    elif name == "early-query":  # keys past the query are masked
        q_pos = rng.integers(0, C // 3, B).astype(np.int32)
    return q, k, v, pos, q_pos, window


CASES = ("full", "empty-shards", "window", "rolling", "early-query")


@pytest.mark.parametrize("M", (1, 2, 4, 8))
@pytest.mark.parametrize("name", CASES)
def test_lse_merge_of_shards_equals_whole_cache(name, M):
    """Each of M sequence shards through the decode kernel's plain version
    with ``return_lse``, merged by `lse_merge`, against the whole cache's
    plain attention and JAX's ``single_query_attention``; a row that no
    shard sees a key for gives 0, as ``decode_attention_split_ref``
    does."""
    q, k, v, pos, q_pos, window = _case(name)
    t = [torch.as_tensor(x) for x in (q, k, v, pos, q_pos)]
    C, n = k.shape[1], k.shape[1] // M
    outs, lses = [], []
    for r in range(M):
        rows = slice(r * n, (r + 1) * n)
        o, lse = ops.decode_attention(t[0], t[1][:, rows], t[2][:, rows],
                                      t[3][:, rows], t[4], window=window,
                                      return_lse=True)
        outs.append(o)
        lses.append(lse)
    got = lse_merge(torch.stack(outs), torch.stack(lses)).numpy()
    whole = ops.decode_attention(*t, window=window).numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=TOL)
    want = np.asarray(jax_sqa(jnp.asarray(q)[:, None], jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(q_pos)[:, None],
                              jnp.asarray(pos), window=window))[:, 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    split, _ = ref.decode_attention_split_ref(*t, window=window, nsplit=M)
    np.testing.assert_allclose(got, split.numpy(), rtol=0, atol=TOL)
    if name == "empty-shards":
        assert not got[1].any() and np.isneginf(
            torch.stack(lses)[:, 1].numpy()).all()
        assert all(not o[1].any() for o in outs)


@pytest.mark.parametrize("name", CASES)
def test_plain_lse_is_the_log_sum_exp_of_the_visible_scores(name):
    """The plain version's log-sum-exp against ``logsumexp`` of the
    masked scores (−inf where none is visible), and its output with
    ``return_lse`` against the default call's, bit for bit."""
    q, k, v, pos, q_pos, window = _case(name, seed=1)
    t = [torch.as_tensor(x) for x in (q, k, v, pos, q_pos)]
    out, lse = ops.decode_attention(*t, window=window, return_lse=True)
    assert torch.equal(out, ops.decode_attention(*t, window=window))
    B, H, hd = q.shape
    G = H // k.shape[2]
    kh = np.repeat(k, G, axis=2)
    s = np.einsum("bhd,bchd->bhc", q.astype(np.float64),
                  kh.astype(np.float64)) / np.sqrt(hd)
    d = q_pos[:, None] - pos
    vis = (pos >= 0) & (d >= 0) & ((d < window) if window else True)
    s = np.where(vis[:, None, :], s, -np.inf)
    want = torch.logsumexp(torch.as_tensor(s), -1).numpy()
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=TOL)
    assert np.array_equal(np.isneginf(lse.numpy()), np.isneginf(want))


@pytest.mark.parametrize("M", (1, 2, 4, 8))
@pytest.mark.parametrize("S", (20, 64, 90))
def test_sharded_ring_writes_equal_the_whole_cache_write(S, M):
    """A prefill of S tokens (S < C, = C, > C) and then 2C + 5 appends
    into a ring of C = 64 slots cut into M shards, each shard written by
    `prefill_shard` / `ring_write_shard` as its rank writes it: the
    shards' rows put together equal the single-device writes bit for bit
    after every step, and JAX's one-hot ``ring_write=False`` cache (the
    decode's) wherever the reference's prefill layout agrees (S ≤ C or C
    dividing S)."""
    B, C, KV, hd = 2, 64, 2, 4
    rng = np.random.default_rng(S + M)
    whole = make_kv_cache(B, C, KV, hd, torch.float32, "cpu")
    n = C // M
    shards = [{name: x[:, r * n:(r + 1) * n].clone()
               for name, x in whole.items() if name != "ptr"}
              for r in range(M)]
    ptr = torch.zeros((), dtype=torch.int32)
    k, v = (torch.as_tensor(rng.standard_normal((B, S, KV, hd)),
                            dtype=torch.float32) for _ in range(2))
    positions = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    jc = {name: jnp.array(x.numpy(), copy=True)
          for name, x in whole.items()}
    kv_cache_write_prefill(whole, k, v, positions)
    for r, rows in enumerate(shards):
        prefill_shard(rows, k, v, positions, r * n, C)
    ptr += S
    jc = jax_write_prefill(jc, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                           jnp.asarray(positions.numpy()))
    reference_agrees = S <= C or S % C == 0

    def check(step):
        for name in ("k", "v", "pos"):
            got = torch.cat([sh[name] for sh in shards], 1)
            assert torch.equal(got, whole[name]), (step, name)
            if reference_agrees:
                assert np.array_equal(got.numpy(), np.asarray(jc[name])), (
                    step, name)
        assert int(ptr) == int(whole["ptr"]) == int(jc["ptr"])

    check("prefill")
    for t in range(2 * C + 5):
        kt = torch.as_tensor(rng.standard_normal((B, 1, KV, hd)),
                             dtype=torch.float32)
        vt = torch.as_tensor(rng.standard_normal((B, 1, KV, hd)),
                             dtype=torch.float32)
        pt = torch.full((B, 1), S + t, dtype=torch.int32)
        kv_cache_append(whole, kt, vt, pt)
        for r, rows in enumerate(shards):
            ring_write_shard(rows, kt, vt, pt, ptr, r * n, C)
        ptr += 1
        jc = jax_kv_cache_append(jc, jnp.asarray(kt.numpy()),
                                 jnp.asarray(vt.numpy()),
                                 jnp.asarray(pt.numpy()))
        check(t)


def _sds_leaves(tree) -> dict:
    name = lambda k: getattr(k, "key", getattr(k, "name", getattr(  # noqa
        k, "idx", k)))
    return {"/".join(str(name(k)) for k in p):
            (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _meta_leaves(tree) -> dict:
    out = {}
    for p, x in path_leaves(tree):
        assert x.device.type == "meta", p
        out["/".join(str(k) for k in p)] = (
            tuple(x.shape), str(x.dtype).removeprefix("torch."))
    return out


def test_arch_ids_are_the_reference_s():
    assert list(ARCH_IDS) == list(JAX_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    """`input_specs` for every shape of the arch's smoke config: the same
    keys, shapes and dtypes as the reference's ``ShapeDtypeStruct``s
    (the cache tree included), as meta tensors."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    shapes = shapes_for(arch)
    assert [s.name for s in shapes] == [s.name for s in jax_shapes_for(arch)]
    for shape, jshape in zip(shapes, jax_shapes_for(arch)):
        got = _meta_leaves(steps.input_specs(cfg, shape))
        want = _sds_leaves(jax_steps.input_specs(jcfg, jshape))
        assert got == want, (arch, shape.name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_matches_jax(arch):
    """`abstract_train_state` (meta tensors) against the reference's
    ``jax.eval_shape`` of its train state: parameters, the optimizer's
    step, moments and master, and the compression residuals — the same
    paths, shapes and dtypes, with and without ``compress_pods``."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    for compress in (False, True):
        got = _meta_leaves(steps.abstract_train_state(
            cfg, steps.StepConfig(compress_pods=compress)))
        want = _sds_leaves(jax_steps.abstract_train_state(
            jcfg, jax_steps.StepConfig(compress_pods=compress)))
        assert got == want, (arch, compress)


@pytest.mark.parametrize("M", (2, 4))
@pytest.mark.parametrize("arch", ("qwen2-0.5b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "gemma3-1b"))
def test_model_over_a_split_cache_equals_the_whole_cache(arch, M):
    """The model's prefill and 70 decode steps (the 64-slot rings wrap)
    over a split cache (`models.cache.split_cache`: each ring as M
    sequence runs, written run by run, the runs' decode attention merged
    by log-sum-exp — the meshed decode's arithmetic on one device)
    against the same steps over the whole cache: logits within 1e-5,
    positions and cursors bit-equal, and the first attention block's keys
    (which no earlier attention's rounding reaches) bit-equal."""
    from repro_torch.models.cache import split_cache
    from repro_torch.models.transformer import (decode_step, init_caches,
                                                init_params, prefill)

    cfg = get_smoke_config(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         torch.float32, "cpu")
    B, S, C = 2, 50, 64
    whole = init_caches(cfg, B, C, torch.float32, "cpu")
    split = split_cache(whole, M)
    rng = np.random.default_rng(M)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + 70)))
    a, _ = prefill(params, cfg, {"tokens": toks[:, :S]}, whole)
    b, _ = prefill(params, cfg, {"tokens": toks[:, :S]}, split)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=TOL)
    for t in range(70):
        pos = torch.full((B, 1), S + t, dtype=torch.int32)
        a, _ = decode_step(params, cfg, toks[:, S + t:S + t + 1], pos, whole)
        b, _ = decode_step(params, cfg, toks[:, S + t:S + t + 1], pos, split)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=TOL,
                                   err_msg=f"step {t}")
    first = "prefix" if "prefix" in whole else "units"

    def ring(tree):
        c = tree[first][0] if first == "prefix" else next(
            v for v in tree["units"].values() if "k" in v)
        return c if first == "prefix" else {n: x[0] for n, x in c.items()}

    w, s = ring(whole), ring(split)
    joined = lambda x: x.movedim(0, 1).flatten(1, 2)  # noqa: E731
    assert torch.equal(joined(s["pos"]), w["pos"])
    assert torch.equal(s["ptr"], w["ptr"])
    assert torch.equal(joined(s["k"]), w["k"])


@pytest.mark.parametrize("cut", [(14,), (7, 7), (4, 4, 3, 3), (2, 5, 7),
                                 (1,) * 14])
def test_head_runs_of_the_prefill_equal_the_whole_call(cut):
    """The meshed prefill's head selection (`shard_attention.
    _kv_heads_for`): qwen2's 14 query heads over 2 KV heads cut into runs
    (whole groups, runs inside a group, runs across a group's edge),
    each run through the flash kernel's plain version with the KV heads
    it uses, put together bit-equal to the whole call (windowed)."""
    from repro_torch.parallel.shard_attention import _kv_heads_for

    rng = np.random.default_rng(len(cut))
    B, S, H, KV, hd = 2, 40, 14, 2, 16
    q, k, v = (torch.as_tensor(rng.standard_normal((B, S, h, hd)),
                               dtype=torch.float32) for h in (H, KV, KV))
    whole = ops.flash_attention(q, k, v, window=9)
    parts, h0 = [], 0
    for n in cut:
        kl, vl = (_kv_heads_for(t, h0, n, H // KV) for t in (k, v))
        parts.append(ops.flash_attention(q[:, :, h0:h0 + n], kl, vl,
                                         window=9))
        h0 += n
    assert torch.equal(torch.cat(parts, 2), whole)
