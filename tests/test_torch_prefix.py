"""The port's prefix cache (`repro_torch.serving.prefix`) against the JAX
package's (`repro.serving.prefix`) on the same inputs, bit for bit:
`prompt_hashes`, `cache_lookup` and `cache_register` — the latter's O(N)
last-writer rule against the reference's O(N²) sweep at a small E where
homes collide, with dead weak entries (blocks freed, ``gen`` bumped)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import functional as jf
from repro.serving import prefix as jx
from repro_torch import convert
from repro_torch.core import functional as tf
from repro_torch.core import u32
from repro_torch.serving import prefix as tx


def _cache_eq(tc, jc, msg=""):
    got = convert.to_numpy(tc)
    for f in jx.PrefixCache._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jc, f)),
                                      err_msg=f"{msg} {f}")


def test_prompt_hashes_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 3, 4, 9, 16, 31):
        p = [int(x) for x in rng.integers(0, 2**31, n)] + [2**32 - 1] * (
            n % 2)
        for BS, W in ((4, 4), (4, 8), (16, 2)):
            assert tx.prompt_hashes(p, BS, W) == jx.prompt_hashes(p, BS, W)


def _world(seed, S=6, BS=4, W=4, NB=32, MB=6):
    """Prompts sharing prefixes (a few system prompts with random tails),
    their hash tables, a pool with every slot's blocks taken and a table
    mapping them — in both packages' types."""
    rng = np.random.default_rng(seed)
    systems = [list(rng.integers(1, 9, 8)) for _ in range(2)]
    prompts = [systems[int(rng.integers(0, 2))]
               + list(rng.integers(1, 4, int(rng.integers(0, 9))))
               for _ in range(S)]
    plen = np.asarray([len(p) for p in prompts], np.int32)
    ph = np.asarray([jx.prompt_hashes(p, BS, W) for p in prompts],
                    np.uint32)
    counts = np.minimum(-(-plen // BS), MB).astype(np.int32)
    jpool = jf.make_block_pool(NB)
    jpool, ids = jf.pool_alloc(jpool, jnp.asarray(counts), MB)
    tbl = np.array(ids)
    return prompts, plen, ph, jpool, tbl


@pytest.mark.parametrize("E", [8, 64])
def test_register_and_lookup_match_jax_with_collisions_and_dead_entries(E):
    """Register completed slots into a cache of E entries (E = 8 forces
    home collisions; the last writer must win in both), look every prompt
    up, free some blocks (their entries die weakly) and look up again."""
    BS = 4
    prompts, plen, ph, jpool, tbl = _world(E, BS=BS)
    S = len(prompts)
    tpool = convert.block_pool_from_jax(jpool, device="cpu")
    jc, tc = jx.make_prefix_cache(E), tx.make_prefix_cache(E, device="cpu")
    rng = np.random.default_rng(E + 1)
    tph = u32.u32(ph)
    hits = dead = 0
    for wave in range(3):
        done = rng.random(S) < 0.6
        jc = jx.cache_register(jc, jpool, jnp.asarray(ph), jnp.asarray(plen),
                               jnp.asarray(tbl), jnp.asarray(done), BS)
        tc = tx.cache_register(tc, tpool, tph, torch.as_tensor(plen),
                               torch.as_tensor(tbl), torch.as_tensor(done),
                               BS)
        _cache_eq(tc, jc, f"E={E} wave {wave} register")
        jl = jx.cache_lookup(jc, jpool, jnp.asarray(ph), jnp.asarray(plen),
                             BS)
        tl = tx.cache_lookup(tc, tpool, tph, torch.as_tensor(plen), BS)
        for name, a, b in zip(("c", "bids", "tail", "cov"), tl, jl):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"E={E} wave {wave} {name}")
        hits += int(tl[0].sum())
        # free some slots' blocks: gen bumps kill their entries
        gone = rng.random(S) < 0.3
        jpool = jf.pool_release(jpool, jnp.asarray(tbl), jnp.asarray(gone))
        tpool = tf.pool_release(tpool, torch.as_tensor(tbl),
                                torch.as_tensor(gone))
        dead += int(((tc.bid >= 0) & (tpool.gen[tc.bid.clamp(min=0).long()]
                                      != tc.gen)).sum())
        jpool, ids = jf.pool_alloc(
            jpool, jnp.asarray(np.where(gone, (tbl >= 0).sum(1), 0)
                               .astype(np.int32)), tbl.shape[1])
        tpool, _ = tf.pool_alloc(
            tpool, torch.as_tensor(np.where(gone, (tbl >= 0).sum(1), 0)
                                   .astype(np.int32)), tbl.shape[1])
        tbl = np.where(gone[:, None], np.asarray(ids), tbl)
    assert hits > 0 and dead > 0   # lookups hit; some entries died


def test_register_is_identity_on_empty_mask_and_clear_drops_all():
    prompts, plen, ph, jpool, tbl = _world(3)
    tpool = convert.block_pool_from_jax(jpool, device="cpu")
    tc = tx.make_prefix_cache(16, device="cpu")
    tc = tx.cache_register(tc, tpool, u32.u32(ph), torch.as_tensor(plen),
                           torch.as_tensor(tbl),
                           torch.ones(len(prompts), dtype=torch.bool), 4)
    same = tx.cache_register(tc, tpool, u32.u32(ph), torch.as_tensor(plen),
                             torch.as_tensor(tbl),
                             torch.zeros(len(prompts), dtype=torch.bool), 4)
    for a, b in zip(same, tc):
        assert torch.equal(a, b)
    assert (tx.cache_clear(tc).bid == -1).all()
    jc = jx.cache_clear(jx.cache_register(
        jx.make_prefix_cache(16), jpool, jnp.asarray(ph), jnp.asarray(plen),
        jnp.asarray(tbl), jnp.ones(len(prompts), bool), 4))
    _cache_eq(tx.cache_clear(tc), jc, "clear")
