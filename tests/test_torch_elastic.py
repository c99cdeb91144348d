"""Elastic re-sharding (`repro_torch.runtime.elastic`) and DTensor
checkpoints against the reference.

* ``plan_for_membership`` equals the reference's over a sweep;
* checkpoint → restore → the same loss on one device, as
  `tests/test_parallel_steps.py` holds the reference;
* on four gloo ranks (`_torch_ranks.elastic`): a dp 4 state checkpointed,
  restored onto the same mesh (bit-equal loss), onto dp 2 (ranks 2 and 3
  sit out) for one step, checkpointed again and restored onto dp 4 for
  two more — each loss within 1e-6 of the straight dp 4 run.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro.runtime import elastic as jel
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ShapeSpec, get_smoke_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import steps
from repro_torch.runtime import elastic as tel

ARCH = "qwen2-0.5b"
B, S, LR = 8, 32, 1e-3


@pytest.mark.parametrize("n_model", [1, 2, 4, 8])
def test_plan_for_membership_matches_jax(n_model):
    """Every (alive hosts, devices a host, batch, epoch) of a sweep gives
    the reference's plan."""
    for hosts, per_host, batch, epoch in itertools.product(
            range(1, 9), (1, 2, 4, 8), (1, 6, 8, 12, 256), (0, 3)):
        want = jel.plan_for_membership(hosts, per_host, n_model, batch, epoch)
        got = tel.plan_for_membership(hosts, per_host, n_model, batch, epoch)
        assert (got.epoch, got.n_data, got.n_model, got.global_batch) == (
            want.epoch, want.n_data, want.n_model, want.global_batch)


def test_elastic_reshard_bit_exact(tmp_path):
    """Checkpoint → restore → the same trajectory on one device."""
    cfg = get_smoke_config(ARCH)
    shape = ShapeSpec("t", S, B, "train")
    sc = steps.default_step_config(cfg, shape, accum_steps=1,
                                   param_dtype=torch.float32, fsdp=False)
    state = steps.make_train_state(torch.Generator().manual_seed(0), cfg, sc,
                                   device="cpu")
    step = steps.make_train_step(cfg, shape, sc)
    batch = ranks._tb(ranks.batch_np(cfg.vocab, B, S))
    state, _ = step(state, batch)
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, state, blocking=True)
    restored, at = ck.restore(state)
    assert at == 1
    # the step rewrites an f32 state in place: continue on copies
    copy = lambda st: steps.TrainState(*[
        type(x)(*[_clone(v) for v in x]) if hasattr(x, "_fields")
        else _clone(x) for x in st])
    _, m1 = step(copy(state), batch)
    _, m2 = step(restored, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=1e-6)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _jax_state():
    """JAX's seeded train state as ``{key path: array}`` and its
    single-device step's loss on the first batch."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import ShapeSpec as JShape
    from repro.configs.registry import get_smoke_config as jget
    from repro.optim.adamw import AdamWConfig as JAdamW
    from repro.parallel import steps as jsteps

    cfg = jget(ARCH)
    shape = JShape("t", S, B, "train")
    sc = jsteps.default_step_config(cfg, shape, dp=1, accum_steps=1,
                                    param_dtype=jnp.float32, fsdp=False)
    st = jax.jit(lambda: jsteps.make_train_state(jax.random.PRNGKey(0), cfg,
                                                 sc))()
    flat = {"/".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                     for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(st)}
    b = ranks.batch_np(cfg.vocab, B, S)
    _, m = jax.jit(jsteps.make_train_step(cfg, shape, sc, JAdamW(
        lr=LR, warmup_steps=1, total_steps=10)))(
            st, {k: jnp.asarray(v) for k, v in b.items()})
    return flat, float(m["loss"])


@pytest.fixture(scope="module")
def resized(tmp_path_factory):
    work = tmp_path_factory.mktemp("elastic")
    flat, loss = _jax_state()
    np.savez(work / "jax_state.npz", **flat)
    out = ranks.launch("elastic", 4, work / "ranks", timeout=400, arch=ARCH,
                       B=B, S=S, lr=LR, jax_state=str(work / "jax_state.npz"))
    out["jax"] = (flat, loss)
    return out


def test_train_state_from_jax_onto_a_mesh(resized):
    """`convert.train_state_from_jax(..., mesh=...)`: every leaf of JAX's
    state lands on the dp 4 mesh whole and bit-equal (the FSDP slices
    put back together), and its meshed step's loss is JAX's
    single-device one within 1e-5."""
    flat, loss = resized["jax"]
    got = resized["from_jax"]
    assert set(got["leaves"]) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got["leaves"][k], v, err_msg=k)
    assert got["loss"] == pytest.approx(loss, rel=1e-5)


def test_restore_onto_same_mesh_bit_equal(resized):
    """A dp 4 state restored onto a new dp 4 mesh steps to the very loss
    of the state that was saved."""
    assert resized["steps"] == [1, 1, 2]
    assert resized["same_mesh"] == resized["straight"][0]


def test_resize_dp_4_2_4(resized):
    """dp 4 → 2 (one step) → 4 (two steps) through checkpoints: every
    loss within 1e-6 of the straight dp 4 run."""
    assert resized["plans"] == [2, 4]
    np.testing.assert_allclose(resized["resized"], resized["straight"],
                               rtol=0, atol=1e-6)
