"""The port's training path (`repro_torch.models.transformer.train_loss`,
`optim.adamw`, `parallel.steps`, `launch.train`) against the JAX package's
on the same inputs, the parameters carried across by `convert`:

* ``chunked_ce_loss``: the loss and its gradients with respect to ``h``
  and the head within 1e-5, at one, two and four chunks, with and without
  a mask and a z-loss;
* ``adamw_update``: one and three updates from a converted ``OptState``
  (a matrix, a stacked leaf and a vector, which takes no decay), with and
  without clipping: parameters, moments, master and step within 1e-6;
* ``train_loss`` on eight smoke configs cut to one unit (S = 16): the
  loss and every metric within 1e-5 relative, every gradient leaf within
  1e-5 of the leaf's largest magnitude (f32 sums in other orders; the
  largest gap seen was 5e-6, xlstm's time loops);
* the four remat policies: each gives the reference's loss and
  gradients, and all four give the port's bit for bit;
* accumulation over four microbatches equals the full batch
  (`tests/test_parallel_steps.py`'s check), and one ``make_train_step``
  step at A = 1 and A = 4 equals JAX's (``fsdp=False``, no mesh, no
  compression): parameters and the whole optimizer state;
* ``launch.train.main`` on the CPU learns and resumes
  (`tests/test_e2e_train.py`), a run cut and resumed follows the straight
  run bit for bit, and it trains the granite smoke config and the vision
  and audio frontends' stub batches.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ShapeSpec as JShape
from repro.configs.registry import get_smoke_config as j_smoke
from repro.models import transformer as jt
from repro.optim import adamw as jadam
from repro.parallel import steps as jsteps
from repro_torch import convert
from repro_torch.configs.registry import ShapeSpec as TShape
from repro_torch.configs.registry import get_smoke_config as t_smoke
from repro_torch.launch.train import main as train_main
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw as tadam
from repro_torch.parallel import steps as tsteps

torch.backends.cuda.matmul.allow_tf32 = False

TRAIN_ARCHS = ["qwen2-0.5b", "gemma3-1b", "granite-moe-3b-a800m",
               "deepseek-moe-16b", "recurrentgemma-9b", "xlstm-350m",
               "internvl2-1b", "musicgen-medium"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close_leafwise(got, want, tol=1e-5, what=""):
    """Every leaf within ``tol`` of the largest magnitude of its
    reference leaf."""
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl_ = tadam.leaves(got)
    assert len(tl_) == len(jl)
    for t, (path, j) in zip(tl_, jl):
        j = np.asarray(j)
        err = np.abs(_np(t).astype(np.float64) - j).max() if j.size else 0.0
        assert err <= tol * max(np.abs(j).max(), 1e-30), \
            (what, jax.tree_util.keystr(path), err, np.abs(j).max())


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        b["labels"] = rng.integers(0, cfg.vocab,
                                   (B, S + cfg.n_patches)).astype(np.int32)
    elif cfg.frontend == "audio":
        b = {"frame_embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32), "labels": b["labels"]}
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _requires_grad(params):
    return tadam.tree_map(lambda p: p.detach().requires_grad_(), params)


def _port_value_and_grad(params, cfg, batch, **kw):
    req = _requires_grad(params)
    loss, metrics = tt.train_loss(req, cfg, batch, **kw)
    wrt = tadam.leaves(req)
    grads = torch.autograd.grad(loss, wrt, allow_unused=True,
                                materialize_grads=True)
    by = {id(w): g for w, g in zip(wrt, grads)}
    return loss, metrics, tadam.tree_map(lambda w: by[id(w)], req)


@functools.lru_cache(maxsize=None)
def _j_value_and_grad(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jt.train_loss(p, cfg, b), has_aux=True))


def _configs(name, units=None):
    jc, tc = j_smoke(name), t_smoke(name)
    if units is not None:
        jc = dataclasses.replace(jc, num_units=units)
        tc = dataclasses.replace(tc, num_units=units)
    return jc, tc


# ------------------------------------------------------------- the loss ----


@pytest.mark.parametrize("chunk", [16, 8, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_ce_loss_matches_jax(chunk, masked):
    rng = np.random.default_rng(chunk)
    B, S, D, V = 2, 16, 24, 97
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = ((rng.random((B, S)) < 0.7) if masked
            else np.ones((B, S))).astype(np.float32)
    zw = 1e-4 if masked else 0.0

    def jloss(h_, head_):
        return jt.chunked_ce_loss(h_, head_, jnp.asarray(labels),
                                  jnp.asarray(mask), chunk=chunk,
                                  z_weight=zw)[0]

    jl, (jgh, jghead) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.as_tensor(h).requires_grad_()
    thead = torch.as_tensor(head).requires_grad_()
    tl_, cnt = tt.chunked_ce_loss(th, thead, torch.as_tensor(labels),
                                  torch.as_tensor(mask), chunk=chunk,
                                  z_weight=zw)
    tgh, tghead = torch.autograd.grad(tl_, (th, thead))
    assert float(cnt) == mask.sum()
    np.testing.assert_allclose(tl_.item(), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgh.numpy(), np.asarray(jgh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tghead.numpy(), np.asarray(jghead),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- AdamW -------


@pytest.mark.parametrize("updates", [1, 3])
@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_update_matches_jax(updates, clipped):
    """From a JAX state after one update, converted, ``updates`` more
    updates on both sides: the matrix and the stacked leaf decay, the
    vector (ndim 1) does not; ``clip_norm`` 0.05 clips every step."""
    rng = np.random.default_rng(updates + 10 * clipped)
    params = {"w": rng.standard_normal((4, 5)).astype(np.float32),
              "units": {"s": rng.standard_normal((2, 3, 4)).astype(
                  np.float32)},
              "b": rng.standard_normal((5,)).astype(np.float32)}
    cfg = jadam.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                            clip_norm=0.05 if clipped else 1e3)
    tcfg = tadam.AdamWConfig(*cfg)

    def grads(i):
        r = np.random.default_rng(100 + i)
        return jax.tree.map(
            lambda p: r.standard_normal(p.shape).astype(np.float32), params)

    jp = jax.tree.map(jnp.asarray, params)
    jopt = jadam.init_opt_state(jp)
    jp, jopt, _ = jadam.adamw_update(cfg, grads(0), jopt, jnp.float32)
    topt = convert.opt_state_from_jax(jopt, device="cpu")
    for i in range(1, updates + 1):
        g = grads(i)
        jp, jopt, jm = jadam.adamw_update(cfg, g, jopt, jnp.float32)
        tp, topt, tm = tadam.adamw_update(
            tcfg, convert.params_from_jax(g, device="cpu"), topt,
            torch.float32)
    assert int(topt.step) == int(jopt.step) == updates + 1
    for got, want in ((tp, jp), (topt.mu, jopt.mu), (topt.nu, jopt.nu),
                      (topt.master, jopt.master)):
        for t, j in zip(tadam.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6,
                                       atol=1e-6)
    np.testing.assert_allclose(tm["grad_norm"].item(),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
    assert (tm["grad_norm"].item() > cfg.clip_norm) == clipped


def test_adamw_updates_f32_parameters_in_place():
    """The master of f32 parameters is their storage: an update writes the
    caller's (stacked) leaves in place and returns them."""
    params = {"units": {"w": torch.ones((3, 2, 2))}, "b": torch.ones(2)}
    opt = tadam.init_opt_state(params)
    ptr = params["units"]["w"].data_ptr()
    grads = tadam.tree_map(torch.ones_like, params)
    new, opt, _ = tadam.adamw_update(tadam.AdamWConfig(lr=0.1), grads, opt)
    assert new["units"]["w"].data_ptr() == ptr
    assert not torch.equal(params["units"]["w"], torch.ones((3, 2, 2)))
    assert int(opt.step) == 1


# --------------------------------------------------------- train_loss ------


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_loss_and_grads_match_jax(arch):
    jc, tc = _configs(arch, units=1)
    params = jax.jit(jt.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jc)
    b = _batch(jc, 2, 16)
    (jl, jm), jg = _j_value_and_grad(jc)(params, _jb(b))
    tl_, tm, tg = _port_value_and_grad(
        convert.params_from_jax(params, device="cpu"), tc, _tb(b))
    np.testing.assert_allclose(tl_.item(), float(jl), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _close_leafwise(tg, jg, what=arch)
    if jc.n_experts:
        assert float(jm["lb_loss"]) > 0


@functools.lru_cache(maxsize=None)
def _remat_reference():
    cfg = j_smoke("qwen2-72b")  # two units: 2level groups them
    params = jax.jit(jt.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), cfg)
    b = _batch(cfg, 4, 16, seed=3)
    (jl, _), jg = _j_value_and_grad(cfg)(params, _jb(b))
    tp = convert.params_from_jax(params, device="cpu")
    base = _port_value_and_grad(tp, t_smoke("qwen2-72b"), _tb(b),
                                remat="none")
    return tp, b, float(jl), jg, base


@pytest.mark.parametrize("remat", ["none", "full", "dots", "2level"])
def test_remat_modes_same_loss_and_grads(remat):
    tp, b, jl, jg, (bl, _, bg) = _remat_reference()
    tl_, _, tg = _port_value_and_grad(tp, t_smoke("qwen2-72b"), _tb(b),
                                      remat=remat)
    np.testing.assert_allclose(tl_.item(), jl, rtol=1e-5)
    _close_leafwise(tg, jg, what=remat)
    assert torch.equal(tl_, bl)
    for t, base in zip(tadam.leaves(tg), tadam.leaves(bg)):
        assert torch.equal(t, base)


def _window_12(cfg):
    """gemma3's smoke config with its sliding windows cut to 12 keys, so
    they cross the 8-key blocks."""
    return dataclasses.replace(cfg, unit=tuple(
        dataclasses.replace(b, window=12) if b.window else b
        for b in cfg.unit))


@functools.lru_cache(maxsize=None)
def _blocked_reference():
    cfg = _window_12(j_smoke("gemma3-1b"))
    params = jax.jit(jt.init_params, static_argnums=1)(
        jax.random.PRNGKey(2), cfg)
    b = _batch(cfg, 2, 32, seed=4)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jt.train_loss(p, cfg, b, kv_block=8), has_aux=True))(
        params, _jb(b))
    return convert.params_from_jax(params, device="cpu"), b, float(jl), jg


@pytest.mark.parametrize("remat", ["none", "full", "dots", "2level"])
def test_blocked_attention_grads_match_jax(remat):
    """S=32 over KV blocks of 8: the port checkpoints each block (nested
    in the unit's remat policy) and still gives JAX's loss and
    gradients."""
    tp, b, jl, jg = _blocked_reference()
    tl_, _, tg = _port_value_and_grad(tp, _window_12(t_smoke("gemma3-1b")),
                                      _tb(b), remat=remat, kv_block=8)
    np.testing.assert_allclose(tl_.item(), jl, rtol=1e-5)
    _close_leafwise(tg, jg, what=remat)


def _saved_bytes(fn):
    """The bytes autograd saves for backward while ``fn()`` runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


def test_blocked_attention_keeps_no_score_matrices():
    """Under autograd each KV block is checkpointed: S=256 over blocks
    of 32 saves less than one (B, H, S, S) f32 matrix, where one block of
    256 keeps several, with the same gradients; and the model's train
    mode keeps that much less in each layer."""
    from repro_torch.kernels.ref import blockwise_attention

    g = torch.Generator().manual_seed(0)
    B, S, H, hd = 1, 256, 2, 8
    q, k, v = (torch.randn(B, S, H, hd, generator=g).requires_grad_()
               for _ in range(3))
    pos = torch.arange(S)[None]
    (one, one_bytes), (blocked, blocked_bytes) = (
        _saved_bytes(lambda kb=kb: blockwise_attention(q, k, v, pos, pos,
                                                       kv_block=kb))
        for kb in (S, 32))
    square = B * H * S * S * 4
    assert blocked_bytes < square < 2 * square < one_bytes
    torch.testing.assert_close(blocked, one, rtol=1e-5, atol=1e-6)
    for a, b in zip(torch.autograd.grad(one.sum(), (q, k, v)),
                    torch.autograd.grad(blocked.sum(), (q, k, v))):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)

    cfg = t_smoke("qwen2-0.5b")
    params = _requires_grad(tt.init_params(torch.Generator().manual_seed(0),
                                           cfg, device="cpu"))
    batch = _tb(_batch(cfg, 1, S))
    _, one_block = _saved_bytes(lambda: tt.train_loss(
        params, cfg, batch, remat="none", kv_block=S))
    _, blocks = _saved_bytes(lambda: tt.train_loss(
        params, cfg, batch, remat="none", kv_block=32))
    assert blocks < one_block - cfg.n_layers * square


def test_unknown_remat_and_mode_raise():
    cfg = t_smoke("qwen2-0.5b")
    params = tt.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    with pytest.raises(ValueError, match="remat"):
        tt.train_loss(params, cfg, _tb(_batch(cfg, 1, 4)), remat="half")
    with pytest.raises(ValueError, match="mode"):
        tt.block_forward(cfg.unit[0], cfg, params["units"]["b0"],
                         torch.zeros((1, 2, cfg.d_model)),
                         torch.zeros((1, 2), dtype=torch.int32), None,
                         "score")


# ------------------------------------------------------------ the step -----


def _step_configs(A):
    jc, tc = _configs("qwen2-0.5b")
    js = jsteps.default_step_config(jc, JShape("t", 32, 8, "train"), dp=1,
                                    accum_steps=A, param_dtype=jnp.float32,
                                    fsdp=False)
    ts = tsteps.default_step_config(tc, TShape("t", 32, 8, "train"), dp=1,
                                    accum_steps=A, param_dtype=torch.float32)
    return jc, tc, js, ts


def test_accum_equals_full_batch():
    """A=4 microbatch accumulation ≈ A=1 on the same global batch (f32),
    as `tests/test_parallel_steps.py` holds the reference."""
    out = {}
    for A in (1, 4):
        jc, tc, _, ts = _step_configs(A)
        state = tsteps.make_train_state(torch.Generator().manual_seed(0), tc,
                                        ts, device="cpu")
        step = tsteps.make_train_step(tc, TShape("t", 32, 8, "train"), ts,
                                      tadam.AdamWConfig(lr=1e-3,
                                                        warmup_steps=1,
                                                        total_steps=10))
        state, metrics = step(state, _tb(_batch(tc, 8, 32)))
        out[A] = (float(metrics["loss"]), _np(tadam.leaves(state.params)[0]))
    assert abs(out[1][0] - out[4][0]) < 1e-4
    np.testing.assert_allclose(out[1][1], out[4][1], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("A", [1, 4])
def test_train_step_matches_jax(A):
    """One `make_train_step` step from the same converted `TrainState`:
    the metrics and the moments (linear in the gradient) within 1e-5, the
    parameters and master within 5% of one step (0.05 · lr).  Adam's
    first step moves each weight by lr · g/(|g| + eps), so a gradient
    element near eps (1e-8) passes its f32 rounding (~1e-8 here, 1e-6 of
    the leaf) to the weight at full scale: qwen2's key bias showed 1.4e-5
    against lr = 1e-3."""
    jc, tc, js, ts = _step_configs(A)
    opt = jadam.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jstate = jsteps.make_train_state(jax.random.PRNGKey(0), jc, js)
    tstate = convert.train_state_from_jax(jstate, device="cpu")
    assert tstate.residuals == {} and tstate.opt.step.dtype == torch.int32
    b = _batch(jc, 8, 32)
    jstate, jm = jax.jit(jsteps.make_train_step(
        jc, JShape("t", 32, 8, "train"), js, opt))(jstate, _jb(b))
    tstate, tm = tsteps.make_train_step(
        tc, TShape("t", 32, 8, "train"), ts,
        tadam.AdamWConfig(*opt))(tstate, _tb(b))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert int(tstate.opt.step) == int(jstate.opt.step) == 1
    for f in ("mu", "nu"):
        _close_leafwise(getattr(tstate.opt, f), getattr(jstate.opt, f),
                        what=f)
    for got, want in ((tstate.params, jstate.params),
                      (tstate.opt.master, jstate.opt.master)):
        for t, j in zip(tadam.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5,
                                       atol=0.05 * opt.lr)


def test_default_step_config_budget():
    """Accumulation doubles until a microbatch fits the activation
    budget (the reference's rule) — 30 GB, the reference's share of its
    chip (6 of 16 GB) applied to the H100's 80 GB."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("qwen2-0.5b")
    shape = TShape("t", 4096, 256, "train")
    assert tsteps.StepConfig().act_budget_bytes == 30e9
    sc = tsteps.default_step_config(cfg, shape)
    tokens = 256 * 4096 / sc.accum_steps
    assert sc.accum_steps > 1 and sc.remat == "full"
    assert tsteps.est_train_act_bytes(cfg, tokens) <= 30e9
    assert tsteps.est_train_act_bytes(cfg, 2 * tokens) > 30e9
    assert tsteps.default_step_config(
        cfg, TShape("p", 64, 2, "prefill")).remat == "none"


# ----------------------------------------------------------- the driver ----


def test_train_loop_learns_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    losses = train_main([
        "--arch", "qwen2-0.5b", "--smoke", "--steps", "14", "--batch", "4",
        "--seq", "64", "--ckpt-dir", ck, "--ckpt-every", "7", "--lr", "5e-3",
        "--log-every", "50", "--device", "cpu",
    ])
    assert len(losses) == 14
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), "loss did not improve"
    # resume continues from step 14 (checkpointed at the end) for 4 more
    more = train_main([
        "--arch", "qwen2-0.5b", "--smoke", "--steps", "18", "--batch", "4",
        "--seq", "64", "--ckpt-dir", ck, "--resume", "--log-every", "50",
        "--device", "cpu",
    ])
    assert len(more) == 4  # only the new steps ran


def test_resume_follows_the_straight_run(tmp_path):
    """A run cut at step 4 (checkpoint) and resumed to 6 with the same
    schedule horizon gives the straight run's losses bit for bit."""
    common = ["--smoke", "--batch", "2", "--seq", "16", "--total-steps", "6",
              "--log-every", "50", "--device", "cpu"]
    straight = train_main(["--steps", "6"] + common)
    ck = str(tmp_path / "ck")
    first = train_main(["--steps", "4", "--ckpt-dir", ck, "--ckpt-every",
                        "2"] + common)
    rest = train_main(["--steps", "6", "--ckpt-dir", ck, "--resume"] + common)
    assert first + rest == straight


def test_sigterm_mid_update_saves_a_whole_step(tmp_path, monkeypatch):
    """A SIGTERM that lands inside the second AdamW update (after its
    first leaf is written in place) gives an emergency checkpoint equal
    to a straight run's after two whole steps, and exit code 143."""
    common = ["--smoke", "--batch", "2", "--seq", "16", "--total-steps", "4",
              "--log-every", "50", "--device", "cpu"]
    straight = str(tmp_path / "straight")
    train_main(["--steps", "2", "--ckpt-dir", straight] + common)

    update, leaves = tadam.adamw_update, tadam.leaves
    calls = []

    def torn_update(cfg, grads, opt, *a, **k):
        calls.append(1)
        if len(calls) != 2:
            return update(cfg, grads, opt, *a, **k)

        def killing_leaves(tree):
            out = leaves(tree)
            if tree is not opt.master:
                return out

            def gen():
                yield out[0]
                os.kill(os.getpid(), signal.SIGTERM)
                yield from out[1:]
            return gen()

        monkeypatch.setattr(tadam, "leaves", killing_leaves)
        try:
            return update(cfg, grads, opt, *a, **k)
        finally:
            monkeypatch.setattr(tadam, "leaves", leaves)

    monkeypatch.setattr(tsteps, "adamw_update", torn_update)
    before = signal.getsignal(signal.SIGTERM)
    cut = str(tmp_path / "cut")
    with pytest.raises(SystemExit) as exc:
        train_main(["--steps", "4", "--ckpt-dir", cut, "--ckpt-every", "100"]
                   + common)
    assert exc.value.code == 143 and len(calls) == 2
    assert signal.getsignal(signal.SIGTERM) in (before, signal.SIG_DFL)
    want = torch.load(f"{straight}/step_000000002/shard_00000.pt")
    got = torch.load(f"{cut}/step_000000002/shard_00000.pt")
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_train_moe_arch_runs():
    losses = train_main([
        "--arch", "granite-moe-3b-a800m", "--smoke", "--steps", "6",
        "--batch", "4", "--seq", "32", "--log-every", "50", "--device", "cpu",
    ])
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_train_frontend_archs_run(arch):
    """The trainer builds the reference's stub batches for the vision
    frontend (zero patch embeddings, their labels 0 and masked) and the
    audio one (token-valued frames) and trains on them."""
    losses = train_main([
        "--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
        "--seq", "16", "--log-every", "50", "--device", "cpu",
    ])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_train_units_cut_the_depth(capsys):
    """``--units N`` trains the config cut to N of its repeated units (the
    smoke run's depth cut) at the same width."""
    losses = train_main([
        "--smoke", "--units", "1", "--steps", "2", "--batch", "2",
        "--seq", "16", "--log-every", "50", "--device", "cpu",
    ])
    cfg = t_smoke("qwen2-0.5b")
    cut = len(cfg.prefix) + len(cfg.unit) + len(cfg.suffix)
    assert cut < cfg.n_layers
    assert f"layers={cut} d={cfg.d_model} " in capsys.readouterr().out
    assert len(losses) == 2 and np.isfinite(losses).all()
