"""The port's sharding rules (`repro_torch.parallel.sharding`,
`repro_torch.launch.mesh`) against the reference's, spec by spec.

No process group is needed: every spec function takes the mesh's axis
sizes explicitly, and JAX's side is derived under an ``AbstractMesh`` of
the same sizes (``jax.sharding.use_abstract_mesh``; no devices).  For
every smoke config the port's own parameter, cache and batch trees are
held to JAX's at (data 2, model 2), (data 2, model 4), (pod 2, data 2,
model 2), the reference's v5e production meshes and the port's H100 ones;
the full configs' trees (carried across as shapes) at the production
meshes.  ``_mode_rules`` and ``default_step_config`` are compared for
the four ``SHAPES``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType, PartitionSpec

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import SHAPES as JSHAPES
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke_config as jget_smoke
from repro.models.transformer import init_caches as jinit_caches
from repro.models.transformer import init_params as jinit_params
from repro.parallel import sharding as jsh
from repro.parallel import steps as jsteps
from repro_torch.configs.registry import SHAPES, get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models.transformer import init_caches, init_params
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel import steps as tsteps

MESHES = {
    "2x2": {"data": 2, "model": 2},
    "2x4": {"data": 2, "model": 4},
    "pod2x2x2": {"pod": 2, "data": 2, "model": 2},
    "v5e": {"data": 16, "model": 16},
    "v5e_pods": {"pod": 2, "data": 16, "model": 16},
    "h100": tmesh.production_axes(),
    "h100_pods": tmesh.production_axes(multi_pod=True),
}
PRODUCTION = ("v5e", "v5e_pods", "h100", "h100_pods")
CACHE_B, CACHE_C = 8, 64


def _abstract(axes: dict):
    return AbstractMesh(tuple(axes.values()), tuple(axes),
                        axis_types=(AxisType.Auto,) * len(axes))


def _jflat(specs) -> list:
    """(path, spec as a tuple) in flatten order."""
    out = []
    for path, s in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec)):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out.append((key, tuple(tuple(e) if isinstance(e, list) else e
                               for e in s)))
    return out


def _tflat(specs, path=()) -> list:
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _tflat(specs[k],
                                                         path + (k,))]
    if isinstance(specs, list):
        return [x for i, v in enumerate(specs) for x in _tflat(v, path + (i,))]
    return [("/".join(str(k) for k in path), specs)]


def _same(port, ref, what):
    assert len(port) == len(ref), what
    for (tp, ts), (jp, js) in zip(port, ref):
        assert tp == jp, (what, tp, jp)
        assert ts == js, (what, tp, ts, js)


def _meta_tree(tree):
    """A tree of JAX shapes as torch meta tensors (the full configs)."""
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta_tree(v) for v in tree]
    return torch.empty(tree.shape, device="meta")


_TREES: dict = {}


def _trees(arch: str, full: bool):
    """(port params, port caches, JAX params, JAX caches) — shapes only on
    JAX's side; the port's own trees for a smoke config, JAX's shapes as
    meta tensors for a full one."""
    key = (arch, full)
    if key not in _TREES:
        jcfg = jget_config(arch) if full else jget_smoke(arch)
        jp = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg,
                                                 jnp.float32))
        jc = jax.eval_shape(lambda: jinit_caches(jcfg, CACHE_B, CACHE_C,
                                                 jnp.float32))
        if full:
            tp, tc = _meta_tree(jp), _meta_tree(jc)
        else:
            cfg = get_smoke_config(arch)
            tp = init_params(torch.Generator().manual_seed(0), cfg,
                             torch.float32, "cpu")
            tc = init_caches(cfg, CACHE_B, CACHE_C, torch.float32, "cpu")
        _TREES[key] = (tp, tc, jp, jc)
    return _TREES[key]


def _batch_trees(arch: str, B: int):
    cfg = jget_smoke(arch)
    jb = {"tokens": jax.ShapeDtypeStruct((B, 16), jnp.int32),
          "labels": jax.ShapeDtypeStruct((B, 16), jnp.int32)}
    if cfg.frontend == "vision":
        jb["patch_embeds"] = jax.ShapeDtypeStruct((B, 4, cfg.d_model),
                                                  jnp.float32)
    return _meta_tree(jb), jb


def _compare(arch: str, mesh: str, full: bool) -> None:
    axes = MESHES[mesh]
    tp, tc, jp, jc = _trees(arch, full)
    with jax.sharding.use_abstract_mesh(_abstract(axes)):
        for fsdp in (False, True):
            js = jsh.param_pspecs(jp, fsdp=fsdp)
            ts = tsh.param_pspecs(tp, fsdp=fsdp, axes=axes)
            _same(_tflat(ts), _jflat(js), f"params fsdp={fsdp}")
            jo = jsh.opt_pspecs(js, None)
            to = tsh.opt_pspecs(ts)
            for f in ("mu", "nu", "master"):
                _same(_tflat(getattr(to, f)), _jflat(getattr(jo, f)), f)
            assert to.step == tuple(jo.step) == ()
        _same(_tflat(tsh.cache_pspecs(tc, axes=axes)),
              _jflat(jsh.cache_pspecs(jc)), "caches")
        for B in (1, 8, 12):
            tb, jb = _batch_trees(arch, B)
            _same(_tflat(tsh.batch_pspecs(tb, axes=axes)),
                  _jflat(jsh.batch_pspecs(jb)), f"batch B={B}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax_smoke(arch, mesh):
    """The port's own smoke-config trees: parameter specs (FSDP on and
    off), optimizer, cache and batch specs equal JAX's entry by entry."""
    _compare(arch, mesh, full=False)


@pytest.mark.parametrize("mesh", PRODUCTION)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax_full_configs(arch, mesh):
    """The full configs' shapes at the production meshes."""
    _compare(arch, mesh, full=True)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mode_rules_and_step_config_match_jax(shape, mesh):
    """``_mode_rules`` and ``default_step_config`` (accumulation, remat,
    FSDP) for each shape on each mesh, every arch, at the reference's
    activation budget."""
    axes = MESHES[mesh]
    with jax.sharding.use_abstract_mesh(_abstract(axes)):
        for arch in ARCH_IDS:
            jcfg = jget_config(arch)
            from repro_torch.configs.registry import get_config
            tcfg = get_config(arch)
            jr = jsteps._mode_rules(jcfg, JSHAPES[shape])
            tr = tsteps._mode_rules(tcfg, SHAPES[shape], axes=axes)
            assert tr == {k: tuple(v) if isinstance(v, list) else v
                          for k, v in jr.items()}, (arch, tr, jr)
            dp = jsteps.dp_size()
            assert tsteps.dp_size(axes) == dp
            js = jsteps.default_step_config(jcfg, JSHAPES[shape], dp=dp)
            ts = tsteps.default_step_config(
                tcfg, SHAPES[shape], dp=dp, axes=axes,
                act_budget_bytes=js.act_budget_bytes)
            assert (ts.accum_steps, ts.remat, ts.fsdp, ts.compress_pods) == (
                js.accum_steps, js.remat, js.fsdp, js.compress_pods), arch


def test_production_mesh_sizes():
    """The H100 production mesh: 8 GPUs of a node on ``model``, 32 nodes
    on ``data``, 2 clusters on ``pod``; the reference's device counts."""
    assert tmesh.production_axes() == {"data": 32, "model": 8}
    assert tmesh.production_axes(multi_pod=True) == {"pod": 2, "data": 32,
                                                     "model": 8}
    assert tmesh.mesh_device_count() == 256
    assert tmesh.mesh_device_count(multi_pod=True) == 512


def test_spec_helpers_without_a_mesh():
    """Without an active mesh every rule resolves to replicated and
    ``constrain`` is the identity — the single-device model is untouched."""
    assert tsh.mesh_axes() == {}
    x = torch.ones(4, 8)
    assert tsh.constrain(x, "batch", "vocab") is x
    assert tsh.spec_for("batch", "vocab") == (None, None)
    with tsh.axis_rules(batch=("data",)):
        assert tsh.spec_for("batch", axes={"pod": 2, "data": 2}) == ("data",)
        assert tsh.current_rules()["batch"] == ("data",)
    assert tsh.current_rules()["batch"] == ("pod", "data")
    # a missing axis is dropped; one that does not divide the dimension too
    assert tsh.spec_for("batch", "heads", dim_sizes=(8, 3),
                        axes={"data": 2, "model": 2}) == ("data", None)
    assert tsh.spec_for("batch", dim_sizes=(8,),
                        axes={"pod": 2, "data": 2}) == (("pod", "data"),)
