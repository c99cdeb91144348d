"""The port stands alone: `repro_torch` loads no JAX and imports nothing of
`repro`; its engine and factories run on the card unless the caller asks
for the CPU; every engine mode builds and steps; the kernel wrappers
launch or raise and never fall back."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.M)


def test_import_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels.ops, repro_torch.kernels.paged_prefill, "
            "repro_torch.kernels.sema_batch, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.serving.scheduler, repro_torch.serving.prefix, "
            "repro_torch.serving.prefill, repro_torch.serving.sentinels, "
            "repro_torch.obs, "
            "repro_torch.configs.registry, repro_torch.models.transformer, "
            "repro_torch.launch.serve; "
            "from repro_torch.configs.registry import get_config, ARCH_IDS; "
            "[get_config(a) for a in ARCH_IDS]; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={**os.environ,
                                         "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_jax_or_repro_import_line(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), f"{path} imports jax or repro"


def test_engine_defaults_to_the_card():
    from repro_torch.serving.scheduler import ContinuousBatchingEngine

    kw = dict(tenants={"a": 1.0})
    if torch.cuda.is_available():
        eng = ContinuousBatchingEngine(None, None, 2, **kw)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ContinuousBatchingEngine(None, None, 2, **kw)
    assert ContinuousBatchingEngine(None, None, 2, device="cpu",
                                    **kw).device.type == "cpu"


def test_model_factories_default_to_the_card():
    """`make_paged_pool_model` and `make_prefix_cache` resolve ``device``
    as the engine does: None is the card, and raises where CUDA is
    absent; ``"cpu"`` builds on the CPU."""
    from repro_torch.serving.engine_state import make_paged_pool_model
    from repro_torch.serving.prefix import make_prefix_cache

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_paged_pool_model(torch.Generator(), 8, 4, 4, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_prefix_cache(8)
    m = make_paged_pool_model(torch.Generator().manual_seed(0), 8, 4, 4, 2,
                              device="cpu")
    assert all(v.device.type == "cpu" for v in m.values())
    assert make_prefix_cache(8, device="cpu").bid.device.type == "cpu"


@pytest.mark.parametrize("mode", ["single_tenant", "chunked_prefill",
                                  "prefix_cache", "obs", "step"])
def test_ported_modes_build_and_step(mode):
    """Each engine mode is ported: it builds, and ``step()`` on an empty
    engine returns 0 — the single-tenant engine, the multi-tenant host
    ``step()`` over the up-front pool, chunked prefill, prefix sharing,
    and the ``obs=`` layer of the port's own `obs` package.  A block pool
    without tenants raises ``ValueError`` as in the reference."""
    from repro_torch.obs import EngineObs
    from repro_torch.serving.scheduler import ContinuousBatchingEngine

    kw = dict(tenants={"a": 1.0}, device="cpu", kv_pool=(8, 4))
    if mode == "single_tenant":
        with pytest.raises(ValueError, match="QoS mode"):
            ContinuousBatchingEngine(None, None, 2, **{**kw, "tenants": None})
        kw = dict(device="cpu")
    elif mode == "chunked_prefill":
        kw["chunked_prefill"] = (4, 8)
    elif mode == "prefix_cache":
        kw.update(chunked_prefill=(4, 8), prefix_cache=16)
    elif mode == "obs":
        kw["obs"] = EngineObs()
    eng = ContinuousBatchingEngine(None, None, 2, **kw)
    assert eng.step(lambda x: x) == 0
    assert eng.stats.host_syncs == 1
    assert eng.telemetry()["last_samples"][0]["round"] == 0
    if mode == "obs":
        assert eng.telemetry()["slo"]["rounds"] == 1


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; only `ops` picks the plain
    version, and only for a CPU tensor."""
    from repro_torch.admission.functional_qos import make_qos
    from repro_torch.kernels import ops, paged_decode, paged_prefill, \
        qos_admission

    st = make_qos([1.0, 2.0], table_size=8, device="cpu")
    rows = (torch.zeros(4, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool),
            torch.full((4,), torch.inf))
    with pytest.raises(ValueError, match="CUDA"):
        qos_admission.qos_round_fused(st, *rows, 0.0, 1, max_units=2)
    q = torch.zeros(2, 1, 8)
    pools = torch.zeros(4, 2, 1, 8)
    tbl = torch.full((2, 2), -1, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode.paged_decode(q, pools, pools, tbl, lens)
    qc = torch.zeros(2, 3, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        paged_prefill.paged_prefill(qc, qc, qc, pools, pools, tbl, lens,
                                    lens)
    ops.reset_launch_counts()
    ops.qos_round(st, *rows, 0.0, 1, max_units=2)
    ops.paged_decode(q, pools, pools, tbl, lens)
    ops.paged_prefill(qc, qc, qc, pools, pools, tbl, lens, lens)
    from repro_torch.core import u32
    from repro_torch.kernels import decode_attention, flash_attention, \
        sema_batch

    seq = u32.u32([0] * 8)
    req = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        sema_batch.sema_batch(0, 2, seq, req, 0, 1)
    kd = torch.zeros(2, 5, 1, 8)
    kpos = torch.zeros(2, 5, dtype=torch.int32)
    qpos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention(q, kd, kd, kpos, qpos)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(qc, qc, qc)
    ops.sema_batch(0, 2, seq, req, 0, 1)
    ops.decode_attention(q, kd, kd, kpos, qpos)
    ops.flash_attention(qc, qc, qc)
    assert ops.launch_counts() == {
        "qos_round_fused": 0, "paged_decode": 0, "paged_prefill": 0,
        "sema_batch": 0, "decode_attention": 0, "flash_attention": 0}


@pytest.mark.parametrize("what", ["converters", "model_server",
                                  "serve_main"])
def test_new_entry_points_default_to_the_card(what):
    """The converters, the `ModelServer` and the serve driver resolve
    ``device`` as the engine does: None is the card, and raises where
    CUDA is absent; ``"cpu"`` runs here."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("the default is the card here")
    if what == "converters":
        calls = [lambda d: convert.tensor(np.zeros(2), d),
                 lambda d: convert.params_from_jax({"w": np.zeros(2)}, d),
                 lambda d: convert.caches_from_jax({"ptr": np.int32(0)}, d),
                 lambda d: convert.model_from_jax({"emb": np.zeros(2)}, d),
                 lambda d: convert.multi_sema_from_jax(
                     (np.zeros(2, np.uint32), np.ones(2, np.uint32)), d)]
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call(None)
            assert call("cpu") is not None
    elif what == "model_server":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.ModelServer("qwen2-0.5b", 2)
        assert serve.ModelServer("qwen2-0.5b", 2,
                                 device="cpu").device.type == "cpu"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--requests", "1", "--slots", "1"])
        eng = serve.main(["--requests", "2", "--slots", "1", "--prompt-len",
                          "2", "--max-new", "2", "--device", "cpu"])
        assert eng.stats.finished == 2


def test_kernel_build_dir(monkeypatch, tmp_path):
    """Kernels build into the checkout's ``build/kernels`` from a source
    tree, into a per-user cache from an installed package, and into
    ``$REPRO_TORCH_BUILD_DIR`` when it is set."""
    from repro_torch.kernels import build

    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build._build_dir() == ROOT / "build" / "kernels"
    installed = tmp_path / "lib" / "python3" / "site-packages" / "repro_torch"
    assert build._build_dir(installed) == (tmp_path / "cache" / "repro_torch"
                                           / "kernels")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kb"))
    assert build._build_dir() == tmp_path / "kb"
