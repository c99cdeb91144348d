"""The port stands alone: `repro_torch` loads no JAX and imports nothing of
`repro`; its engine runs on the card unless the caller asks for the CPU;
the modes this slice does not port raise; the kernel wrappers launch or
raise and never fall back."""

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
            "repro_torch.kernels.ops, repro_torch.serving.scheduler; "
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


@pytest.mark.parametrize("mode", ["single_tenant", "chunked_prefill",
                                  "prefix_cache", "obs", "step"])
def test_unported_modes_raise(mode):
    from repro_torch.serving.scheduler import ContinuousBatchingEngine

    kw = dict(tenants={"a": 1.0}, device="cpu", kv_pool=(8, 4))
    if mode == "single_tenant":
        kw["tenants"] = None
    elif mode == "chunked_prefill":
        kw["chunked_prefill"] = (4, 8)
    elif mode == "prefix_cache":
        kw["prefix_cache"] = 16
    elif mode == "obs":
        kw["obs"] = object()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng = ContinuousBatchingEngine(None, None, 2, **kw)
        eng.step(lambda x: x)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; only `ops` picks the plain
    version, and only for a CPU tensor."""
    from repro_torch.admission.functional_qos import make_qos
    from repro_torch.kernels import ops, paged_decode, qos_admission

    st = make_qos([1.0, 2.0], table_size=8)
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
    ops.reset_launch_counts()
    ops.qos_round(st, *rows, 0.0, 1, max_units=2)
    ops.paged_decode(q, pools, pools, tbl, lens)
    assert ops.launch_counts() == {"qos_round_fused": 0, "paged_decode": 0}


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
