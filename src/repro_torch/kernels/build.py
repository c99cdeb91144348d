"""Build and load the port's CUDA kernels.

Each source in ``src/repro_torch/csrc/`` is compiled at first use by its
own ``nvcc`` into a shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``)
under `BUILD_DIR`, and loaded with ``ctypes``.  Several sources build in
parallel (`build`).  Nothing here
runs at import time: the CPU tests import every module, and this machine
need not have ``nvcc``.

The launch counters live here too: each kernel wrapper adds one to its
entry where it launches its kernel, and nowhere else
(`kernels.ops.launch_counts` / `reset_launch_counts`); and the split-K
kernels' arrival counters (`arrival_counters`), one array per kernel,
device and stream.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def _build_dir(pkg: Path = CSRC.parent) -> Path:
    """``$REPRO_TORCH_BUILD_DIR`` if set; else ``build/kernels/`` at the
    root of the source tree when the package ``pkg`` lies in one
    (``src/repro_torch`` beside ``pyproject.toml``); else a per-user cache
    (``$XDG_CACHE_HOME/repro_torch/kernels``, ``~/.cache`` by default)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = pkg.parents[1]
    if pkg.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch" / "kernels"


BUILD_DIR = _build_dir()
SOURCES = ("qos_admission", "paged_decode", "paged_prefill", "sema_batch",
           "decode_attention", "flash_attention", "flash_attention_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"qos_round_fused": 0, "paged_decode": 0, "paged_prefill": 0,
            "sema_batch": 0, "decode_attention": 0, "flash_attention": 0,
            "decode_attention_bf16": 0, "flash_attention_bf16": 0}

_libs: dict[str, ctypes.CDLL] = {}
_arrivals: dict = {}   # (kernel, device index, raw stream) -> int32 zeros


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "/usr/local/cuda") + "/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _so(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared
    header of ``csrc/``."""
    so = _so(name)
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return not so.exists() or so.stat().st_mtime < max(
        p.stat().st_mtime for p in srcs)


def build(names=SOURCES, force: bool = False) -> dict:
    """Compile the named sources, one ``nvcc`` each, all started together.
    Returns ``{name: {"seconds": wall time, "ptxas": compiler report}}``
    for what was built; raises with the compiler's output on failure."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(
        [exe, *NVCC_FLAGS, "-o", str(_so(n)), str(CSRC / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for n in todo}
    out = {}
    for n, p in procs.items():
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{stdout}{stderr}")
        out[n] = {"seconds": time.perf_counter() - t0,
                  "ptxas": (stdout + stderr).strip()}
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built first if missing
    or older than its source), with ``argtypes``/``restype`` set from
    ``signatures`` ({function: [ctypes types]}; every entry returns the
    ``cudaError_t`` of its launch as an int)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_so(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def arrival_counters(name: str, dev, stream: int, n: int):
    """The int32 arrival counters of the split-K kernel ``name`` for
    launches on ``stream`` (a raw CUDA stream of device ``dev``): at least
    ``n`` of them, zero.  Each launch leaves them zero and launches on one
    stream run in order, so a stream's launches may share them; every
    other stream (a second worker's, a CUDA-graph capture's) gets its
    own.  Allocated, on ``stream``, at its first use or when ``n`` grows."""
    import torch

    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (name, idx, stream)
    c = _arrivals.get(key)
    if c is None or c.numel() < n:
        c = _arrivals[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                         device=dev)
    return c
