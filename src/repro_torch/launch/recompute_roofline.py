"""Recompute the roofline terms of dry-run analysis records — the port of
``repro.launch.recompute_roofline``: an idempotent post-processor over
``*_analysis.json`` that lets the memory model and the H100 constants
(`launch.hlo_analysis`) change without counting the cells again.  The
mesh's axis sizes come from `launch.mesh.production_axes`.

    python -m repro_torch.launch.recompute_roofline experiments/dryrun_torch
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from ..configs.registry import SHAPES, get_config
from .dryrun import OUT_DIR, roofline
from .mesh import production_axes


def recompute(path: Path) -> bool:
    r = json.loads(path.read_text())
    if not r.get("ok") or r.get("mode") != "analysis":
        return False
    cfg = get_config(r["arch"])
    shape = SHAPES[r["shape"]]
    axes = production_axes(multi_pod=(r["mesh"] == "multipod"))
    meas = {"flops": r["cost"]["flops"] + r["flops_correction_total"]
            / r["chips"],
            "bytes_accessed": r["cost"]["bytes_accessed"],
            "by_axis": r["collectives"]["by_axis"]}
    r["roofline"] = roofline(cfg, shape, meas, axes, r["chips"],
                             r["roofline"].get("dtype", "bf16"))
    path.write_text(json.dumps(r, indent=2))
    return True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    d = Path(argv[0] if argv else OUT_DIR)
    n = sum(recompute(p) for p in sorted(d.glob("*_analysis.json")))
    print(f"[recompute] {n} analysis records updated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
