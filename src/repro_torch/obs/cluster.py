"""Fleet SLO aggregation: reduce per-replica `EngineObs` to cluster view.

A tenant spread across replicas by a router has no single
`TenantSLO` — each replica accumulated its own histograms.  Because
:class:`~repro_torch.obs.hist.LogHistogram` buckets are position-independent
counts, merging is exact bucket-wise addition (`LogHistogram.merge`), so
cluster p50/p99/p999 are identical to what a single engine observing the
combined event stream would report (within the same ±resolution bound —
property-tested in tests/test_torch_obs.py).

:func:`aggregate` is the one entry point: give it the per-replica
``EngineObs`` objects (plus optional router telemetry for lease-headroom
and migration-latency sections) and get the fleet report.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from ..serving.sentinels import decode_health
from .hist import LogHistogram
from .slo import TenantSLO

__all__ = ["aggregate", "render_cluster_table"]


def _merge_into(dst: dict[str, TenantSLO], src: dict[str, TenantSLO],
                resolution: float) -> None:
    for t, slo in src.items():
        mine = dst.get(t)
        if mine is None:
            mine = dst[t] = TenantSLO(ttft_target=slo.ttft_target,
                                      tpot_target=slo.tpot_target,
                                      resolution=resolution)
        mine.merge(slo)


def aggregate(replicas: Sequence, *, router: Optional[dict] = None,
              names: Optional[Sequence[str]] = None) -> dict:
    """Reduce per-replica ``EngineObs`` into one fleet report.

    ``replicas``: EngineObs instances (dead replicas' recorders included —
    their requests still count).  ``router``: optionally the
    ``ReplicaRouter.telemetry()`` dict; contributes lease-headroom,
    migration, and shed sections.  ``names``: display names per replica
    (defaults to indices).

    Returns::

        {"replicas": n,
         "per_replica": [{"name", "rounds", "health", "finished",
                          "tokens"}, ...],
         "health": {"mask", "flags", "sick_rounds"},     # fleet OR / sum
         "tenants": {t: TenantSLO summary over ALL replicas},
         "cluster": {"ttft": {...}, "tpot": {...},       # fleet-wide
                     "submitted", "finished", "expired", "preempted",
                     "tokens", "attainment"},
         "fabric": {...}}                                # router sections
    """
    resolution = (replicas[0]._resolution if replicas else 0.01)
    tenants: dict[str, TenantSLO] = {}
    fleet_mask = 0
    sick = 0
    per_replica = []
    for i, obs in enumerate(replicas):
        _merge_into(tenants, obs.tenants, resolution)
        fleet_mask |= obs.health_mask
        sick += obs.sick_rounds
        per_replica.append({
            "name": (names[i] if names is not None else str(i)),
            "rounds": obs.rounds,
            "health": obs.health_mask,
            "finished": sum(s.finished for s in obs.tenants.values()),
            "tokens": sum(s.tokens for s in obs.tenants.values()),
        })

    # fleet-wide latency: one more exact bucket-wise reduce across tenants
    ttft = LogHistogram(resolution=resolution)
    tpot = LogHistogram(resolution=resolution)
    tot = {"submitted": 0, "finished": 0, "expired": 0, "preempted": 0,
           "tokens": 0, "attained": 0}
    for slo in tenants.values():
        ttft.merge(slo.ttft)
        tpot.merge(slo.tpot)
        tot["submitted"] += slo.submitted
        tot["finished"] += slo.finished
        tot["expired"] += slo.expired
        tot["preempted"] += slo.preempted
        tot["tokens"] += slo.tokens
        tot["attained"] += slo.attained

    flags = decode_health(fleet_mask)

    out = {
        "replicas": len(replicas),
        "per_replica": per_replica,
        "health": {"mask": fleet_mask, "flags": flags,
                   "sick_rounds": sick},
        "tenants": {t: s.summary() for t, s in sorted(tenants.items())},
        "cluster": {
            "ttft": ttft.percentiles(),
            "tpot": tpot.percentiles(),
            "submitted": tot["submitted"],
            "finished": tot["finished"],
            "expired": tot["expired"],
            "preempted": tot["preempted"],
            "tokens": tot["tokens"],
            "attainment": (tot["attained"] / tot["submitted"]
                           if tot["submitted"] else math.nan),
        },
    }

    if router is not None:
        leases = router.get("leases", {})
        out["fabric"] = {
            # lease headroom: how close each replica ran to its cap
            "lease_headroom": {
                str(k): v for k, v in sorted(leases.items())
            } if isinstance(leases, dict) else leases,
            "migrations": router.get("migrations", 0),
            "migration_latency": router.get("migration_latency", {}),
            "shed": router.get("shed", 0),
            "deaths": router.get("deaths", 0),
            "duplicates_suppressed": router.get("duplicates_suppressed", 0),
        }
    return out


def render_cluster_table(report: dict) -> str:
    """Fixed-width fleet view: per-replica rows + cluster tail latencies."""
    def fmt(x) -> str:
        return "-" if x is None or (isinstance(x, float) and math.isnan(x)) \
            else (f"{x:.3f}" if isinstance(x, float) else str(x))

    hdr = (f"{'replica':<10} {'rounds':>7} {'done':>6} {'tokens':>8} "
           f"{'health':>18}")
    lines = [hdr, "-" * len(hdr)]
    for row in report["per_replica"]:
        h = row["health"]
        lines.append(f"{row['name']:<10} {row['rounds']:>7} "
                     f"{row['finished']:>6} {row['tokens']:>8} "
                     f"{('0x%x' % h) if h else 'ok':>18}")
    c = report["cluster"]
    lines.append(f"cluster: submitted={c['submitted']} "
                 f"finished={c['finished']} expired={c['expired']} "
                 f"preempted={c['preempted']} "
                 f"attainment={fmt(c['attainment'])}")
    lines.append(f"  ttft p50={fmt(c['ttft']['p50'])} "
                 f"p99={fmt(c['ttft']['p99'])} "
                 f"p999={fmt(c['ttft']['p999'])}")
    lines.append(f"  tpot p50={fmt(c['tpot']['p50'])} "
                 f"p99={fmt(c['tpot']['p99'])} "
                 f"p999={fmt(c['tpot']['p999'])}")
    if report["health"]["mask"]:
        lines.append("health: "
                     + ",".join(report["health"]["flags"])
                     + f" (0x{report['health']['mask']:x})")
    fab = report.get("fabric")
    if fab:
        lines.append(f"fabric: migrations={fab['migrations']} "
                     f"shed={fab['shed']} deaths={fab['deaths']} "
                     f"dup_suppressed={fab['duplicates_suppressed']}")
    return "\n".join(lines)
