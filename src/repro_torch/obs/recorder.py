"""`EngineObs` — the object the engine's ``obs=`` parameter accepts.

Glues the pieces together: per-round samples (host mirror or megastep
ring drain — identical records either way) fan out to the sinks with an
optional rolling-median companion trace; resolved requests feed the
per-tenant :class:`TenantSLO` accumulators; ``summary()`` is what
``scheduler.telemetry()`` exposes under the ``slo`` key and
``render_table()`` is the human view ``--trace`` prints at exit.
"""

from __future__ import annotations

import math
from typing import Optional

from ..serving.sentinels import decode_health
from .flight import _health_flags
from .slo import TenantSLO
from .smooth import TraceSmoother

# per-round gauges worth a smoothed companion trace (noisy sawtooths)
_SMOOTH_FIELDS = ("tokens", "active", "kv_free", "prefill_tokens",
                  "blocks_shared")


class EngineObs:
    """Observability layer for `ContinuousBatchingEngine`.

    ``sinks``: iterable of objects with ``emit(record)`` (see
    `repro_torch.obs.sinks`).  ``ttft_target``/``tpot_target``: optional SLO
    targets in clock units, applied to every tenant.  ``smooth_window``:
    when > 1, each sink record carries a ``"smoothed"`` sub-dict of
    rolling medians over the noisy per-round gauges.

    Duck-typed against the engine: `record_round` takes the per-round
    sample dict, `record_request` the resolved ``Request`` (reads its
    lifecycle clock stamps) — no scheduler import, no device work.
    """

    def __init__(self, sinks=(), *, ttft_target: Optional[float] = None,
                 tpot_target: Optional[float] = None,
                 smooth_window: int = 1, resolution: float = 0.01,
                 flight=None):
        self.sinks = list(sinks)
        self.flight = flight        # optional obs.flight.FlightRecorder
        self.ttft_target = ttft_target
        self.tpot_target = tpot_target
        self._resolution = resolution
        self.tenants: dict[str, TenantSLO] = {}
        self.rounds = 0
        self.health_mask = 0        # OR of every round's sentinel bitmask
        self.sick_rounds = 0        # rounds with any sentinel bit set
        self.tenant_retries: dict[str, int] = {}  # recovery requeues seen
        self.prefix_hits = 0        # zero-prefill cached-prefix admissions
        self.cow_copies = 0         # copy-on-write takes of shared tails
        self.blocks_shared_peak = 0  # max blocks referenced by >1 table
        self._smoother = (TraceSmoother(_SMOOTH_FIELDS, smooth_window)
                          if smooth_window > 1 else None)

    # ------------------------------------------------------- engine feed ----

    def record_round(self, sample: dict) -> None:
        self.rounds += 1
        h = int(sample.get("health", 0))
        if h:
            self.health_mask |= h
            self.sick_rounds += 1
        self.prefix_hits += int(sample.get("prefix_hits", 0))
        self.cow_copies += int(sample.get("cow_copies", 0))
        self.blocks_shared_peak = max(self.blocks_shared_peak,
                                      int(sample.get("blocks_shared", 0)))
        if self.flight is not None:
            self.flight.observe_round(sample)
        record = sample
        if self._smoother is not None or h:
            record = dict(sample)
            if self._smoother is not None:
                record["smoothed"] = self._smoother.push(sample)
            if h:
                # named flags next to the raw mask wherever it surfaces
                record["health_flags"] = _health_flags(h)
        for sink in self.sinks:
            sink.emit(record)

    def record_request(self, req) -> None:
        """A resolved request (finished / tombstoned / preempted)."""
        t = getattr(req, "tenant_id", "default")
        retries = int(getattr(req, "retries", 0))
        if retries:
            self.tenant_retries[t] = self.tenant_retries.get(t, 0) + retries
        slo = self.tenants.get(t)
        if slo is None:
            slo = self.tenants[t] = TenantSLO(
                ttft_target=self.ttft_target, tpot_target=self.tpot_target,
                resolution=self._resolution)
        slo.record(
            n_tokens=len(getattr(req, "out_tokens", ())),
            expired=bool(getattr(req, "expired", False)),
            preempted=bool(getattr(req, "preempted", False)),
            submit_clock=getattr(req, "submit_clock", None),
            first_tok_clock=getattr(req, "first_tok_clock", None),
            last_tok_clock=getattr(req, "last_tok_clock", None))

    # ---------------------------------------------------------- reporting ---

    def summary(self) -> dict:
        return {
            "rounds": self.rounds,
            "health": {"mask": self.health_mask,
                       "flags": _health_flags(self.health_mask),
                       "sick_rounds": self.sick_rounds},
            "retries": dict(sorted(self.tenant_retries.items())),
            "prefix": {"hits": self.prefix_hits,
                       "cow_copies": self.cow_copies,
                       "blocks_shared_peak": self.blocks_shared_peak},
            "tenants": {t: s.summary() for t, s in sorted(self.tenants.items())},
        }

    def render_table(self, recovery: Optional[dict] = None) -> str:
        """Fixed-width per-tenant SLO table (the ``--trace`` exit view).
        ``recovery``: the engine's ``telemetry()["recovery"]`` counters —
        rendered as a footer with the accumulated health bitmask, so one
        glance shows WHICH tenants paid for WHICH faults."""
        hdr = (f"{'tenant':<10} {'done':>5} {'exp':>4} {'pre':>4} "
               f"{'rty':>4} {'attain':>7} {'ttft p50':>9} {'ttft p99':>9} "
               f"{'tpot p50':>9} {'tpot p99':>9}")
        lines = [hdr, "-" * len(hdr)]

        def fmt(x: float) -> str:
            return "-" if x is None or math.isnan(x) else f"{x:.3f}"

        for t, s in sorted(self.tenants.items()):
            r = s.summary()
            lines.append(
                f"{t:<10} {r['finished']:>5} {r['expired']:>4} "
                f"{r['preempted']:>4} {self.tenant_retries.get(t, 0):>4} "
                f"{fmt(r['attainment']):>7} "
                f"{fmt(r['ttft']['p50']):>9} {fmt(r['ttft']['p99']):>9} "
                f"{fmt(r['tpot']['p50']):>9} {fmt(r['tpot']['p99']):>9}")
        if self.health_mask:
            names = ",".join(decode_health(self.health_mask))
            lines.append(f"health: 0x{self.health_mask:x} ({names}) over "
                         f"{self.sick_rounds}/{self.rounds} rounds")
        if self.prefix_hits or self.cow_copies or self.blocks_shared_peak:
            lines.append(f"prefix: hits={self.prefix_hits} "
                         f"cow={self.cow_copies} "
                         f"shared_peak={self.blocks_shared_peak}")
        if recovery:
            lines.append("recovery: " + " ".join(
                f"{k}={v}" for k, v in sorted(recovery.items()) if v))
        return "\n".join(lines)

    def close(self) -> None:
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()
