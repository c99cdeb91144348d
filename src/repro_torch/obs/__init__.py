"""Host-side observability for the TWA serving engine — the port of
``repro.obs``, the same modules line for line.

The device side of the observability story lives in
`serving.engine_state`: an in-scan :class:`TelemetryRing` appended to by
every scanned engine round and drained in the megastep's ONE host sync.
This package is the host side — everything downstream of the per-round
sample stream:

* :class:`LogHistogram` — log-bucketed streaming histograms for
  p50/p99/p999 quantiles in O(1) memory (latency-style heavy tails);
* :class:`RollingMedian` — rolling-median trace smoothing for noisy
  per-round gauges (à la HomebrewNLP's ``wandblog.py``);
* sinks — :class:`JsonlSink`, :class:`StdoutSink`, :class:`CallbackSink`:
  pluggable per-round record consumers;
* :class:`TenantSLO` / :class:`EngineObs` — per-tenant TTFT/TPOT event
  tracking keyed on the engine's virtual ``clock=`` and SLO-attainment
  reporting, consumed by ``scheduler.telemetry()`` (the ``slo`` key);
* :class:`TraceBuffer` / :func:`build_spans` / :func:`to_perfetto`
  — per-request span trees from the in-scan event table, with
  Chrome-trace export and critical-path breakdowns;
* :class:`FlightRecorder` — bounded pre-crash window that cuts a
  post-mortem bundle on sentinel trips, recovery-ladder engagement, or a
  replica reap;
* :func:`aggregate` — cross-replica ``EngineObs`` reduction to
  fleet-level p50/p99/p999 TTFT/TPOT and per-replica health.

Everything here is host-side Python (the health-bit names come from
`serving.sentinels`), with no device work: attaching an ``EngineObs``
never adds a host sync to either serving path.
"""

from .cluster import aggregate, render_cluster_table
from .flight import FlightRecorder
from .hist import LogHistogram
from .recorder import EngineObs
from .sinks import CallbackSink, JsonlSink, StdoutSink
from .slo import TenantSLO
from .smooth import RollingMedian
from .trace import TraceBuffer, build_spans, to_perfetto, write_perfetto

__all__ = [
    "LogHistogram",
    "RollingMedian",
    "JsonlSink",
    "StdoutSink",
    "CallbackSink",
    "TenantSLO",
    "EngineObs",
    "TraceBuffer",
    "build_spans",
    "to_perfetto",
    "write_perfetto",
    "FlightRecorder",
    "aggregate",
    "render_cluster_table",
]
