"""Crash flight recorder: bounded pre-crash window + post-mortem bundles.

An aircraft flight recorder keeps the last N seconds of everything; when
something goes wrong you read the tape backwards.  Same idea here: a
:class:`FlightRecorder` rides an :class:`~repro_torch.obs.recorder.EngineObs`
(``EngineObs(flight=...)``) keeping a bounded deque of recent round
samples, and on a trigger freezes a **bundle** — samples + recent trace
events + the decoded health bitmask — for post-mortem inspection.

Triggers (all host-side, zero extra syncs):

* a sentinel bit newly trips (``observe_round`` sees health bits the
  previous round didn't have);
* a recovery ladder engages (it calls ``dump("recovery:<rung>")``);
* a router reaps a replica (it calls ``dump("replica_reaped")`` on the
  dead replica's recorder).

Bundles are plain dicts (JSON-serializable); pass ``sink=JsonlSink(...)``
to persist them as they happen, or read ``recorder.bundles`` after a run.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Optional

from ..serving.sentinels import decode_health

__all__ = ["FlightRecorder"]


def _health_flags(mask: int) -> list[str]:
    """Decode a health bitmask to named flags via the single authoritative
    table in ``serving.sentinels``."""
    return decode_health(mask) if mask else []


class FlightRecorder:
    """Bounded window of recent rounds + triggered post-mortem bundles.

    ``capacity`` is the number of round samples retained; ``trace`` is an
    optional :class:`~repro_torch.obs.trace.TraceBuffer` whose most recent
    ``trace_tail`` events are frozen into each bundle; ``max_bundles``
    caps memory under a flapping sentinel (oldest bundles are dropped);
    ``sink`` is an optional obs sink (``JsonlSink`` etc.) that receives
    each bundle as it is cut.
    """

    def __init__(self, capacity: int = 64, *, trace: Any = None,
                 trace_tail: int = 256, max_bundles: int = 16,
                 sink: Any = None):
        self.capacity = capacity
        self.trace = trace
        self.trace_tail = trace_tail
        self._samples: deque[dict] = deque(maxlen=capacity)
        self._bundles: deque[dict] = deque(maxlen=max_bundles)
        self._sink = sink
        self._last_mask = 0
        self.rounds = 0

    # ------------------------------------------------------------ feed ---

    def observe_round(self, sample: dict) -> None:
        """Append one round sample; auto-dump when a NEW sentinel bit
        appears (edge-triggered — a persistently sick engine cuts one
        bundle per distinct symptom, not one per round)."""
        self._samples.append(sample)
        self.rounds += 1
        mask = int(sample.get("health", 0))
        fresh = mask & ~self._last_mask
        self._last_mask = mask
        if fresh:
            self.dump("sentinel", extra={
                "new_bits": fresh, "new_flags": _health_flags(fresh)})

    # ------------------------------------------------------------ dump ---

    def dump(self, reason: str, extra: Optional[dict] = None) -> dict:
        """Cut a post-mortem bundle NOW and return it."""
        last = self._samples[-1] if self._samples else {}
        mask = int(last.get("health", 0))
        bundle = {
            "reason": reason,
            "round": int(last.get("round", -1)),
            "clock": float(last.get("clock", 0.0)),
            "health": {"mask": mask, "flags": _health_flags(mask)},
            "samples": [dict(s) for s in self._samples],
            "events": [],
            "extra": dict(extra or {}),
        }
        if self.trace is not None:
            evs = self.trace.events()
            bundle["events"] = evs[-self.trace_tail:]
        self._bundles.append(bundle)
        if self._sink is not None:
            try:
                self._sink({"flight_bundle": {k: v for k, v in
                                              bundle.items()
                                              if k != "samples"},
                            "reason": reason})
            except Exception:  # pragma: no cover - sink failures are
                pass           # never allowed to take down the engine
        return bundle

    # ---------------------------------------------------------- report ---

    @property
    def bundles(self) -> list[dict]:
        return list(self._bundles)

    def summary(self) -> dict:
        return {
            "rounds": self.rounds,
            "window": len(self._samples),
            "bundles": len(self._bundles),
            "reasons": [b["reason"] for b in self._bundles],
            "health": {"mask": self._last_mask,
                       "flags": _health_flags(self._last_mask)},
        }
