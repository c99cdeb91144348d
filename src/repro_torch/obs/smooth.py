"""Rolling-median trace smoothing (à la HomebrewNLP's ``wandblog.py``).

Per-round engine gauges are noisy step functions — tokens/round jumps as
slots retire, kv_free sawtooths at every alloc/release.  A rolling MEDIAN
(not mean) keeps the smoothed trace on actually-observed values and is
robust to the single-round spikes that make mean-smoothed dashboards lie
(one preemption burst drags a mean for the whole window; the median
shrugs it off).
"""

from __future__ import annotations

import statistics
from collections import deque


class RollingMedian:
    """Median over a sliding window of the last ``window`` observations.

    ``push(x)`` returns the median INCLUDING ``x`` — a fresh tracker echoes
    its first value, so traces need no warm-up special-casing.  O(window)
    per push via ``statistics.median`` over a deque; windows here are
    dashboard-sized (≤ a few hundred), far below where a two-heap
    implementation would earn its complexity.
    """

    def __init__(self, window: int = 9):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self._buf: deque = deque(maxlen=window)

    def push(self, x: float) -> float:
        self._buf.append(x)
        return statistics.median(self._buf)

    @property
    def value(self) -> float:
        """Current median (nan before any push)."""
        return statistics.median(self._buf) if self._buf else float("nan")

    def reset(self) -> None:
        self._buf.clear()


class TraceSmoother:
    """Rolling medians over named fields of a record stream: feed per-round
    sample dicts, get back ``{field: median}`` for the selected fields —
    the smoothed companion trace `EngineObs` attaches to sink records."""

    def __init__(self, fields: tuple, window: int = 9):
        self._trackers = {f: RollingMedian(window) for f in fields}

    def push(self, record: dict) -> dict:
        return {f: t.push(record[f]) for f, t in self._trackers.items()
                if f in record}
