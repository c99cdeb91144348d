"""Log-bucketed streaming histogram — p50/p99/p999 in O(1) memory.

Latency distributions in a serving engine are heavy-tailed: storing every
TTFT/TPOT event to sort later is unbounded, and a linear-bucket histogram
either wastes its range on the tail or loses the head.  The standard fix
(HdrHistogram and friends) is geometric buckets: bucket ``i`` covers
``[min_value·g^i, min_value·g^(i+1))`` with growth ``g = 1 + resolution``,
so EVERY quantile is recovered with bounded relative error ≤ ``resolution``
regardless of scale — the property the tests pin against a full-sample
``np.percentile`` oracle.
"""

from __future__ import annotations

import math


class LogHistogram:
    """Streaming histogram over geometric buckets.

    ``resolution`` bounds the relative error of any reported quantile
    (default 5%); ``min_value`` is the left edge of bucket 0 — smaller
    observations clamp into it (a sub-nanosecond latency is noise).
    Buckets are a sparse dict: memory is O(occupied buckets), ~hundreds
    for a 9-decade range at 5%.
    """

    def __init__(self, resolution: float = 0.05, min_value: float = 1e-9):
        if not 0 < resolution < 1:
            raise ValueError(f"resolution must be in (0, 1), got {resolution}")
        if not min_value > 0:
            raise ValueError(f"min_value must be > 0, got {min_value}")
        self.resolution = resolution
        self.min_value = min_value
        self._log_g = math.log1p(resolution)
        self._counts: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.max = -math.inf
        self.min = math.inf

    def _bucket(self, x: float) -> int:
        if x <= self.min_value:
            return 0
        return int(math.log(x / self.min_value) / self._log_g)

    def _edge(self, i: int) -> float:
        """Upper edge of bucket ``i`` — the conservative (≤ +resolution
        relative error) quantile estimate."""
        return self.min_value * math.exp((i + 1) * self._log_g)

    def add(self, x: float, n: int = 1) -> None:
        b = self._bucket(x)
        self._counts[b] = self._counts.get(b, 0) + n
        self.count += n
        self.sum += x * n
        self.max = max(self.max, x)
        self.min = min(self.min, x)

    def merge(self, other: "LogHistogram") -> None:
        if (other.resolution != self.resolution
                or other.min_value != self.min_value):
            raise ValueError("can only merge histograms with identical "
                             "bucketing")
        for b, n in other._counts.items():
            self._counts[b] = self._counts.get(b, 0) + n
        self.count += other.count
        self.sum += other.sum
        self.max = max(self.max, other.max)
        self.min = min(self.min, other.min)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` ∈ [0, 1], within ±resolution relative
        error (exact at the recorded extremes: q=0 → min, q=1 → max)."""
        if not 0 <= q <= 1:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return math.nan
        if q == 0:
            return self.min
        if q == 1:
            return self.max
        target = q * self.count
        acc = 0
        for b in sorted(self._counts):
            acc += self._counts[b]
            if acc >= target:
                # clamp into the observed range: the bucket EDGE can
                # overshoot the true maximum by up to +resolution
                return min(self._edge(b), self.max)
        return self.max

    def percentiles(self) -> dict:
        """The standard serving report: p50 / p99 / p999 (+ mean, count)."""
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "p999": self.quantile(0.999),
            "max": self.max if self.count else math.nan,
        }
