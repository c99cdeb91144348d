"""Per-tenant SLO tracking: TTFT / TPOT distributions and attainment.

Definitions (the serving-standard ones, on the engine's virtual clock):

* **TTFT** — time to first token: ``first_tok_clock − submit_clock``.
* **TPOT** — time per output token after the first:
  ``(last_tok_clock − first_tok_clock) / (n_tokens − 1)`` for ``n ≥ 2``
  (a one-token response has no inter-token gap and contributes no TPOT
  sample).
* **Attainment** — the fraction of RESOLVED requests that completed
  (deadline tombstones and mid-decode preemptions are misses by
  definition — the engine's own deadline IS the SLO) and, when targets
  are configured, met ``ttft ≤ ttft_target`` / ``tpot ≤ tpot_target``.

All stamps come off the injectable engine ``clock=`` (never wall time),
so reports are reproducible under virtual time and identical between the
host loop and megastep serving paths.
"""

from __future__ import annotations

import math
from typing import Optional

from .hist import LogHistogram


class TenantSLO:
    """Event accumulator for one tenant."""

    def __init__(self, ttft_target: Optional[float] = None,
                 tpot_target: Optional[float] = None,
                 resolution: float = 0.01):
        self.ttft_target = ttft_target
        self.tpot_target = tpot_target
        self.ttft = LogHistogram(resolution=resolution)
        self.tpot = LogHistogram(resolution=resolution)
        self.submitted = 0
        self.finished = 0
        self.expired = 0
        self.preempted = 0
        self.attained = 0
        self.tokens = 0

    def record(self, *, n_tokens: int, expired: bool, preempted: bool,
               submit_clock: Optional[float],
               first_tok_clock: Optional[float],
               last_tok_clock: Optional[float]) -> None:
        """One resolved request.  ``expired`` covers both backlog
        tombstones and preemptions (mirroring ``EngineStats``); clocks may
        be ``None`` when the request never reached that lifecycle point."""
        self.submitted += 1
        self.tokens += n_tokens
        ttft = tpot = None
        if submit_clock is not None and first_tok_clock is not None:
            ttft = first_tok_clock - submit_clock
            self.ttft.add(ttft)
        if (first_tok_clock is not None and last_tok_clock is not None
                and n_tokens >= 2):
            tpot = (last_tok_clock - first_tok_clock) / (n_tokens - 1)
            self.tpot.add(tpot)
        if preempted:
            self.preempted += 1
            self.expired += 1
        elif expired:
            self.expired += 1
        else:
            self.finished += 1
            ok = True
            if self.ttft_target is not None:
                ok = ok and ttft is not None and ttft <= self.ttft_target
            if self.tpot_target is not None and tpot is not None:
                ok = ok and tpot <= self.tpot_target
            if ok:
                self.attained += 1

    def merge(self, other: "TenantSLO") -> None:
        """Fold another accumulator in (cluster aggregation: the SAME
        tenant served by several replicas).  Targets must agree — a
        cluster-level attainment number is meaningless across different
        SLOs — and histogram resolutions are checked by
        :meth:`LogHistogram.merge`."""
        if (other.ttft_target != self.ttft_target
                or other.tpot_target != self.tpot_target):
            raise ValueError("can only merge TenantSLOs with identical "
                             "targets")
        self.ttft.merge(other.ttft)
        self.tpot.merge(other.tpot)
        self.submitted += other.submitted
        self.finished += other.finished
        self.expired += other.expired
        self.preempted += other.preempted
        self.attained += other.attained
        self.tokens += other.tokens

    @property
    def attainment(self) -> float:
        return self.attained / self.submitted if self.submitted \
            else math.nan

    def summary(self) -> dict:
        return {
            "submitted": self.submitted,
            "finished": self.finished,
            "expired": self.expired,
            "preempted": self.preempted,
            "tokens": self.tokens,
            "attainment": self.attainment,
            "ttft": self.ttft.percentiles(),
            "tpot": self.tpot.percentiles(),
        }
