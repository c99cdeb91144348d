"""Request tracing: event buffer, span builder, Perfetto export.

The device emits a fixed-shape per-round event table inside the scanned
engine round (`serving.engine_state`); the host ``step()`` mirrors the
identical records.  Either way the drained stream is a flat list of
``(kind, uid, slot, arg)`` tuples stamped with the round's virtual clock.
This module turns that stream into something a human (or chrome://tracing)
can read:

* :class:`TraceBuffer` — a bounded event log fed by the scheduler and the
  router.  ``ingest_sample`` drains one telemetry sample's event list;
  ``add`` appends a single host-side (fabric) event.  Plain Python:
  attaching a buffer adds ZERO host syncs.
* :func:`build_spans` — per-request span trees keyed by uid.  A span
  survives migration (several ADMIT episodes on different replicas) and
  first-completion-wins dedupe (later duplicate terminals are counted,
  not double-built).
* :func:`to_perfetto` — Chrome-trace JSON (``traceEvents`` with ``ph:"X"``
  slices, pid = replica, tid = uid) loadable in chrome://tracing and
  ui.perfetto.dev.

Critical-path breakdown per request::

    queue      SUBMIT → first ADMIT  (minus any migration gap)
    prefill    ADMIT → last PREFILL_CHUNK of the episode
    park       Σ PARK → RESUME   (block-TWA wait inside prefill)
    decode     prefill end → terminal
    migration  Σ MIGRATE → re-ADMIT  (dead-replica requeue latency)

All times are on the engine's virtual clock, so breakdowns are exactly
reproducible and identical between the host loop and megastep paths.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Any, Iterable, Optional

from ..serving.events import (EVENT_NAMES, EV_ADMIT, EV_EXPIRE, EV_FINISH,
                              EV_MIGRATE, EV_PARK, EV_PREEMPT,
                              EV_PREFILL_CHUNK, EV_RESUME, EV_SHED,
                              EV_SUBMIT, TERMINAL_EVENTS)

__all__ = ["TraceBuffer", "build_spans", "to_perfetto", "write_perfetto"]


class TraceBuffer:
    """Bounded append-only trace-event log.

    Events are dicts ``{kind, uid, slot, arg, clock, round, replica}``.
    ``capacity`` bounds memory; once full the OLDEST events are dropped
    (and counted in ``dropped``) — a flight-recorder-style tail window.
    Insertion order is preserved, which (with Python's stable sort) keeps
    same-clock events in emission order when streams are merged.
    """

    def __init__(self, capacity: int = 65536,
                 replica: Optional[int] = None):
        self.capacity = capacity
        self.replica = replica  # default replica tag (router sets this on
        #                         each engine's buffer for span stitching)
        self._events: deque[dict] = deque(maxlen=capacity)
        self.total = 0          # events ever added (incl. dropped)
        self._seq = 0           # global tie-break for cross-buffer merges

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        return self.total - len(self._events)

    def add(self, kind: int, uid: int, slot: int, arg: int,
            clock: float, rnd: int, replica: Optional[int] = None) -> None:
        self._events.append({
            "kind": int(kind), "uid": int(uid), "slot": int(slot),
            "arg": int(arg), "clock": float(clock), "round": int(rnd),
            "replica": self.replica if replica is None else replica,
            "seq": self._seq,
        })
        self._seq += 1
        self.total += 1

    def ingest_sample(self, sample: dict,
                      replica: Optional[int] = None) -> None:
        """Drain one telemetry sample's event list (host or ring-drained)."""
        clock = float(sample.get("clock", 0.0))
        rnd = int(sample.get("round", 0))
        for kind, uid, slot, arg in sample.get("events", ()):
            self.add(kind, uid, slot, arg, clock, rnd, replica=replica)

    def events(self) -> list[dict]:
        return list(self._events)

    def summary(self, max_requests: int = 256) -> dict:
        """Compact report for ``telemetry()["trace"]``: counts, aggregate
        critical path, and per-request breakdowns (capped)."""
        spans = build_spans(self._events)
        agg = {"queue": 0.0, "prefill": 0.0, "park": 0.0, "decode": 0.0,
               "migration": 0.0}
        requests = {}
        complete = 0
        for uid, span in spans.items():
            if span["terminal"] is not None:
                complete += 1
            for k in agg:
                agg[k] += span["breakdown"][k]
            if len(requests) < max_requests:
                requests[uid] = {
                    "terminal": span["terminal"],
                    "breakdown": span["breakdown"],
                    "replicas": span["replicas"],
                    "migrations": span["migrations"],
                    "duplicates_suppressed": span["duplicates_suppressed"],
                }
        return {
            "events": len(self._events),
            "dropped": self.dropped,
            "spans": len(spans),
            "complete": complete,
            "critical_path": agg,
            "requests": requests,
        }


def _merged(sources: Iterable[Any]) -> list[dict]:
    """Flatten TraceBuffers / event lists into one clock-ordered stream.

    Stable sort on (clock, round): same-round events keep their emission
    order (the canonical segment order), which the span builder relies on
    for PARK/RESUME pairing within a round.
    """
    evs: list[dict] = []
    for src in sources:
        evs.extend(src.events() if isinstance(src, TraceBuffer) else src)
    evs.sort(key=lambda e: (e["clock"], e["round"]))
    return evs


def build_spans(*sources: Any) -> dict[int, dict]:
    """Assemble per-request span trees from one or more event streams.

    Accepts TraceBuffers and/or iterables of event dicts — pass the
    router's buffer plus every replica engine's buffer to stitch cluster
    spans.  Returns ``{uid: span}`` where each span is::

        {"uid", "start", "end", "terminal",          # name or None (open)
         "replicas": [...],                          # in visit order
         "migrations": n, "duplicates_suppressed": n,
         "segments": [{"name", "t0", "t1", "replica"}, ...],
         "breakdown": {"queue","prefill","park","decode",
                       "migration","total"},
         "events": [...]}                            # the raw records

    First-completion-wins: the FIRST terminal event (by clock) closes the
    span; later terminal records for the same uid — e.g. a duplicate
    FINISH from a zombie replica racing its migrated copy — increment
    ``duplicates_suppressed`` and change nothing else.
    """
    spans: dict[int, dict] = {}
    for ev in _merged(sources):
        uid = ev["uid"]
        if uid < 0:
            continue
        sp = spans.get(uid)
        if sp is None:
            sp = spans[uid] = {
                "uid": uid, "start": ev["clock"], "end": None,
                "terminal": None, "replicas": [], "migrations": 0,
                "duplicates_suppressed": 0, "segments": [], "events": [],
                # builder scratch (stripped below)
                "_admit": None, "_chunk_end": None, "_park": None,
                "_park_sum": 0.0, "_migrate": None, "_submit": None,
            }
        k = ev["kind"]
        if sp["terminal"] is not None:
            if k in TERMINAL_EVENTS:
                sp["duplicates_suppressed"] += 1
            continue
        sp["events"].append(ev)
        rep = ev.get("replica")
        if rep is not None and (not sp["replicas"]
                                or sp["replicas"][-1] != rep):
            sp["replicas"].append(rep)
        t = ev["clock"]
        if k == EV_SUBMIT and sp["_submit"] is None:
            sp["_submit"] = t
        elif k == EV_ADMIT:
            src = sp["_migrate"] if sp["_migrate"] is not None else \
                (sp["_submit"] if sp["_submit"] is not None else sp["start"])
            name = "migration" if sp["_migrate"] is not None else "queue"
            sp["segments"].append(
                {"name": name, "t0": src, "t1": t, "replica": rep})
            sp["_migrate"] = None
            sp["_admit"] = t
            sp["_chunk_end"] = t
        elif k == EV_PREFILL_CHUNK:
            sp["_chunk_end"] = t
        elif k == EV_PARK:
            sp["_park"] = t
        elif k == EV_RESUME:
            if sp["_park"] is not None:
                sp["segments"].append(
                    {"name": "park", "t0": sp["_park"], "t1": t,
                     "replica": rep})
                sp["_park_sum"] += t - sp["_park"]
                sp["_park"] = None
        elif k == EV_MIGRATE:
            sp["migrations"] += 1
            sp["_migrate"] = t
            sp["_admit"] = None        # episode on the dead replica is void
        elif k in TERMINAL_EVENTS:
            sp["terminal"] = EVENT_NAMES[k]
            sp["end"] = t
            if sp["_park"] is not None:       # parked at death
                sp["_park_sum"] += t - sp["_park"]
                sp["segments"].append(
                    {"name": "park", "t0": sp["_park"], "t1": t,
                     "replica": rep})
                sp["_park"] = None
            if sp["_admit"] is not None:
                ce = sp["_chunk_end"]
                if ce is not None and ce > sp["_admit"]:
                    sp["segments"].append(
                        {"name": "prefill", "t0": sp["_admit"], "t1": ce,
                         "replica": rep})
                sp["segments"].append(
                    {"name": "decode",
                     "t0": ce if ce is not None else sp["_admit"], "t1": t,
                     "replica": rep})
            elif k in (EV_SHED, EV_EXPIRE):
                src = sp["_submit"] if sp["_submit"] is not None \
                    else sp["start"]
                sp["segments"].append(
                    {"name": "queue", "t0": src, "t1": t, "replica": rep})

    for sp in spans.values():
        segs = sp["segments"]
        bd = {"queue": 0.0, "prefill": 0.0, "park": 0.0, "decode": 0.0,
              "migration": 0.0}
        for s in segs:
            bd[s["name"]] += s["t1"] - s["t0"]
        # park happens INSIDE the prefill/decode windows (block-gate parks
        # fire during chunked prefill) — deduct it from prefill first,
        # remainder from decode, so the categories tile the span without
        # double counting
        spill = bd["park"]
        take = min(spill, bd["prefill"])
        bd["prefill"] -= take
        bd["decode"] = max(0.0, bd["decode"] - (spill - take))
        end = sp["end"] if sp["end"] is not None else \
            (sp["events"][-1]["clock"] if sp["events"] else sp["start"])
        bd["total"] = end - sp["start"]
        sp["breakdown"] = bd
        for key in ("_admit", "_chunk_end", "_park", "_park_sum",
                    "_migrate", "_submit"):
            del sp[key]
    return spans


def to_perfetto(spans: dict[int, dict], *,
                time_scale: float = 1e6) -> dict:
    """Chrome-trace ("JSON Array"/"JSON Object") export of built spans.

    One ``ph:"X"`` complete slice per span segment; pid = replica index
    (0 when single-engine), tid = request uid.  ``time_scale`` converts
    virtual-clock units to microseconds (Perfetto's ``ts`` unit) — the
    default treats the virtual clock as seconds.  Instant (``ph:"i"``)
    markers flag terminals so preemptions stand out on the timeline.
    """
    out: list[dict] = []
    for uid, sp in sorted(spans.items()):
        pid0 = sp["replicas"][0] if sp["replicas"] else 0
        out.append({"name": "process_name", "ph": "M", "pid": pid0,
                    "args": {"name": f"replica {pid0}"}})
        out.append({"name": "thread_name", "ph": "M", "pid": pid0,
                    "tid": uid, "args": {"name": f"req {uid}"}})
        for seg in sp["segments"]:
            pid = seg["replica"] if seg["replica"] is not None else pid0
            out.append({
                "name": seg["name"], "cat": "request", "ph": "X",
                "ts": seg["t0"] * time_scale,
                "dur": max(0.0, (seg["t1"] - seg["t0"]) * time_scale),
                "pid": pid, "tid": uid,
                "args": {"uid": uid},
            })
        if sp["terminal"] is not None:
            pid = (sp["replicas"][-1] if sp["replicas"] else pid0)
            out.append({
                "name": sp["terminal"], "cat": "request", "ph": "i",
                "ts": sp["end"] * time_scale, "pid": pid, "tid": uid,
                "s": "t", "args": {"uid": uid},
            })
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_perfetto(path: str, spans: dict[int, dict], *,
                   time_scale: float = 1e6) -> str:
    """Serialize :func:`to_perfetto` output to ``path``; returns ``path``."""
    with open(path, "w") as f:
        json.dump(to_perfetto(spans, time_scale=time_scale), f)
    return path
