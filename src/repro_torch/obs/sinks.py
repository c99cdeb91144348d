"""Pluggable record sinks for the per-round telemetry stream.

A sink is anything with ``emit(record: dict)`` (and optionally
``close()``).  `EngineObs` fans every per-round sample — host ``step()``
mirror or megastep ring drain alike — out to its sinks; the engine itself
never knows where telemetry goes.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, Optional


class JsonlSink:
    """Append records to a JSONL file, one JSON object per line — the
    interchange format everything downstream (pandas, jq, the bench
    harness) already reads.  Opens lazily on first emit, flushes per
    record (a crash loses at most the in-flight line)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self.emitted = 0

    def emit(self, record: dict) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        self.emitted += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StdoutSink:
    """Print records as JSON lines (default stdout) — the ``--trace``
    follow-along view."""

    def __init__(self, prefix: str = "", stream=None):
        self.prefix = prefix
        self._stream = stream
        self.emitted = 0

    def emit(self, record: dict) -> None:
        stream = self._stream if self._stream is not None else sys.stdout
        stream.write(self.prefix + json.dumps(record) + "\n")
        self.emitted += 1

    def close(self) -> None:  # streams are borrowed, never closed
        pass


class CallbackSink:
    """Hand each record to a callable — the escape hatch for tests and
    embedders (metrics pushers, live plots).  ``filter`` optionally drops
    records before the callback."""

    def __init__(self, fn: Callable[[dict], None],
                 filter: Optional[Callable[[dict], bool]] = None):
        self._fn = fn
        self._filter = filter
        self.emitted = 0

    def emit(self, record: dict) -> None:
        if self._filter is not None and not self._filter(record):
            return
        self._fn(record)
        self.emitted += 1

    def close(self) -> None:
        pass
