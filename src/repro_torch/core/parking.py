"""park/unpark — identity-based waiting (java.util.concurrent LockSupport style).

The paper (§2, Waiting Chains) requires: ``If the unpark were to execute
before the corresponding park, the threading system maintains a per-thread
flag set accordingly, and the subsequent park operation clears the flag and
returns immediately`` — i.e. a bounded binary per-thread semaphore.

`Self()` returns the identity handle usable with `unpark`.  Handles are plain
objects registered per thread; `unpark` on a *stale* handle (thread gone) is
safe, matching the paper's "safe to unpark a stale thread reference".
"""

from __future__ import annotations

import threading
import time


class ParkToken:
    """Per-thread binary permit."""

    __slots__ = ("_cond", "_permit")

    def __init__(self):
        self._cond = threading.Condition()
        self._permit = False

    def park(self, timeout: float | None = None) -> None:
        with self._cond:
            if self._permit:
                self._permit = False
                return
            self._cond.wait(timeout)
            # Consume the permit if it arrived; spurious wakeups are allowed
            # (callers always re-check their condition, per the paper).
            self._permit = False

    def unpark(self) -> None:
        with self._cond:
            self._permit = True
            self._cond.notify()


_tls = threading.local()


def self_token() -> ParkToken:
    """The paper's ``Self()`` — identity of the calling thread for park/unpark."""
    tok = getattr(_tls, "token", None)
    if tok is None:
        tok = ParkToken()
        _tls.token = tok
    return tok


def park(timeout: float | None = None) -> None:
    self_token().park(timeout)


def unpark(who: ParkToken | None) -> None:
    if who is not None:
        who.unpark()


def pause() -> None:
    """The paper's ``Pause()`` (x86 ``rep;nop``).

    Under CPython, a zero sleep is the closest "polite spin" analogue: it
    releases the GIL so other runnable threads (including the eventual
    poster) can make progress — the same *intent* as PAUSE/sched_yield,
    with the caveats about sched_yield the paper itself discusses.
    """
    time.sleep(0)
