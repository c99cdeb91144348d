"""The paper's `pthread` reference point: the default system user-mode
semaphore — counting semaphore over a mutex + condition variable, with **no
FIFO admission guarantee** (wakeup order is whatever the threading system
does; barging is possible because a poster's increment can be consumed by a
late arriver before any blocked waiter runs).

Used as the third curve in semabench (Figure 1) and as the non-FIFO control
in fairness tests.
"""

from __future__ import annotations

import threading


class PthreadLikeSemaphore:
    def __init__(self, count: int = 0):
        assert count >= 0
        self._count = count
        self._cond = threading.Condition()
        # telemetry only:
        self._takes = 0
        self._posts = 0

    def take(self) -> None:
        with self._cond:
            while self._count == 0:
                self._cond.wait()
            self._count -= 1
            self._takes += 1

    def post(self, n: int = 1) -> None:
        with self._cond:
            self._count += n
            self._posts += n
            if n == 1:
                self._cond.notify()
            else:
                self._cond.notify_all()

    def available(self) -> int:
        with self._cond:
            return self._count
