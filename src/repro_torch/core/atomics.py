"""Small atomic cells emulating the C++ std::atomic API used by the paper.

CPython's GIL makes many single-opcode operations *appear* atomic, but that is
an implementation detail (and is false on free-threaded builds).  We therefore
emulate `std::atomic<uint64_t>` / `std::atomic<T*>` with an explicit per-cell
mutex.  The mutex acquire/release also gives us the seq_cst ordering the
paper's listings assume (they deliberately avoid relaxed-memory-order
optimizations, and so do we).

The `fetch_add` here is the linearization point for ticket issuance, mirroring
the wait-free FAA the paper relies on for its FCFS guarantee.
"""

from __future__ import annotations

import threading
from typing import Generic, Optional, TypeVar

T = TypeVar("T")

MASK64 = (1 << 64) - 1


class AtomicU64:
    """std::atomic<uint64_t> with wrapping arithmetic."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: int = 0):
        self._lock = threading.Lock()
        self._value = value & MASK64

    def load(self) -> int:
        with self._lock:
            return self._value

    def store(self, value: int) -> None:
        with self._lock:
            self._value = value & MASK64

    def fetch_add(self, delta: int = 1) -> int:
        with self._lock:
            old = self._value
            self._value = (old + delta) & MASK64
            return old

    def exchange(self, value: int) -> int:
        with self._lock:
            old = self._value
            self._value = value & MASK64
            return old

    def cas(self, cmp: int, new: int) -> int:
        """compare_exchange_strong, returning the *witnessed* value (paper's
        `Atomic::cas` harmonized convention)."""
        with self._lock:
            old = self._value
            if old == cmp:
                self._value = new & MASK64
            return old


class AtomicRef(Generic[T]):
    """std::atomic<T*>: exchange / cas / load / store on object references."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: Optional[T] = None):
        self._lock = threading.Lock()
        self._value = value

    def load(self) -> Optional[T]:
        with self._lock:
            return self._value

    def store(self, value: Optional[T]) -> None:
        with self._lock:
            self._value = value

    def exchange(self, value: Optional[T]) -> Optional[T]:
        with self._lock:
            old = self._value
            self._value = value
            return old

    def cas(self, cmp: Optional[T], new: Optional[T]) -> Optional[T]:
        with self._lock:
            old = self._value
            if old is cmp:
                self._value = new
            return old


class AtomicInt:
    """std::atomic<int> (used for WaitElement.Gate)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: int = 0):
        self._lock = threading.Lock()
        self._value = value

    def load(self) -> int:
        with self._lock:
            return self._value

    def store(self, value: int) -> None:
        with self._lock:
            self._value = value

    def fetch_add(self, delta: int = 1) -> int:
        with self._lock:
            old = self._value
            self._value = old + delta
            return old
