"""Data pipeline — the port of ``repro.data.pipeline``, copied whole (it
holds no JAX): a deterministic synthetic LM corpus and a multi-worker
prefetch through a bounded buffer built from TWO of the paper's
semaphores (`core.twa_semaphore`) — the classic producer/consumer
construction (Downey, The Little Book of Semaphores), with the TWA
semaphore supplying FIFO admission:

    free  = TWASemaphore(depth)   # producers take a free slot
    ready = TWASemaphore(0)       # consumers take a ready item

FIFO matters here: with N producer threads, ticket order = production order,
so batch order is *deterministic* given worker count — reproducible input
pipelines for free, which a pthread-style barging semaphore cannot
guarantee.  Batches are numpy arrays, bit-equal to the reference's for the
same seed and ``start_step``; the trainer moves them to its device.

The `queue_depth()` telemetry of the ready semaphore is the pipeline's
backpressure signal, exported to the runtime coordinator (straggler
detection: a host whose ready-depth stays 0 is input-starved).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from ..core.twa_semaphore import TWASemaphore


# ------------------------------------------------------- synthetic corpus ---


@dataclass
class SyntheticLM:
    """Deterministic synthetic token stream: a mixture of Zipfian unigrams
    and short repeated motifs (so models have learnable structure)."""

    vocab: int
    seq_len: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._motifs = rng.integers(
            0, self.vocab, size=(self.n_motifs, self.motif_len), dtype=np.int64
        )

    def sample(self, index: int) -> dict:
        """Sample `index` is the global sequence id — same id, same sequence,
        regardless of worker count or arrival order (elastic-restart safe)."""
        rng = np.random.default_rng((self.seed << 20) ^ index)
        toks = rng.choice(self.vocab, size=self.seq_len + 1, p=self._probs)
        # splice motifs to create predictable n-gram structure
        mlen = min(self.motif_len, max(1, self.seq_len // 2))
        for _ in range(max(1, self.seq_len // (4 * mlen))):
            m = rng.integers(0, self.n_motifs)
            at = rng.integers(0, max(1, self.seq_len - mlen))
            toks[at : at + mlen] = self._motifs[m][:mlen]
        return {
            "tokens": toks[:-1].astype(np.int32),
            "labels": toks[1:].astype(np.int32),
        }


# --------------------------------------------------------- bounded buffer ---


class BoundedBuffer:
    """Classic 2-semaphore bounded buffer; FIFO on both sides via TWA."""

    def __init__(self, depth: int, waiting: str = "futex"):
        self.depth = depth
        self._free = TWASemaphore(depth, waiting=waiting)
        self._ready = TWASemaphore(0, waiting=waiting)
        self._slots = [None] * depth
        self._wcur = 0
        self._rcur = 0
        self._wlock = threading.Lock()
        self._rlock = threading.Lock()

    def put(self, item) -> None:
        self._free.take()
        with self._wlock:
            slot = self._wcur % self.depth
            self._wcur += 1
            self._slots[slot] = item
        self._ready.post()

    def get(self):
        self._ready.take()
        with self._rlock:
            slot = self._rcur % self.depth
            self._rcur += 1
            item = self._slots[slot]
            self._slots[slot] = None
        self._free.post()
        return item

    def backpressure(self) -> dict:
        """Semaphore telemetry: producers blocked (free queue depth) and
        consumers starved (ready queue depth)."""
        return {
            "producers_blocked": self._free.queue_depth(),
            "consumers_starved": self._ready.queue_depth(),
            "items_ready": self._ready.available(),
        }


# ---------------------------------------------------------------- loader ----


class DataLoader:
    """Multi-worker prefetching loader over a sharded index space.

    Host `host_id` of `n_hosts` owns indices {i : i ≡ host_id (mod n_hosts)}
    — elastic re-sharding just changes (host_id, n_hosts) and the index
    cursor restarts from the checkpointed step (deterministic samples make
    this exact).
    """

    def __init__(
        self,
        source: SyntheticLM,
        batch_size: int,
        *,
        n_workers: int = 2,
        depth: int = 8,
        host_id: int = 0,
        n_hosts: int = 1,
        start_step: int = 0,
        collate: Callable | None = None,
    ):
        self.source = source
        self.batch_size = batch_size
        self.host_id, self.n_hosts = host_id, n_hosts
        self.buffer = BoundedBuffer(depth)
        self._start_step = start_step
        self._cursor = start_step * batch_size
        self._cursor_lock = threading.Lock()
        self._stop = threading.Event()
        self._collate = collate or (lambda items: {
            k: np.stack([it[k] for it in items]) for k in items[0]
        })
        self._workers = [
            threading.Thread(target=self._work, daemon=True) for _ in range(n_workers)
        ]
        for w in self._workers:
            w.start()

    def _next_indices(self):
        with self._cursor_lock:
            base = self._cursor
            self._cursor += self.batch_size
        step = base // self.batch_size
        return step, [
            (base + j) * self.n_hosts + self.host_id for j in range(self.batch_size)
        ]

    def _work(self):
        while not self._stop.is_set():
            step, idxs = self._next_indices()
            try:
                batch = self._collate([self.source.sample(i) for i in idxs])
            except Exception as e:  # surface producer faults to the consumer
                self.buffer.put((step, e))
                return
            # buffer.put blocks on the `free` TWA semaphore when the trainer
            # is behind — bounded memory, FIFO handoff.
            self.buffer.put((step, batch))

    def __iter__(self) -> Iterator[dict]:
        """Step-ordered stream: with N workers, batches may complete out of
        order; a bounded reorder stage (≤ n_workers entries) restores the
        deterministic step order so worker count never changes the stream."""
        pending: dict[int, dict] = {}
        expect = self._start_step
        while True:
            while expect not in pending:
                step, item = self.buffer.get()
                if isinstance(item, Exception):
                    raise item
                pending[step] = item
            yield pending.pop(expect)
            expect += 1

    def stop(self):
        self._stop.set()
        # unblock any producer stuck in put()
        while self.buffer.backpressure()["items_ready"] > 0:
            try:
                self.buffer.get()
            except Exception:
                break

    def telemetry(self) -> dict:
        return self.buffer.backpressure()
