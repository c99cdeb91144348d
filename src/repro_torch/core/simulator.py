"""Discrete-event simulator with an explicit cache-coherence cost model.

Why this exists: this container is a 1-core CPython box — the paper's central
empirical claim (global spinning's coherence storms make Ticket-Semaphore
fade with thread count while TWA stays flat, Figure 1) is about *parallel
hardware* and cannot be measured here.  We therefore reproduce it in a
calibrated discrete-event model and validate the *claims*, not just run the
code:

  C1  at 1 thread, Ticket ≈ TWA (identical fast paths);
  C2  throughput dips from 1 → 2 threads (communication costs precede
      parallelism benefits);
  C3  under contention, Ticket-Semaphore throughput decays ~1/T while
      TWA-Semaphore stays ~flat (global spinning vs ≤threshold spinners);
  C4  pthread-like pays wakeup latency but benefits from barging; its
      *admission order* is never FIFO (even though the kernel sleep queue
      itself wakes FIFO — the unfairness comes from bargers, not the
      wake discipline).

Model (times in ns; defaults roughly an Oracle X5-2-class 2-socket Xeon):
  * each thread loops: take → CS(c) → post → NCS(n)   (semabench, count=1)
  * handover cost at post time:
      ticket : h = base + coh·S        S = #threads spinning on Grant (= all
                                       waiters) — invalidation storm
      twa    : h = base + coh·S_short  S_short = min(waiters, threshold);
               the bucket poke (successor's successor staging) runs in
               parallel with the successor's CS — it adds to the critical
               path only if the staged thread is reached sooner than the
               poke+refetch completes (modelled via stage_lag)
      pthread: non-FIFO barging — post makes the permit available and (if
               sleepers exist) pays a futex-wake syscall; a thread finishing
               its NCS barges and grabs the permit long before the wakee
               arrives (wake_ns later), so wakeups are mostly futile and the
               semaphore is monopolized by few threads: throughput stays
               near the single-thread level but admission is unfair
               (max_queue / futile_wakeups expose the starvation).
  * hash collisions in a TableSize-bucket array add futile re-checks for TWA
    (coherence cost off the critical path; counted, reported).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field


@dataclass
class SimParams:
    cs_ns: float = 60.0  # CS: advance shared PRNG 1 step (cache-hot)
    ncs_ns: float = 60.0  # NCS: advance private PRNG 1 step
    base_ns: float = 40.0  # uncontended handover (one line transfer)
    coh_ns: float = 35.0  # per-spinner invalidation-storm cost
    wake_ns: float = 4000.0  # kernel wake latency (futex/park)
    futex_wake_syscall_ns: float = 400.0  # poster-side futex_wake entry cost
    stage_lag_ns: float = 150.0  # poke + bucket refetch + shift to Grant spin
    long_term_threshold: int = 1
    table_size: int = 2048
    numa_ns: float = 20.0  # extra per-spinner cost once threads span sockets
    numa_at: int = 16  # thread count where the scheduler spills sockets
    duration_ns: float = 2e7


@dataclass
class SimResult:
    policy: str
    threads: int
    iterations: int
    throughput_per_sec: float
    futile_wakeups: int = 0
    max_queue: int = 0
    # pthread only: park/wake orders of the kernel sleep queue.  The queue
    # discipline is FIFO (futex wait-queues wake oldest-first); the *admission*
    # unfairness of the pthread baseline comes from barging, not wake order.
    park_order: list = field(default_factory=list)
    wake_order: list = field(default_factory=list)


@dataclass(order=True)
class _Ev:
    t: float
    seq: int
    kind: str = field(compare=False)
    tid: int = field(compare=False)


def simulate(policy: str, threads: int, p: SimParams | None = None) -> SimResult:
    """Simulate semabench for one (policy, thread-count) point."""
    assert policy in ("ticket", "twa", "pthread")
    p = p or SimParams()
    heap: list[_Ev] = []
    seq = 0

    def push(t, kind, tid):
        nonlocal seq
        heapq.heappush(heap, _Ev(t, seq, kind, tid))
        seq += 1

    # Semaphore state: count=1 (used as a lock, per the paper's benchmark).
    available = 1
    fifo: list[int] = []  # waiting tickets in order (ticket/twa)
    # Parked threads (pthread): FIFO wake order — futex wait-queues hand out
    # wakeups oldest-first.  The baseline's unfairness is NOT here: it comes
    # from barging (a running thread grabs the permit before the wakee
    # arrives), which tests assert via max_queue / futile_wakeups.
    parked: list[int] = []
    park_order: list[int] = []
    wake_order: list[int] = []
    iterations = 0
    futile = 0
    max_queue = 0
    # staged[tid] = time at which tid finished shifting to short-term spin
    staged: dict[int, float] = {}

    def coh_cost(nspin: int) -> float:
        per = p.coh_ns + (p.numa_ns if threads >= p.numa_at else 0.0)
        return p.base_ns + per * nspin

    def handover(now: float) -> tuple[int, float] | None:
        """Pick the next owner and compute when it enters the CS (FIFO
        policies only; pthread uses availability + barging instead)."""
        nonlocal futile
        if not fifo:
            return None
        tid = fifo.pop(0)
        waiters = len(fifo) + 1
        if policy == "ticket":
            return tid, now + coh_cost(waiters)  # everyone spins on Grant
        # twa: ≤ threshold short-term spinners; successor must be staged.
        nspin = min(waiters, p.long_term_threshold)
        t_enter = now + coh_cost(nspin)
        st = staged.get(tid)
        if st is None or st > now:
            # Successor not yet staged (deep queue moved faster than pokes,
            # or a hash collision poked the wrong bucket first) — pay the
            # staging lag on the critical path.
            t_enter = max(t_enter, (st or now) + p.stage_lag_ns)
            futile += 1
        # Stage the *next* waiter now (successor's successor poke), in
        # parallel with the new owner's CS.
        if fifo:
            staged[fifo[0]] = now + p.stage_lag_ns
        return tid, t_enter

    # Threads all call take() at t≈0 (slight skew for determinism).
    for tid in range(threads):
        push(tid * 1.0, "take", tid)

    now = 0.0
    while heap:
        ev = heapq.heappop(heap)
        now = ev.t
        if now > p.duration_ns:
            break
        if ev.kind in ("take", "wakeup"):
            if policy == "pthread":
                if available > 0:
                    available -= 1
                    push(now + p.base_ns + p.cs_ns, "post", ev.tid)
                else:
                    if ev.kind == "wakeup":
                        futile += 1  # a barger beat the wakee to the permit
                    parked.append(ev.tid)
                    park_order.append(ev.tid)
                    max_queue = max(max_queue, len(parked))
            elif available > 0 and not fifo:
                available -= 1
                push(now + p.cs_ns, "post", ev.tid)  # straight into CS
            else:
                fifo.append(ev.tid)
                if policy == "twa" and len(fifo) <= p.long_term_threshold:
                    staged[ev.tid] = now  # arrives already short-term
                max_queue = max(max_queue, len(fifo))
        elif ev.kind == "post":
            iterations += 1
            if policy == "pthread":
                available += 1
                extra = 0.0
                if parked:
                    # futex_wake syscall on the poster's path; FIFO pop —
                    # the oldest sleeper is woken.  The wakee arrives
                    # wake_ns later (and usually loses to a barger).
                    wakee = parked.pop(0)
                    wake_order.append(wakee)
                    push(now + p.wake_ns, "wakeup", wakee)
                    extra = p.futex_wake_syscall_ns
                push(now + extra + p.ncs_ns, "take", ev.tid)
                continue
            nxt = handover(now)
            if nxt is None:
                available += 1
            else:
                tid, t_enter = nxt
                push(t_enter + p.cs_ns, "post", tid)
            push(now + p.ncs_ns, "take", ev.tid)  # poster does NCS then loops

    return SimResult(
        policy=policy,
        threads=threads,
        iterations=iterations,
        throughput_per_sec=iterations / (min(now, p.duration_ns) * 1e-9) if now > 0 else 0.0,
        futile_wakeups=futile,
        max_queue=max_queue,
        park_order=park_order,
        wake_order=wake_order,
    )


def sweep(policies=("ticket", "twa", "pthread"), thread_counts=(1, 2, 4, 8, 16, 32, 64), p: SimParams | None = None):
    return {pol: [simulate(pol, t, p) for t in thread_counts] for pol in policies}
