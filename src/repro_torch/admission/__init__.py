"""Port of `repro.admission`.  Multi-tenant QoS admission — the paper's
TWA semaphore as a production admission stack.

Module map (file → paper construct → what it adds):

  ``cancellable.py``
      Paper construct: Listing 1/2's ticket+grant sequence, which cannot
      natively revoke an issued ticket.  Adds: the **tombstone protocol**
      host API — deadline/timeout takes and externally-cancellable take
      handles over ``core.twa_semaphore``'s skip-aware post (an abandoning
      waiter marks its ticket dead; posts re-advance Grant past dead
      tickets so FCFS among *live* waiters is exact).

  ``hierarchical.py``
      Paper construct: the process-global waiting array (§1) and the
      successor-poke of SemaPost (Listing 2).  Adds: a **two-level
      weighted semaphore tree** — root = conserved global slot pool,
      leaves = per-tenant TWA semaphores sharing ONE waiting array, so a
      release pokes O(freed-slots) buckets regardless of tenant count.
      Freed slots are replenished to leaves by stride scheduling
      (pass += 1/weight), converging admission shares to QoS weights
      under saturation while staying work-conserving.

  ``functional_qos.py``
      Paper construct: the batched in-graph adaptation begun by
      ``core.functional`` (MultiSemaState).  Adds: per-tenant **weights**,
      **deadline masks**, and the batched tombstone-skip
      (``live_fifo_rank``) so one tensor pass runs a whole multi-tenant
      admission round (expire → weighted replenish → FCFS admit →
      reclaim) — the plain version of the fused CUDA kernel
      ``kernels/qos_admission.qos_round_fused`` (``csrc/qos_admission.cu``,
      bit-exact on the card).  Both paths use closed-form stride
      allocation (``stride_alloc``) and the coprime-stride permutation
      poke (``poke_bump``).

Integration points: ``serving.scheduler.ContinuousBatchingEngine``
(``tenants=`` routes admission through the functional QoS state;
``Request`` carries ``tenant_id``/``deadline``) and
``runtime.coordinator.DistributedTicketLease`` (cancellable acquire with
KV tombstones, so a dying host never wedges the cluster grant sequence).
"""

from .cancellable import (
    CancellableTake,
    CancelStats,
    take_with_deadline,
    take_with_timeout,
)
from .functional_qos import (
    QoSState,
    make_qos,
    poke_bump,
    qos_admit,
    qos_bucket_index,
    qos_expire,
    qos_reclaim,
    qos_replenish,
    qos_round,
    qos_scan_round,
    qos_take,
    stride_alloc,
)
from .hierarchical import HierarchicalTWASemaphore

__all__ = [
    "CancellableTake",
    "CancelStats",
    "take_with_deadline",
    "take_with_timeout",
    "HierarchicalTWASemaphore",
    "QoSState",
    "make_qos",
    "qos_take",
    "qos_expire",
    "qos_admit",
    "qos_replenish",
    "qos_reclaim",
    "qos_round",
    "qos_scan_round",
    "qos_bucket_index",
    "stride_alloc",
    "poke_bump",
]
