"""Port of `repro.core`.  The paper's primary contribution: semaphores
augmented with a waiting array.

L1 (host threads, faithful listings):
  TicketSemaphore            — Listing 1 (ticket/grant, global spinning)
  TWASemaphore               — Listing 2 (waiting array of UpdateSequence buckets)
  TWASemaphoreChains         — Listing 3 (lock-free pop-stack chains + park/unpark)
  TWASemaphoreChannels       — Listing 4 (MONITOR-MWAIT-style Key* channels)
  TWASemaphoreV3             — Listing 5 (LocationWait, TLS deferred elements)
  PthreadLikeSemaphore       — the paper's non-FIFO `pthread` baseline

L2 (batched tensor adaptation): core.functional (SemaState, take_batch,
post_batch, MultiSemaState …) — see kernels/sema_batch for the CUDA form
(csrc/sema_batch.cu); counters are u32 carriers (core.u32).

Validation of the paper's empirical claims on this 1-core box:
  core.simulator — discrete-event coherence-cost model (Figure 1).
"""

from .channels import TWASemaphoreChannels
from .eventcount import EventCount, Sequencer, TicketMutex
from .functional import (
    MultiSemaState,
    SemaState,
    make_multi_sema,
    make_sema,
    poll,
    post_batch,
    post_batch_multi,
    take_batch,
    take_batch_multi,
    woken_mask,
)
from .location_wait import TWASemaphoreV3, tls_cleanup
from .pthread_like import PthreadLikeSemaphore
from .simulator import SimParams, simulate, sweep
from .ticket_semaphore import TicketSemaphore
from .twa_semaphore import TWASemaphore, WaitingArray
from .waiting_chains import TWASemaphoreChains

SEMAPHORE_KINDS = {
    "ticket": TicketSemaphore,
    "twa": TWASemaphore,
    "twa-chains": TWASemaphoreChains,
    "twa-channels": TWASemaphoreChannels,
    "twa-v3": TWASemaphoreV3,
    "pthread": PthreadLikeSemaphore,
}

__all__ = [
    "EventCount",
    "Sequencer",
    "TicketMutex",
    "TicketSemaphore",
    "TWASemaphore",
    "WaitingArray",
    "TWASemaphoreChains",
    "TWASemaphoreChannels",
    "TWASemaphoreV3",
    "PthreadLikeSemaphore",
    "SEMAPHORE_KINDS",
    "SemaState",
    "MultiSemaState",
    "make_sema",
    "make_multi_sema",
    "take_batch",
    "post_batch",
    "poll",
    "woken_mask",
    "take_batch_multi",
    "post_batch_multi",
    "SimParams",
    "simulate",
    "sweep",
    "tls_cleanup",
]
