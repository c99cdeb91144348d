"""Self-healing serving for the port: deterministic fault injection and
the recovery ladder (the port of ``repro.resilience``).

* :mod:`repro_torch.resilience.faults` — a seeded, deterministic
  :class:`FaultPlan` that injects dropped pokes, counter corruption,
  double block releases, NaN model poison, stuck slots and mid-megastep
  crashes, identically on the host ``step()`` path and the megastep path;
* :mod:`repro_torch.resilience.recovery` — the :class:`ResilientEngine`
  wrapper that reads the health stream at deterministic reaction
  boundaries and escalates through the recovery ladder: quarantine →
  audit-and-rebuild → kernel fallback → snapshot/restore with replay.
"""

from .faults import (  # noqa: F401
    BIT_FLIP,
    CAPACITY_KINDS,
    CLUSTER_KINDS,
    CORRUPTION_KINDS,
    CRASH,
    DOUBLE_RELEASE,
    DROP_POKE,
    FaultEvent,
    FaultPlan,
    InjectedCrash,
    KV_COUNTER,
    KV_PARTITION,
    LEASE_LEAK,
    NAN_LOGIT,
    REPLICA_KILL,
    STRAGGLER,
    STUCK_SLOT,
    TORN_SHARD,
    apply_fault,
    tear_checkpoint,
)
from .recovery import ResilientEngine, exit_audit  # noqa: F401
