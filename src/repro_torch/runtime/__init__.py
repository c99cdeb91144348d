"""Port of `repro.runtime`: the coordinator (`runtime.coordinator`) and the
lease-heartbeat reaper (`runtime.reaper`)."""

from .reaper import LeaseReaper, ReapAction, leases_clean

__all__ = ["LeaseReaper", "ReapAction", "leases_clean"]
