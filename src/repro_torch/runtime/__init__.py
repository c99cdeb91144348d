"""Port of `repro.runtime`: the coordinator (`runtime.coordinator`)."""
