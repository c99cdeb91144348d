"""Port of `repro.parallel`: the single-device train step
(`parallel.steps`)."""
