"""Port of `repro.data`: the synthetic corpus and the TWA-buffered loader
(`data.pipeline`)."""
