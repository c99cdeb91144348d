"""Port of `repro.optim`: AdamW on one device (`optim.adamw`)."""
