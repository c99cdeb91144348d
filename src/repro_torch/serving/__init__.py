"""Port of `repro.serving` (see the package docstring)."""
