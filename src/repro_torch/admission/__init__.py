"""Port of `repro.admission` (see the package docstring)."""
