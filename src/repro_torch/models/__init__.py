"""Port of `repro.models` for the attention stack (see the package
docstring)."""
