"""Port of `repro.configs`: copies of the config dataclasses and the
registry (see the package docstring)."""
