"""Port of `repro.launch`: the serving driver (see the package
docstring)."""
