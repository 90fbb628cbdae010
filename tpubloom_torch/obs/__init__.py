"""Part of tpubloom_torch (see the package docstring)."""
