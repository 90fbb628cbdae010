"""The yardstick: the frozen hash spec, the plain references and the byte arithmetic."""

import importlib


def family(name: str):
    """The reference module a configuration names (``reference/<name>.py``)."""
    return importlib.import_module(f"perfbench.reference.{name}")
