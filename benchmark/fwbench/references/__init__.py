"""Plain references, one module per model family, named by a
configuration file's ``reference`` key."""

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")
