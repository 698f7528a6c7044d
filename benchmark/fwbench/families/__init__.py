"""Model families, one module per family, named by a configuration file's
``reference`` key (as its plain reference in ``fwbench/references/`` is).

A family module gives the yardsticks that depend on the model's shapes:

- ``layout(model) -> {leaf: (shape, distribution)}``: the measured
  package's parameter tree for the configuration's ``model`` section, in
  leaf order (nested dicts and lists), each leaf's distribution as
  ``("uniform", a)`` for U(-a, a), ``("normal", (mean, sd))`` or
  ``("const", value)``; ``fwbench/weights.py`` draws it from the seed.
- ``model_flops(model, samples, rows) -> float``: the FLOPs of one pass
  over ``samples`` audio samples in ``rows`` utterances, by the counting
  rules at the top of ``fwbench/flops.py``.

A new family adds its module here and its reference beside the others;
nothing else names a family.
"""

from __future__ import annotations

import importlib
from pathlib import Path


def of(config: dict):
    """The family module that a configuration file's ``reference`` key
    names; there is no default family."""
    name = config["reference"]
    path = Path(__file__).with_name(f"{name}.py")
    if not path.is_file():
        raise FileNotFoundError(f"no model family {name!r}: {path} not found")
    return importlib.import_module(f"{__name__}.{name}")
