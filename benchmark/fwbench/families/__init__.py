"""Model families, one module per family, named by a configuration file's
``reference`` key (as its plain reference in ``fwbench/references/`` is).

A family module gives the yardsticks that depend on the model's shapes:

- ``layout(model) -> {leaf: (shape, distribution)}``: the measured
  package's parameter tree for the configuration's ``model`` section, in
  leaf order (nested dicts and lists), each leaf's distribution one of
  four kinds, which ``fwbench/weights.py`` draws from the seed:

  - ``("uniform", a)``: U(-a, a);
  - ``("normal", (mean, sd))``: N(mean, sd²);
  - ``("orthogonal", None)``: for a leaf of shape ``(..., n, n)``, each
    trailing n x n matrix the Q of a QR of a standard-normal one, with
    det +1 (as ``glow.py``'s invertible 1x1 convolutions start);
  - ``("const", value)``: every element ``value``.

  Any other kind raises ``ValueError`` naming the leaf.
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
