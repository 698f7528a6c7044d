"""Uniform parsing for FWN_* boolean env knobs (copy of
``flowavenet_tpu/utils/flags.py``, so both packages read the same knobs the
same way).

All boolean knobs accept 1/0, true/false, yes/no, on/off — so
``FWN_INT8=0`` DISABLES the flag (a plain ``bool(os.environ.get(...))``
would enable it).
"""

from __future__ import annotations

import os

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}


def env_flag(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    val = raw.strip().lower()
    if val in _TRUE:
        return True
    if val in _FALSE:
        return False
    raise ValueError(
        f"{name}={raw!r}: expected a boolean (1/0, true/false, yes/no)")


# The int8 pair-kernel route, on by default as in the JAX package.
# FWN_INT8=0 runs the pair kernel in the storage dtype instead.
INT8 = env_flag("FWN_INT8", default=True)
