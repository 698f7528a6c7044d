"""Uniform parsing for FWN_* env knobs (copy of
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


def env_float(name: str, default: float, *, positive: bool = True) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    val = float(raw)
    if positive and val <= 0.0:
        raise ValueError(f"{name}={val}: must be positive")
    return val


def env_int(name: str, default: int, *, multiple_of: int = 1) -> int:
    """Integer env knob, validated when it is read."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    val = int(raw)
    if val % multiple_of != 0 or val <= 0:
        raise ValueError(
            f"{name}={val}: must be a positive multiple of {multiple_of}")
    return val


# The int8 pair-kernel route, on by default as in the JAX package.
# FWN_INT8=0 runs the pair kernel in the storage dtype instead.
INT8 = env_flag("FWN_INT8", default=True)
# Reverse-pair route switches, with the JAX package's defaults
# (flowavenet_tpu/models/flowavenet.py:326-365, ops/pallas_flow.py:112):
# Winograd F(2,3) pairs on blocks with cc_half <= FWN_WINO_MAX_CC when the
# int8 route does not take them (F(4,3) with FWN_WINO4); FWN_MAX_CC (0 =
# unset) overrides the fused-pair width bound; FWN_HOISTED routes the
# deep blocks through the hoisted-conditioning pair; FWN_INT8_RS adds int8
# res/skip products to the int8 pair.
WINO = env_flag("FWN_WINO", default=True)
WINO4 = env_flag("FWN_WINO4")
WINO_MAX_CC = env_int("FWN_WINO_MAX_CC", 320)
MAX_CC = env_int("FWN_MAX_CC", 0)
HOISTED = env_flag("FWN_HOISTED")
INT8_RS = env_flag("FWN_INT8_RS")
# Training routes (off by default, as in the JAX package): the fused
# training pair (forward with log_s statistics + hand-written backward) on
# blocks whose conditioning half is at most FWN_TRAIN_MAX_CC wide, and the
# fused forward pair (torch-recompute backward) up to FWN_FWD_MAX_CC.
TRAIN_KERNEL = env_flag("FWN_TRAIN_KERNEL", default=False)
TRAIN_MAX_CC = env_int("FWN_TRAIN_MAX_CC", 80)
FWD_KERNEL = env_flag("FWN_FWD_KERNEL", default=False)
FWD_MAX_CC = env_int("FWN_FWD_MAX_CC", 640)
# Dead-zone margin of the log_s hinge guard (TrainConfig.logs_hinge).
HINGE_MARGIN = env_float("FWN_HINGE_MARGIN", 5.0)
