"""The synthesis routes: which reverse pair kernel each block runs, set by
the module switches of ``models/flowavenet.py`` that the ``FWN_*``
environment knobs initialise (``utils/flags.py``).

``ROUTES`` is the one table of them.  ``chip_smoke.py`` drives every
route at lj22k and checks the launches per reverse given here;
``quality_gate.py`` scores every route against the plain route
(``use_pallas=False``, the JAX gate's "xla") on trained weights.  A
route's switches are applied over ``ROUTE_BASE``, the switches'
defaults, so a route names the same kernels whatever the environment
sets.
"""

from __future__ import annotations

import contextlib

# (name, model switches, launches per lj22k reverse)
ROUTES = (
    ("int8", {}, {"pair_flow_i8": 15}),
    ("FWN_INT8=0", {"PAIR_KERNEL_INT8": False},
     {"pair_flow_wino": 9, "pair_flow": 3}),
    ("FWN_INT8=0 FWN_WINO4=1", {"PAIR_KERNEL_INT8": False,
                                "PAIR_KERNEL_WINO4": True},
     {"pair_flow_wino4": 9, "pair_flow": 3}),
    ("FWN_INT8=0 FWN_HOISTED=1", {"PAIR_KERNEL_INT8": False,
                                  "PAIR_KERNEL_HOISTED": True},
     {"pair_flow_wino": 9, "pair_flow": 3, "pair_flow_hoisted": 12}),
    ("FWN_HOISTED=1", {"PAIR_KERNEL_HOISTED": True},
     {"pair_flow_i8": 15, "pair_flow_hoisted_i8": 9}),
    ("FWN_INT8_RS=1", {"INT8_RS": True}, {"pair_flow_i8rs": 15}),
)
# the route switches' defaults (utils/flags.py), under every route
ROUTE_BASE = {"PAIR_KERNEL_INT8": True, "PAIR_KERNEL_WINO": True,
              "PAIR_KERNEL_WINO4": False, "PAIR_KERNEL_HOISTED": False,
              "INT8_RS": False}


def route_switches(route: str) -> dict:
    """The switches of a route of ``ROUTES`` over ``ROUTE_BASE``;
    ``plain`` has none (its config sets use_pallas=False)."""
    if route == "plain":
        return {}
    table = {r[0]: r[1] for r in ROUTES}
    if route not in table:
        raise ValueError(f"unknown route {route!r}; routes: plain, "
                         + ", ".join(table))
    return {**ROUTE_BASE, **table[route]}


def route_patches(route: str) -> list:
    """The switches of ``route`` as (module, attribute, value) patches."""
    from ..models import flowavenet as fwn
    return [(fwn, k, v) for k, v in route_switches(route).items()]


def int8_route(route: str) -> bool:
    """Whether ``route`` runs the int8 pairs (the default route's family)."""
    return route_switches(route).get("PAIR_KERNEL_INT8", False)


@contextlib.contextmanager
def patched(patches):
    """Each (object, attribute, value) of ``patches`` set for the body, the
    old values put back after it."""
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    try:
        for o, a, v in patches:
            setattr(o, a, v)
        yield
    finally:
        for o, a, v in reversed(saved):
            setattr(o, a, v)
