"""Optimizer: global-norm clipping, Adam and a piecewise-constant LR
(twin of ``flowavenet_tpu/training/optimizer.py``), written out by hand so
that it computes what the JAX package's optax chain computes:

* ``clip_by_global_norm``: gradients unchanged when their global norm is
  below the maximum, else ``g / norm * max`` (not
  ``torch.nn.utils.clip_grad_norm_``, which always rescales by
  ``min(1, max / (norm + 1e-6))``);
* ``scale_by_adam``: bias-corrected moments, eps outside the sqrt;
* ``scale_by_learning_rate``: times ``-lr(count)``, its own count from 0.

The state has optax's layout, ``(EmptyState(), ScaleByAdamState(count, mu,
nu), ScaleByScheduleState(count))``, so checkpoints carry over between the
packages leaf for leaf.  Everything stays on the device: counts are int32
0-d tensors, and nothing is read back to the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..config import TrainConfig
from ..utils.tree import leaves, tree_map


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor      # int32 scalar


def lr_schedule(cfg: TrainConfig):
    """step (int32 tensor) -> fp32 learning rate: lr, divided at each
    (boundary, divisor) once step >= boundary."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        lr = torch.full((), cfg.learning_rate, dtype=torch.float32,
                        device=step.device)
        for boundary, divisor in cfg.lr_boundaries:
            lr = torch.where(step < boundary, lr, torch.tensor(
                cfg.learning_rate / divisor, dtype=torch.float32,
                device=step.device))
        return lr
    return schedule


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (fp32).  With a mesh, the
    leaves that ``specs`` split on the model axis are this rank's shards:
    their squares are summed over the model group."""
    sq = [(l.float() * l.float()).sum() for l in leaves(tree)]
    split = ([any(a is not None for a in s) for s in leaves(specs)]
             if mesh is not None and mesh.n_model > 1 else [])
    if not any(split):
        return torch.sqrt(sum(sq))
    from ..parallel.multihost import model_sum_
    part = sum(q for q, s in zip(sq, split) if s)
    model_sum_(part, mesh)
    return torch.sqrt(sum(q for q, s in zip(sq, split) if not s) + part)


class Optimizer:
    """The chain clip -> Adam -> LR, with optax's ``init``/``update``.
    ``mesh`` and ``specs`` (the params' shardings) make the clip's norm
    span every shard; Adam is elementwise on each."""

    def __init__(self, cfg: TrainConfig, mesh=None, specs=None):
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        self.norm = lambda tree: global_norm(tree, specs, mesh)

    def init(self, params) -> tuple:
        dev = leaves(params)[0].device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (EmptyState(),
                ScaleByAdamState(zero.clone(),
                                 tree_map(torch.zeros_like, params),
                                 tree_map(torch.zeros_like, params)),
                ScaleByScheduleState(zero.clone()))

    def update(self, grads, state: tuple, params=None):
        """(updates, new_state); params are not read (as in optax)."""
        cfg = self.cfg
        _, adam, sched = state
        # clip_by_global_norm
        g_norm = self.norm(grads)
        trigger = g_norm < cfg.grad_clip_norm
        grads = tree_map(lambda t: torch.where(
            trigger, t, (t / g_norm.to(t.dtype)) * cfg.grad_clip_norm), grads)
        # scale_by_adam
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, adam.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      adam.nu)
        count = adam.count + 1
        cf = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=cf.device), cf)
        updates = tree_map(
            lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + cfg.adam_eps),
            mu, nu)
        # scale_by_learning_rate
        step_size = -self.schedule(sched.count)
        updates = tree_map(lambda u: step_size * u, updates)
        return updates, (EmptyState(), ScaleByAdamState(count, mu, nu),
                         ScaleByScheduleState(sched.count + 1))


def make_optimizer(cfg: TrainConfig, mesh=None, specs=None) -> Optimizer:
    return Optimizer(cfg, mesh, specs)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
