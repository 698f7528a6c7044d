"""Tensor parallelism of the conditioning 1x1s (the compute behind
``parallel/mesh.py:param_sharding``'s rule).

Inside ``tensor_parallel(mesh)`` with a model extent > 1, a conditioning
kernel whose ``v`` holds 1/M of the input channels is a shard: the rank
multiplies its Cin slice of the input by it and the partial products are
summed over the model group.  Two autograd functions carry the
collectives (Megatron-LM's f and g):

* :func:`copy_to_model`: identity forward, ``all_reduce`` of the gradient
  backward.  It sits where a replicated tensor enters the rank's partial
  computation (the input before it is sliced, the weight norm's scale), so
  that its gradient is whole on every model rank;
* :func:`reduce_from_model`: ``all_reduce`` forward, identity backward.
  It sits on the partial product and on the partial sum of squares of
  the weight norm, which runs over K and Cin.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

# (model group, model index, model extent) while tensor_parallel is active
_ACTIVE: Optional[tuple] = None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


@contextlib.contextmanager
def tensor_parallel(mesh):
    """Run the model's conditioning 1x1s on this rank's shards of ``mesh``
    (a no-op without a mesh or at model extent 1)."""
    global _ACTIVE
    prev = _ACTIVE
    if mesh is not None and mesh.n_model > 1:
        _ACTIVE = (mesh.model_group, mesh.model_index, mesh.n_model)
    try:
        yield
    finally:
        _ACTIVE = prev


def shard_of(cin: int, v_cin: int) -> Optional[tuple]:
    """``(group, index)`` when a kernel of ``v_cin`` input channels is this
    rank's shard of a ``cin``-channel input, None when it is whole; a
    shard outside ``tensor_parallel`` raises (it never runs unsharded)."""
    if cin == v_cin:
        return None
    if _ACTIVE is not None and v_cin * _ACTIVE[2] == cin:
        return _ACTIVE[0], _ACTIVE[1]
    raise ValueError(
        f"conditioning kernel with {v_cin} input channels on a {cin}-channel "
        "input: a tensor-parallel shard runs only inside "
        "tensor_parallel(mesh) of its model extent")
