"""Multi-process initialization, input placement and the collectives of
the training step (twin of ``flowavenet_tpu/parallel/multihost.py``).

Every process runs the same program on its own device: it draws the same
global batch (counter-based sampling), keeps the rows of its data
coordinate (``host_batch_slice``), and holds the full parameters except
its shard of the tensor-parallel leaves (``put_tree``).  The collectives
use ``all_reduce`` and ``broadcast`` only, which gloo supports on CUDA
tensors as NCCL does; a gather is one broadcast per shard.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import leaves, tree_map, tree_map_with_path
from .mesh import ProcessMesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: str | torch.device = "cuda") -> bool:
    """Join the run's process group: ``nccl`` on a CUDA device and
    ``gloo`` on the CPU unless ``backend`` says otherwise.  Without an
    address, torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) is read (``env://``); an address is
    ``host:port`` of process 0.  A no-op for one process and when the
    group exists; returns whether a group is up."""
    if dist.is_initialized():
        return True
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if num_processes is None and coordinator_address is None:
        num_processes = int(os.environ["WORLD_SIZE"]) if env else 1
    if num_processes is not None and num_processes <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        if not env:
            raise ValueError("no coordinator_address and no RANK/WORLD_SIZE "
                             "in the environment (torchrun sets them)")
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and "
                             "process_id")
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        dist.init_process_group(backend, init_method=addr,
                                world_size=num_processes, rank=process_id)
    return True


def host_batch_slice(global_batch: int,
                     mesh: Optional[ProcessMesh] = None) -> slice:
    """Rows of the global batch this rank feeds: those of its data
    coordinate (ranks that differ only in their model coordinate feed the
    same rows).  Without a mesh, every process is one data coordinate."""
    if mesh is not None:
        n, i = mesh.n_data, mesh.data_index
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def make_global_batch(batch: dict, mesh: ProcessMesh) -> dict:
    """This rank's rows (numpy, from ``host_batch_slice``) on its device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                mesh.device, non_blocking=True)
            for k, v in batch.items()}


def _model_dim(spec) -> Optional[int]:
    """The dim a spec splits (on the model axis), or None (replicated)."""
    for i, a in enumerate(spec):
        if a is not None:
            return i
    return None


def _each_dtype(tensors: list, op) -> None:
    """Run ``op`` on one flat buffer per dtype of ``tensors`` and copy the
    result back into them (one collective per dtype, not per tensor)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        op(flat)
        off = 0
        for t in ts:
            t.copy_(flat[off: off + t.numel()].view_as(t))
            off += t.numel()


def put_tree(tree: Any, mesh: ProcessMesh, specs: Any) -> Any:
    """Place a full tree (the train state, every rank holding the same
    values) on this rank's device, keeping its shard of each leaf whose
    spec splits a dim on the model axis.  Rank 0's values are broadcast
    first, so every rank starts from the same bits."""
    tree = tree_map(lambda l: l.to(mesh.device).clone(), tree)
    if mesh.distributed:
        _each_dtype(leaves(tree), lambda f: dist.broadcast(f, src=0))

    def place(leaf, spec):
        dim = _model_dim(spec)
        if dim is None or mesh.n_model == 1:
            return leaf
        n = leaf.shape[dim] // mesh.n_model
        return leaf.narrow(dim, mesh.model_index * n, n).contiguous()

    return tree_map(place, tree, specs)


def gather_tree(tree: Any, mesh: ProcessMesh, specs: Any) -> Any:
    """The full one-device layout of a tree that ``put_tree`` sharded: each
    split leaf rebuilt from every model rank's shard (one broadcast per
    shard, a collective on every rank of the model group); other leaves
    as they are."""
    def gather(leaf, spec):
        dim = _model_dim(spec)
        if dim is None or mesh.n_model == 1:
            return leaf
        parts = []
        for m in range(mesh.n_model):
            part = (leaf.clone() if m == mesh.model_index
                    else torch.empty_like(leaf))
            dist.broadcast(part, src=mesh.rank_of(mesh.data_index, m),
                           group=mesh.model_group)
            parts.append(part)
        return torch.cat(parts, dim)

    return tree_map(gather, tree, specs)


def data_mean_(tensors: list, mesh: ProcessMesh) -> None:
    """Average ``tensors`` in place over the data group (sum, then divide
    by the extent: gloo has no average)."""
    if not mesh.distributed:
        return

    def op(flat):
        dist.all_reduce(flat, group=mesh.data_group)
        flat /= mesh.n_data

    _each_dtype(tensors, op)


def data_max_(tensor: torch.Tensor, mesh: ProcessMesh) -> None:
    if mesh.distributed:
        dist.all_reduce(tensor, op=dist.ReduceOp.MAX, group=mesh.data_group)


def model_sum_(tensor: torch.Tensor, mesh: ProcessMesh) -> None:
    if mesh.distributed and mesh.n_model > 1:
        dist.all_reduce(tensor, group=mesh.model_group)


def sharded_paths(specs: Any) -> list[str]:
    """Paths of the leaves a spec tree splits."""
    out: list = []
    tree_map_with_path(lambda p, s: out.append(p) if _model_dim(s) is not None
                       else None, specs)
    return out


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()

