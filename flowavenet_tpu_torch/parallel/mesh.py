"""Process mesh, sharding rules and the local data mesh (twin of
``flowavenet_tpu/parallel/mesh.py``).

Training lays the processes of a ``torch.distributed`` run out as a 2-D
``(data, model)`` mesh, as the JAX package lays out its devices: rank =
d * model + m, one device per rank.  The batch is split on ``data`` (each
rank feeds its rows, gradients are averaged over the data group); the
parameters are replicated except the conditioning 1x1s whose input
channels reach ``TP_MIN_CIN``, which are split on ``model`` along Cin
(each rank computes its partial product, ``parallel/tp.py``).

Inference scales out inside one process instead: ``make_data_mesh``
holds N devices and one replica of the params per device, and the
synthesis entry points split their rows over it.

A leaf's sharding is a :class:`PartitionSpec` as in JAX: ``P()``
replicated, ``P(None, None, "model", None)`` split on dim 2.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch

from ..config import MeshConfig
from ..utils.tree import tree_map, tree_map_with_path

# Shard conditioning-conv inputs over 'model' once Cin reaches this size.
# Below it, the collective costs more than the matmul saves.
TP_MIN_CIN = 2048


class PartitionSpec:
    """A leaf's sharding in JAX's ``PartitionSpec`` form: one axis name
    (or None) per dim, no entries for a replicated leaf.  Not a tuple, so
    that the tree helpers take it as a leaf; it compares equal to the
    tuple (and to JAX's spec) of its entries."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = axes

    def __iter__(self):
        return iter(self.axes)

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __hash__(self):
        return hash(self.axes)

    def __repr__(self):
        return f"PartitionSpec{self.axes}"


P = PartitionSpec


def mesh_shape(cfg: MeshConfig, n: int) -> tuple[int, int]:
    """(data, model) extents for ``n`` devices, with the JAX package's
    errors for sizes that do not divide."""
    model = max(1, cfg.model_parallel)
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model}")
    data = cfg.data_parallel if cfg.data_parallel > 0 else n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} != {n} devices")
    return data, model


@dataclass
class ProcessMesh:
    """This rank's place in the (data, model) mesh of a run: ``shape``
    maps the axis names to their extents, in that order; ``data_group``
    holds the ranks that share this rank's model coordinate,
    ``model_group`` those that share its data coordinate (``None`` when the
    run is one process without ``torch.distributed``, where every
    collective is the identity)."""

    shape: dict
    rank: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    axes: tuple = field(default=("data", "model"))

    @property
    def n_data(self) -> int:
        return self.shape[self.axes[0]]

    @property
    def n_model(self) -> int:
        return self.shape[self.axes[1]]

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def distributed(self) -> bool:
        """Whether collectives run (a ``torch.distributed`` run, even of
        one process)."""
        return self.data_group is not None

    def rank_of(self, d: int, m: int) -> int:
        return d * self.n_model + m


def make_mesh(cfg: MeshConfig, device: str | torch.device = "cuda"
              ) -> ProcessMesh:
    """The mesh of the current run: every process of an initialized
    ``torch.distributed`` group (one, without it), laid out as JAX lays out
    devices.  Every rank must call it (it creates the axis groups).  A
    bare ``cuda`` is ``cuda:<LOCAL_RANK>``, this rank's card on its host;
    a CUDA device without CUDA raises."""
    import os

    import torch.distributed as dist

    from ..synthesis.synthesize import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    ready = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if ready else 1
    rank = dist.get_rank() if ready else 0
    data, model = mesh_shape(cfg, n)
    mesh = ProcessMesh({cfg.data_axis: data, cfg.model_axis: model}, rank,
                       dev, axes=(cfg.data_axis, cfg.model_axis))
    if ready:
        # every rank creates every group, in one order
        for m in range(model):
            g = dist.new_group([mesh.rank_of(d, m) for d in range(data)])
            if m == mesh.model_index:
                mesh.data_group = g
        for d in range(data):
            g = dist.new_group([mesh.rank_of(d, m) for m in range(model)])
            if d == mesh.data_index:
                mesh.model_group = g
    return mesh


def batch_sharding(mesh: ProcessMesh, cfg: MeshConfig,
                   keys=("audio", "mel")) -> dict:
    """Shard the batch dim over 'data' for every input field."""
    return {k: P(cfg.data_axis) for k in keys}


def param_sharding(params: Any, mesh: ProcessMesh, cfg: MeshConfig) -> Any:
    """Replicate everything except big cond-conv kernels (TP on 'model'),
    by the JAX package's rule: a leaf whose path ends in ``['v']``, of
    rank 4 ([n_flow, K, Cin, Cout]), with Cin >= TP_MIN_CIN and divisible
    by the model extent is split on Cin.  Reads the full (unsharded)
    shapes."""
    n_model = mesh.shape[cfg.model_axis]
    tp = P(None, None, cfg.model_axis, None)

    def rule(path, leaf):
        if (n_model > 1 and path.endswith("['v']") and leaf.dim() == 4
                and leaf.shape[2] >= TP_MIN_CIN
                and leaf.shape[2] % n_model == 0):
            return tp
        return P()

    return tree_map_with_path(rule, params)


def replicated(tree: Any, mesh: ProcessMesh) -> Any:
    return tree_map(lambda _: P(), tree)


class DataMesh:
    """N devices of one process for data-parallel inference, in place of
    the JAX package's ``NamedSharding`` over a data axis.  Devices may
    repeat (``["cuda:0", "cuda:0"]``), which splits the rows without
    several cards.  ``replicas(params)`` gives one copy of the params per
    device, made once per params object and kept."""

    def __init__(self, devices: Sequence):
        from ..synthesis.synthesize import resolve_device
        if not devices:
            raise ValueError("a data mesh needs at least one device")
        self.devices = [resolve_device(d) for d in devices]
        self._params = None
        self._replicas: list = []

    @property
    def size(self) -> int:
        return len(self.devices)

    def replicas(self, params) -> list:
        if params is not self._params:
            self._replicas = [tree_map(lambda l: l.to(d), params)
                              for d in self.devices]
            self._params = params
        return self._replicas


def make_data_mesh(devices: Sequence) -> DataMesh:
    return DataMesh(devices)
