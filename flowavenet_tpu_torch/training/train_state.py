"""Train state and the train/eval steps (twin of
``flowavenet_tpu/training/train_state.py``).

bf16 compute with fp32 params and optimizer state; the step is one
autograd pass, the clip -> Adam -> LR update, the divergence metrics and
the non-finite skip, all on the device with no host readback.  With a
process mesh (``parallel/mesh.py``) each rank runs its rows of the global
batch: the gradients, the loss and the metrics are averaged over the data
group before the skip decision, so every rank takes the same one, and the
conditioning 1x1s that the specs split run tensor-parallel.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..config import Config
from ..models import flowavenet as fwn
from ..parallel.multihost import data_max_, data_mean_, sharded_paths
from ..parallel.tp import tensor_parallel
from ..utils.tree import leaves, rebuild, tree_map
from .optimizer import apply_updates, global_norm, lr_schedule, make_optimizer


def actnorm_hinge_penalty(params) -> torch.Tensor:
    """Dead-zone hinge on the ActNorm scales: sum over blocks of
    sum(relu(|3*logs| - margin)^2) / C_level, fp32."""
    pen = torch.zeros((), device=params["blocks"][0]["flows"]["actnorm"]
                      ["logs"].device)
    for bp in params["blocks"]:
        logs3 = bp["flows"]["actnorm"]["logs"].float() * 3.0
        excess = torch.relu(logs3.abs() - fwn.LOGS_HINGE_MARGIN)
        pen = pen + (excess * excess).sum() / logs3.shape[-1]
    return pen


class TrainState(NamedTuple):
    step: torch.Tensor         # int32 scalar
    params: Any
    opt_state: Any


def create_state(gen: torch.Generator, cfg: Config) -> TrainState:
    """Fresh fp32 params on ``gen.device`` and a zero optimizer state."""
    params = fwn.init_flowavenet(gen, cfg.model)
    opt = make_optimizer(cfg.train)
    return TrainState(torch.zeros((), dtype=torch.int32, device=gen.device),
                      params, opt.init(params))


def _compute_dtype(cfg: Config):
    return (torch.bfloat16 if cfg.train.compute_dtype == "bfloat16"
            else torch.float32)


def _speakers(cfg: Config, batch: dict):
    """The batch's speaker ids [B] as g on a global-conditioning model."""
    return batch.get("speaker") if cfg.model.gin_channels > 0 else None


def grads_of(loss_of, params, mesh=None):
    """(total, aux, grads) of ``loss_of(params) -> (total, aux)`` over
    every leaf (zeros for an unused one).  With a mesh: the conditioning
    1x1s run on this rank's shards, and the gradients are averaged over
    the data group (the loss is a mean over the global batch)."""
    params = tree_map(lambda l: l.detach().requires_grad_(), params)
    with tensor_parallel(mesh):
        total, aux = loss_of(params)
        flat = leaves(params)
        g_flat = torch.autograd.grad(total, flat, allow_unused=True)
    g_flat = [torch.zeros_like(p) if g is None else g
              for g, p in zip(g_flat, flat)]
    if mesh is not None:
        with torch.no_grad():
            data_mean_(g_flat, mesh)
    return total, aux, rebuild(params, g_flat)


# the leaves tensor parallelism may split: the conditioning 1x1s' kernels
TP_LEAVES = tuple(f"['{k}']['v']" for k in ("filter_c", "gate_c",
                                            "filter_g", "gate_g"))


def reduce_metrics(total: torch.Tensor, aux: dict, mesh):
    """(total, metrics) averaged over the data group, as over the global
    batch (``max_log_s``: its maximum); unchanged without collectives."""
    metrics = {k: v.detach() for k, v in aux.items()}
    if mesh is None or not mesh.distributed:
        return total.detach(), metrics
    keys = [k for k in metrics if k != "max_log_s"]
    vals = torch.stack([total.detach().float()]
                       + [metrics[k].float() for k in keys])
    data_mean_([vals], mesh)
    metrics.update(zip(keys, vals[1:].unbind()))
    if "max_log_s" in metrics:
        mx = metrics["max_log_s"].clone()
        data_max_(mx, mesh)
        metrics["max_log_s"] = mx
    return vals[0], metrics


def make_train_step(cfg: Config, mesh=None, specs=None):
    """Returns train_step(state, batch) -> (state, metrics); batch holds
    device tensors "audio" [B, T, 1], "mel" [B, T/hop, mels] and, for a
    global-conditioning model, "speaker" [B]; metrics are 0-d device
    tensors.  ``mesh``: the process mesh of a data- or tensor-parallel run
    (batch holds this rank's rows); ``specs``: the params' shardings
    (``parallel/mesh.py:param_sharding`` of the full params), needed when
    the model extent is above 1.  Only the conditioning 1x1s may be split;
    a spec that splits any other leaf raises."""
    if mesh is not None and mesh.n_model > 1:
        if specs is None:
            raise ValueError("a mesh with a model axis needs the params' "
                             "specs")
        other = [p for p in sharded_paths(specs)
                 if not p.endswith(TP_LEAVES)]
        if other:
            raise ValueError(
                "tensor parallelism covers the conditioning 1x1s only; "
                f"the specs split {other}")
    opt = make_optimizer(cfg.train, mesh, specs)
    schedule = lr_schedule(cfg.train)
    dt = _compute_dtype(cfg)
    tc = cfg.train

    def loss_of(params, batch):
        total, aux = fwn.loss_fn(params, cfg.model, batch["audio"],
                                 batch["mel"], _speakers(cfg, batch),
                                 compute_dtype=dt, logs_l2=tc.logs_l2,
                                 logs_hinge=tc.logs_hinge)
        if tc.actnorm_hinge > 0.0:
            pen = actnorm_hinge_penalty(params)
            aux["actnorm_hinge"] = pen
            total = total + tc.actnorm_hinge * pen
        return total, aux

    def train_step(state: TrainState, batch: dict):
        total, aux, grads = grads_of(lambda p: loss_of(p, batch),
                                     state.params, mesh)
        with torch.no_grad():
            total, metrics = reduce_metrics(total, aux, mesh)
            old = state.params
            grad_norm = global_norm(grads, specs, mesh)
            updates, opt_state = opt.update(grads, state.opt_state, old)
            new_params = apply_updates(old, updates)
            an_max = torch.zeros((), device=grad_norm.device)
            for bp in old["blocks"]:
                an_max = torch.maximum(an_max, (bp["flows"]["actnorm"]["logs"]
                                                .float() * 3.0).abs().max())
            metrics.update(grad_global_norm=grad_norm,
                           param_global_norm=global_norm(old, specs, mesh),
                           actnorm_max_logs3=an_max,
                           learning_rate=schedule(state.step))
            if tc.skip_nonfinite_updates:
                # a divergent step passes the old state through unchanged
                ok = torch.isfinite(total) & torch.isfinite(grad_norm)
                new_params = tree_map(lambda n, o: torch.where(ok, n, o),
                                      new_params, old)
                opt_state = tree_map(lambda n, o: torch.where(ok, n, o),
                                     opt_state, state.opt_state)
                metrics["skipped_nonfinite"] = 1.0 - ok.float()
        return TrainState(state.step + 1, new_params, opt_state), metrics

    return train_step


def make_eval_step(cfg: Config, mesh=None):
    """eval_step(params, batch) -> the loss metrics; with a mesh, this
    rank's rows and shards, the metrics averaged over the data group."""
    dt = _compute_dtype(cfg)

    @torch.no_grad()
    def eval_step(params, batch: dict):
        with tensor_parallel(mesh):
            total, aux = fwn.loss_fn(params, cfg.model, batch["audio"],
                                     batch["mel"], _speakers(cfg, batch),
                                     compute_dtype=dt)
        return reduce_metrics(total, aux, mesh)[1]

    return eval_step


def ddi_initialize(state: TrainState, cfg: Config, batch: dict
                   ) -> TrainState:
    """Data-dependent ActNorm init from one batch, in fp32."""
    new_params = fwn.ddi(state.params, cfg.model, batch["audio"],
                         batch["mel"], _speakers(cfg, batch),
                         compute_dtype=torch.float32)
    return state._replace(params=new_params)
