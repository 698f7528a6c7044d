"""One rank of a CPU ``torch.distributed`` (gloo) run of the PyTorch port,
for tests/test_torch_parallel.py.

    python _torch_dist_worker.py PORT RANK WORLD DATA MODEL TP_MIN_CIN MODE \\
        IN OUT

MODE ``grads``: the tiny model's loss gradients over the (DATA, MODEL) mesh
from the params and batch of IN (``params.npz``, ``batch.npz``); rank 0
writes the gathered gradients to OUT/grads (a checkpoint); every rank
prints ``SHARDED <path>`` for each split leaf and ``LOSS <loss>``, then
``STEP <loss> <step>`` after two ``make_train_step`` steps from DDI on the
same global batch.  MODE ``train``: ``train()`` on the corpus in IN for 2
steps into the logdir OUT.
"""

import dataclasses
import os
import sys

port, rank, world, n_data, n_model, tp_min = map(int, sys.argv[1:7])
mode, inp, out = sys.argv[7:10]

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from flowavenet_tpu_torch.checkpoint.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)
from flowavenet_tpu_torch.config import MeshConfig, tiny  # noqa: E402
from flowavenet_tpu_torch.models import flowavenet as fwn  # noqa: E402
from flowavenet_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from flowavenet_tpu_torch.parallel.multihost import (  # noqa: E402
    gather_tree, host_batch_slice, initialize_distributed, make_global_batch,
    put_tree, sharded_paths, shutdown)
from flowavenet_tpu_torch.training.train import (state_sharding,  # noqa: E402
                                                 train)
from flowavenet_tpu_torch.training.train_state import (  # noqa: E402
    create_state, ddi_initialize, grads_of, make_train_step, reduce_metrics)

mesh_mod.TP_MIN_CIN = tp_min
initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
cfg = tiny()
cfg = cfg.replace(mesh=dataclasses.replace(
    cfg.mesh, data_parallel=n_data, model_parallel=n_model))
mesh = mesh_mod.make_mesh(cfg.mesh, "cpu")
try:
    if mode == "grads":
        template = fwn.init_flowavenet(torch.Generator().manual_seed(0),
                                       cfg.model)
        params, _ = restore_checkpoint(os.path.join(inp, "params.npz"),
                                       template)
        with np.load(os.path.join(inp, "batch.npz")) as f:
            batch = {k: f[k] for k in f.files}
        rows = host_batch_slice(batch["audio"].shape[0], mesh)
        local = make_global_batch({k: v[rows] for k, v in batch.items()},
                                  mesh)
        specs = mesh_mod.param_sharding(params, mesh, cfg.mesh)
        for path in sharded_paths(specs):
            print("SHARDED", path, flush=True)
        total, aux, grads = grads_of(
            lambda p: fwn.loss_fn(p, cfg.model, local["audio"],
                                  local["mel"]),
            put_tree(params, mesh, specs), mesh)
        full = gather_tree(grads, mesh, specs)
        if rank == 0:
            save_checkpoint(os.path.join(out, "grads"), 0, full)
        print(f"LOSS {float(reduce_metrics(total, aux, mesh)[0]):.9g}",
              flush=True)
        state = ddi_initialize(create_state(
            torch.Generator().manual_seed(0), cfg), cfg,
            {k: torch.from_numpy(v) for k, v in batch.items()})
        st_specs = state_sharding(state, mesh, cfg.mesh)
        state = put_tree(state, mesh, st_specs)
        step = make_train_step(cfg, mesh, st_specs.params)
        for _ in range(2):
            state, metrics = step(state, local)
        print(f"STEP {float(metrics['loss']):.9g} {int(state.step)}",
              flush=True)
    else:
        train(cfg, inp, out, train_steps=2, summary_interval=1,
              checkpoint_interval=2, eval_interval=2, log_every=1,
              device="cpu")
finally:
    shutdown()
