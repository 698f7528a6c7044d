"""CLI: convert a dumped reference TF checkpoint into a checkpoint that the
port's and the JAX package's synthesis and training read (twin of
``flowavenet_tpu/checkpoint/import_cli.py``):

    python -m flowavenet_tpu_torch.checkpoint.import_cli --npz tf.npz \\
        --out_dir logs/pretrained --config lj22k

Pipeline: ``tools/dump_tf_checkpoint.py`` (a TF environment) -> .npz ->
this CLI -> ``<out_dir>/ckpt-<step>.npz``.  The optimizer state is
initialized fresh (the reference's Adam slots are skipped).  The fresh
state is made on ``--device`` (the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..checkpoint.bridge import to_torch
from ..checkpoint.checkpoint import _paths, save_checkpoint
from ..checkpoint.tf_import import import_tf_checkpoint
from ..config import get_config
from ..synthesis.synthesize import resolve_device
from ..training.train_state import TrainState, create_state


def _layout(tree) -> list:
    """(path, shape) of every leaf, in the checkpoint's key order."""
    return [(k, tuple(np.shape(v))) for k, v in _paths(tree)]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Import a reference TF checkpoint (dumped to .npz)")
    p.add_argument("--npz", required=True,
                   help="output of tools/dump_tf_checkpoint.py")
    p.add_argument("--out_dir", required=True,
                   help="checkpoint dir (e.g. logs/pretrained)")
    p.add_argument("--config", default="lj22k")
    p.add_argument("--step", type=int, default=0,
                   help="step to record (reference global_step)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    with np.load(args.npz, allow_pickle=False) as data:
        variables = {k: data[k] for k in data.files}
    params = import_tf_checkpoint(variables, cfg.model)

    state = create_state(torch.Generator(dev).manual_seed(0), cfg)
    # the fresh state is the template: the imported tree must match it
    if _layout(state.params) != _layout(params):
        raise ValueError("imported parameter tree does not match the "
                         f"{args.config} model structure")
    state = TrainState(step=torch.tensor(args.step, dtype=torch.int32),
                       params=to_torch(params, dev),
                       opt_state=state.opt_state)
    path = save_checkpoint(args.out_dir, args.step, state)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
