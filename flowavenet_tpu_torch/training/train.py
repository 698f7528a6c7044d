"""Training on the GPU (twin of ``flowavenet_tpu/training/train.py``).

    python -m flowavenet_tpu_torch.training.train --device cuda \\
        --data_dir <dir with train.fwrec [test.fwrec]> --logdir logs
    torchrun --nproc_per_node N -m flowavenet_tpu_torch.training.train \\
        --device cuda --distributed ...

* Restore-or-DDI: the newest ``ckpt-<step>.npz`` under ``<logdir>/
  pretrained`` (written by either package) is resumed exactly; otherwise
  the ActNorms are initialized from batch 0 (DDI, fp32).
* Batches are counter-based (``batch_at(step)``), so a resumed run
  continues the same data stream bit for bit.  ``--loader native`` reads
  them with the C++ loader (``data/native_loader.py``), whose stream is
  the JAX package's native one; a checkpoint records its loader, and
  resuming it with the other one needs ``--allow_loader_switch``.
* Scale-out: the processes of a ``torch.distributed`` run (torchrun's
  ``--distributed``, or ``--coordinator_address`` / ``--num_processes`` /
  ``--process_id``; NCCL on the card, gloo on the CPU) form the
  ``cfg.mesh`` (data, model) mesh.  Every rank draws the same global batch
  (batch_size x data extent) and feeds its rows; the conditioning 1x1s
  with Cin >= ``TP_MIN_CIN`` are split over the model axis.  Rank 0
  writes the metrics and checkpoints (gathered to the one-device layout,
  which either package restores) and runs the synthesis probe.
* The loop queues steps on the device and reads metrics back only at sync
  points (heartbeat, summary, checkpoint, synthesis probe), in one batched
  copy each.
* SIGTERM finishes the step in flight, checkpoints and exits (the ranks
  of a multi-process run agree on it at their next sync point).
* ``--tensorboard`` mirrors the summaries and the probe's audio into
  TensorBoard event files under ``<logdir>/train`` (needs the
  ``tensorboard`` package; without it the trainer says so and goes on).
* ``--profile_steps N`` traces N steps after the first with
  ``torch.profiler`` (``utils/profiling.py:trace``) into
  ``<logdir>/profile``.

Routes follow the model's flags: ``FWN_TRAIN_KERNEL=1`` trains the blocks
with cc_half <= ``FWN_TRAIN_MAX_CC`` through the training pair kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import threading
import time

import numpy as np
import torch

from ..checkpoint.checkpoint import (latest_checkpoint, read_meta,
                                     restore_checkpoint, save_checkpoint)
from ..config import Config, get_config
from ..data.dataset import CropDataset
from ..data.records import FwRecordReader
from ..parallel.mesh import make_mesh, param_sharding
from ..parallel.multihost import (gather_tree, host_batch_slice,
                                  initialize_distributed, make_global_batch,
                                  put_tree, shutdown)
from ..synthesis.synthesize import resolve_device
from ..utils.profiling import trace
from ..utils.tree import leaves
from .metrics import MetricsWriter, format_step
from .train_state import (TrainState, create_state, ddi_initialize,
                          make_eval_step, make_train_step)


def to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(dev, non_blocking=True)
            for k, v in batch.items()}


def read_metrics(metrics: dict) -> dict:
    """One batched device-to-host copy of every scalar metric."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu()
    return dict(zip(keys, vals.tolist()))


def state_sharding(state: TrainState, mesh, mesh_cfg) -> TrainState:
    """Specs of the whole train state: params by the TP rule, the Adam
    moments by the same rule (they mirror the params leaf for leaf),
    counters replicated.  Reads the full shapes."""
    from ..parallel.mesh import P
    return TrainState(step=P(),
                      params=param_sharding(state.params, mesh, mesh_cfg),
                      opt_state=param_sharding(state.opt_state, mesh,
                                               mesh_cfg))


def train(cfg: Config, data_dir: str, logdir: str, *, restore: bool = True,
          train_steps: int | None = None, summary_interval: int | None = None,
          checkpoint_interval: int | None = None,
          eval_interval: int | None = None, probe_synthesis: bool = True,
          loader: str = "python", allow_loader_switch: bool = False,
          log_every: int = 50, tensorboard: bool = False,
          profile_steps: int = 0,
          device: str | torch.device = "cuda") -> str:
    """Train to ``train_steps``; returns the checkpoint directory.
    ``loader``: ``"python"`` (``CropDataset``) or ``"native"`` (the C++
    loader); ``tensorboard`` mirrors metrics and audio into TensorBoard
    event files; ``profile_steps`` traces that many steps after the
    first.  In a ``torch.distributed`` run every rank calls it; a bare
    ``cuda`` device is ``cuda:<LOCAL_RANK>``."""
    resolve_device(device)
    if loader not in ("python", "native"):
        raise ValueError(f"loader must be 'python' or 'native', got "
                         f"{loader!r}")
    t_cfg = cfg.train
    train_steps = train_steps or t_cfg.train_steps
    summary_interval = summary_interval or t_cfg.summary_interval
    checkpoint_interval = checkpoint_interval or t_cfg.checkpoint_interval
    eval_interval = eval_interval or t_cfg.eval_interval
    log_every = max(1, log_every)        # 0 means "every step", not a crash

    mesh = make_mesh(cfg.mesh, device)
    dev = mesh.device
    lead = mesh.rank == 0
    n_data = mesh.n_data
    global_batch = cfg.data.batch_size * n_data

    save_dir = os.path.join(logdir, "pretrained")
    writer = test_writer = tb = None
    if lead:
        writer = MetricsWriter(os.path.join(logdir, "train"))
        test_writer = MetricsWriter(os.path.join(logdir, "test"))
        if tensorboard:
            from .tb_writer import maybe_tb_writer
            tb = maybe_tb_writer(os.path.join(logdir, "train"))
            if tb is None:
                print("tensorboard writer unavailable (no tensorboard "
                      "package); JSONL metrics only")
    # a global-conditioning model trains on the records' speaker ids
    with_speaker = cfg.model.gin_channels > 0
    if loader == "native":
        from ..data.native_loader import NativeCropDataset as DatasetCls
    else:
        DatasetCls = CropDataset
    dataset = DatasetCls(
        os.path.join(data_dir, "train.fwrec"), hop_size=cfg.audio.hop_size,
        max_time_steps=cfg.data.max_time_steps, batch_size=global_batch,
        seed=t_cfg.seed, with_speaker=with_speaker)
    test_path = os.path.join(data_dir, "test.fwrec")
    test_dataset = CropDataset(
        test_path, hop_size=cfg.audio.hop_size,
        max_time_steps=cfg.data.max_time_steps, batch_size=global_batch,
        seed=t_cfg.seed + 1, with_speaker=with_speaker) \
        if os.path.exists(test_path) else None

    state = create_state(torch.Generator(dev).manual_seed(t_cfg.seed), cfg)
    n_params = sum(l.numel() for l in leaves(state.params))
    if lead:
        print(f"Model: {n_params / 1e6:.1f} M params | device {dev} | mesh "
              f"{mesh.shape} | global batch {global_batch}")

    # every rank draws the same global batch and feeds its own rows
    rows = host_batch_slice(global_batch, mesh)

    def put_batch(b):
        return make_global_batch({k: v[rows] for k, v in b.items()}, mesh)

    start_step = 0
    ckpt = latest_checkpoint(save_dir) if restore else None
    if ckpt is not None:
        if lead:
            print(f"Loading checkpoint {ckpt}")
        # the two loaders draw with different PRNGs (Philox vs
        # splitmix64): switching mid-run silently changes the data stream
        ckpt_loader = read_meta(ckpt).get("loader")
        if ckpt_loader is not None and ckpt_loader != loader:
            if allow_loader_switch:
                print(f"WARNING: resuming a --loader={ckpt_loader} run with "
                      f"--loader={loader}; the data stream will differ")
            else:
                raise ValueError(
                    f"checkpoint {ckpt} was trained with --loader="
                    f"{ckpt_loader} but this run uses --loader={loader}; "
                    f"their PRNGs differ so the data stream would silently "
                    f"change. Pass --allow_loader_switch to proceed.")
        # the full tree on every rank; put_tree keeps each rank's shards
        state, start_step = restore_checkpoint(ckpt, state)
        state = state._replace(step=torch.tensor(start_step,
                                                 dtype=torch.int32,
                                                 device=dev))
    else:
        if lead:
            print("Init ActNorm layers (DDI)...", end="", flush=True)
        # DDI on the full global batch on every rank (the same statistics
        # everywhere)
        state = ddi_initialize(state, cfg, to_device(dataset.batch_at(0),
                                                     dev))
        if lead:
            print(" OK")
    specs = state_sharding(state, mesh, cfg.mesh)
    state = put_tree(state, mesh, specs)

    # one process without torch.distributed runs the one-device steps
    if mesh.distributed:
        train_step = make_train_step(cfg, mesh, specs.params)
        eval_step = make_eval_step(cfg, mesh)
    else:
        train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)

    preempt = threading.Event()
    prev_handler = None
    if threading.current_thread() is threading.main_thread():
        prev_handler = signal.signal(signal.SIGTERM,
                                     lambda signum, frame: preempt.set())
    data_iter = dataset.iterate(start_step=start_step)
    # the profile window: closed when its steps are done or on any exit
    profile = contextlib.ExitStack()
    try:
        step = start_step
        win_t0, win_steps = time.time(), 0
        while step < train_steps:
            if profile_steps and lead and step == start_step + 1:
                # skip the first step (kernel builds, allocator warm-up)
                profile.enter_context(trace(os.path.join(logdir, "profile")))
            state, metrics = train_step(state, put_batch(next(data_iter)))
            step += 1
            win_steps += 1
            if profile_steps and lead and step == start_step + 1 + \
                    profile_steps:
                profile.close()
                print(f"\nprofile trace written to {logdir}/profile")
            # several ranks take the signal at the next sync point they all
            # reach, so that they stop at one step
            preempted = preempt.is_set() and mesh.size == 1
            summarize = step % summary_interval == 0 or step == 1
            ckpt_due = (step % checkpoint_interval == 0
                        or step == train_steps or preempted)
            probe_due = probe_synthesis and step % eval_interval == 0
            if not (step % log_every == 0 or summarize or ckpt_due
                    or probe_due):
                continue

            # sync point: one batched readback; the window ends here
            metrics = read_metrics(metrics)
            dt = (time.time() - win_t0) / win_steps
            if mesh.size > 1:
                flag = torch.tensor(float(preempt.is_set()), device=dev)
                torch.distributed.all_reduce(
                    flag, op=torch.distributed.ReduceOp.MAX)
                preempted = bool(flag.item())
                ckpt_due = ckpt_due or preempted
            if lead:
                print(format_step(step, dt, metrics), end="\r")
            if summarize:
                metrics["sec_per_step"] = dt
                metrics["samples_per_sec"] = (global_batch
                                              * dataset.time_crop / dt)
                if lead:
                    writer.scalars(step, metrics)
                    if tb is not None:
                        tb.scalars(step, metrics)
                if test_dataset is not None:
                    eval_metrics = read_metrics(eval_step(
                        state.params, put_batch(test_dataset.batch_at(step))))
                    if lead:
                        test_writer.scalars(step, eval_metrics)
                if lead:
                    print()
            if ckpt_due:
                # the one-device layout, gathered on every rank
                full = gather_tree(state, mesh, specs)
                if lead:
                    save_checkpoint(save_dir, step, full,
                                    extra_meta={"loader": loader})
            if preempted:
                if lead:
                    print(f"\nSIGTERM: checkpointed step {step}, exiting "
                          "(resume restores this run bit-exactly)")
                break
            if probe_due:
                params = gather_tree(state.params, mesh, specs.params)
                if lead:
                    _synthesis_probe(params, cfg, data_dir, writer, step,
                                     dev, tb=tb)
            # the next window starts after the sync-point work, so it
            # measures training steps only
            win_t0, win_steps = time.time(), 0
    finally:
        profile.close()
        data_iter.close()            # stops the prefetch thread
        if loader == "native":
            dataset.close()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        for w in (writer, test_writer, tb):
            if w is not None:
                w.close()
    if lead:
        print()
    return save_dir


def _synthesis_probe(params, cfg: Config, data_dir: str,
                     writer: MetricsWriter, step: int,
                     dev: torch.device, tb=None) -> None:
    """Synthesize a random test utterance through the port's
    ``synthesize_mels`` and write it beside its target (also as
    TensorBoard audio when ``tb`` is given)."""
    from ..synthesis.synthesize import synthesize_mels

    path = os.path.join(data_dir, "test.fwrec")
    if not os.path.exists(path):
        path = os.path.join(data_dir, "train.fwrec")
    reader = FwRecordReader(path)
    rng = np.random.RandomState(cfg.train.seed + step)
    i = int(rng.randint(len(reader)))
    audio, mel, sid = reader.read(i)
    reader.close()
    frames = min(mel.shape[0],
                 cfg.data.eval_max_time_steps // cfg.audio.hop_size)
    wavs = synthesize_mels(params, cfg, [mel[:frames]],
                           seed=int(rng.randint(2 ** 31)),
                           speaker_ids=([sid] if cfg.model.gin_channels > 0
                                        else None), device=dev)
    writer.wav(step, "prediction", wavs[0], cfg.audio.sample_rate)
    writer.wav(step, "target", audio[: len(wavs[0])], cfg.audio.sample_rate)
    if tb is not None:
        tb.wav(step, "eval/prediction", wavs[0], cfg.audio.sample_rate)
        tb.wav(step, "eval/target", audio[: len(wavs[0])],
               cfg.audio.sample_rate)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="FloWaveNet training on the GPU (PyTorch port)")
    parser.add_argument("--base_dir", default="")
    parser.add_argument("--data_dir", default="training_data",
                        help="dir with train.fwrec (and test.fwrec)")
    parser.add_argument("--logdir", default="logs")
    parser.add_argument("--config", default="lj22k")
    parser.add_argument("--restore", type=lambda s: s.lower() != "false",
                        default=True, help="set False for a fresh run")
    parser.add_argument("--summary_interval", type=int, default=None)
    parser.add_argument("--checkpoint_interval", type=int, default=None)
    parser.add_argument("--eval_interval", type=int, default=None)
    parser.add_argument("--train_steps", type=int, default=None)
    parser.add_argument("--loader", choices=["python", "native"],
                        default="python",
                        help="host input pipeline: pure-python or the C++ "
                             "fwrec loader (data/csrc, built with g++)")
    parser.add_argument("--allow_loader_switch", action="store_true",
                        help="resume a checkpoint trained with the other "
                             "--loader (the data stream WILL differ; their "
                             "PRNGs are not bit-compatible)")
    parser.add_argument("--log_every", type=int, default=50,
                        help="heartbeat and host-sync interval in steps")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also mirror metrics into TensorBoard event "
                             "files (needs the tensorboard package)")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="trace N steps after the first with "
                             "torch.profiler into <logdir>/profile")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; cuda:<LOCAL_RANK> per rank) or "
                             "cpu")
    parser.add_argument("--coordinator_address", default=None,
                        help="host:port of process 0 for a multi-process "
                             "run (torch.distributed)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group that torchrun's "
                             "environment describes (RANK, WORLD_SIZE, "
                             "MASTER_ADDR, MASTER_PORT)")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    joined = False
    if args.distributed or args.coordinator_address is not None:
        joined = initialize_distributed(args.coordinator_address,
                                        args.num_processes, args.process_id,
                                        device=args.device)
    cfg = get_config(args.config)
    data_dir = os.path.join(args.base_dir, args.data_dir)
    logdir = os.path.join(args.base_dir, args.logdir)
    os.makedirs(logdir, exist_ok=True)
    try:
        train(cfg, data_dir, logdir, restore=args.restore,
              train_steps=args.train_steps,
              summary_interval=args.summary_interval,
              checkpoint_interval=args.checkpoint_interval,
              eval_interval=args.eval_interval, loader=args.loader,
              allow_loader_switch=args.allow_loader_switch,
              log_every=args.log_every, tensorboard=args.tensorboard,
              profile_steps=args.profile_steps, device=args.device)
    finally:
        if joined:
            shutdown()


if __name__ == "__main__":
    main()
