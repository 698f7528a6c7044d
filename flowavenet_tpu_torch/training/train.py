"""Training on one GPU (twin of ``flowavenet_tpu/training/train.py``).

    python -m flowavenet_tpu_torch.training.train --device cuda \\
        --data_dir <dir with train.fwrec [test.fwrec]> --logdir logs

* Restore-or-DDI: the newest ``ckpt-<step>.npz`` under ``<logdir>/
  pretrained`` (written by either package) is resumed exactly; otherwise
  the ActNorms are initialized from batch 0 (DDI, fp32).
* Batches are counter-based (``CropDataset.batch_at(step)``), so a resumed
  run continues the same data stream bit for bit.
* The loop queues steps on the device and reads metrics back only at sync
  points (heartbeat, summary, checkpoint, synthesis probe), in one batched
  copy each.
* SIGTERM finishes the step in flight, checkpoints and exits.
* ``--tensorboard`` mirrors the summaries and the probe's audio into
  TensorBoard event files under ``<logdir>/train`` (needs the
  ``tensorboard`` package; without it the trainer says so and goes on).
* ``--profile_steps N`` traces N steps after the first with
  ``torch.profiler`` (``utils/profiling.py:trace``) into
  ``<logdir>/profile``.

Routes follow the model's flags: ``FWN_TRAIN_KERNEL=1`` trains the blocks
with cc_half <= ``FWN_TRAIN_MAX_CC`` through the training pair kernels.
Not ported yet: the native loader, the mesh and tensor parallelism.
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
from ..synthesis.synthesize import resolve_device
from ..utils.profiling import trace
from ..utils.tree import leaves
from .metrics import MetricsWriter, format_step
from .train_state import (TrainState, create_state, ddi_initialize,
                          make_eval_step, make_train_step)

LOADER = "python"


def to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(dev, non_blocking=True)
            for k, v in batch.items()}


def read_metrics(metrics: dict) -> dict:
    """One batched device-to-host copy of every scalar metric."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys]).cpu()
    return dict(zip(keys, vals.tolist()))


def train(cfg: Config, data_dir: str, logdir: str, *, restore: bool = True,
          train_steps: int | None = None, summary_interval: int | None = None,
          checkpoint_interval: int | None = None,
          eval_interval: int | None = None, probe_synthesis: bool = True,
          log_every: int = 50, tensorboard: bool = False,
          profile_steps: int = 0,
          device: str | torch.device = "cuda") -> str:
    """Train to ``train_steps``; returns the checkpoint directory.
    ``tensorboard`` mirrors metrics and audio into TensorBoard event files;
    ``profile_steps`` traces that many steps after the first."""
    dev = resolve_device(device)
    t_cfg = cfg.train
    train_steps = train_steps or t_cfg.train_steps
    summary_interval = summary_interval or t_cfg.summary_interval
    checkpoint_interval = checkpoint_interval or t_cfg.checkpoint_interval
    eval_interval = eval_interval or t_cfg.eval_interval
    log_every = max(1, log_every)        # 0 means "every step", not a crash

    save_dir = os.path.join(logdir, "pretrained")
    writer = MetricsWriter(os.path.join(logdir, "train"))
    test_writer = MetricsWriter(os.path.join(logdir, "test"))
    tb = None
    if tensorboard:
        from .tb_writer import maybe_tb_writer
        tb = maybe_tb_writer(os.path.join(logdir, "train"))
        if tb is None:
            print("tensorboard writer unavailable (no tensorboard package); "
                  "JSONL metrics only")
    batch_size = cfg.data.batch_size
    # a global-conditioning model trains on the records' speaker ids
    with_speaker = cfg.model.gin_channels > 0
    dataset = CropDataset(
        os.path.join(data_dir, "train.fwrec"), hop_size=cfg.audio.hop_size,
        max_time_steps=cfg.data.max_time_steps, batch_size=batch_size,
        seed=t_cfg.seed, with_speaker=with_speaker)
    test_path = os.path.join(data_dir, "test.fwrec")
    test_dataset = CropDataset(
        test_path, hop_size=cfg.audio.hop_size,
        max_time_steps=cfg.data.max_time_steps, batch_size=batch_size,
        seed=t_cfg.seed + 1, with_speaker=with_speaker) \
        if os.path.exists(test_path) else None

    state = create_state(torch.Generator(dev).manual_seed(t_cfg.seed), cfg)
    n_params = sum(l.numel() for l in leaves(state.params))
    print(f"Model: {n_params / 1e6:.1f} M params | device {dev} | batch "
          f"{batch_size}")

    start_step = 0
    ckpt = latest_checkpoint(save_dir) if restore else None
    if ckpt is not None:
        print(f"Loading checkpoint {ckpt}")
        ckpt_loader = read_meta(ckpt).get("loader")
        if ckpt_loader not in (None, LOADER):
            raise ValueError(
                f"checkpoint {ckpt} was trained with --loader={ckpt_loader}; "
                f"this trainer has only the {LOADER} loader, whose data "
                "stream differs")
        state, start_step = restore_checkpoint(ckpt, state)
        state = state._replace(step=torch.tensor(start_step,
                                                 dtype=torch.int32,
                                                 device=dev))
    else:
        print("Init ActNorm layers (DDI)...", end="", flush=True)
        state = ddi_initialize(state, cfg, to_device(dataset.batch_at(0),
                                                     dev))
        print(" OK")

    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)

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
            if profile_steps and step == start_step + 1:
                # skip the first step (kernel builds, allocator warm-up)
                profile.enter_context(trace(os.path.join(logdir, "profile")))
            state, metrics = train_step(state, to_device(next(data_iter),
                                                         dev))
            step += 1
            win_steps += 1
            if profile_steps and step == start_step + 1 + profile_steps:
                profile.close()
                print(f"\nprofile trace written to {logdir}/profile")
            preempted = preempt.is_set()
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
            print(format_step(step, dt, metrics), end="\r")
            if summarize:
                metrics["sec_per_step"] = dt
                metrics["samples_per_sec"] = (batch_size * dataset.time_crop
                                              / dt)
                writer.scalars(step, metrics)
                if tb is not None:
                    tb.scalars(step, metrics)
                if test_dataset is not None:
                    eval_metrics = eval_step(
                        state.params,
                        to_device(test_dataset.batch_at(step), dev))
                    test_writer.scalars(step, read_metrics(eval_metrics))
                print()
            if ckpt_due:
                save_checkpoint(save_dir, step, state,
                                extra_meta={"loader": LOADER})
            if preempted:
                print(f"\nSIGTERM: checkpointed step {step}, exiting "
                      "(resume restores this run bit-exactly)")
                break
            if probe_due:
                _synthesis_probe(state, cfg, data_dir, writer, step, dev,
                                 tb=tb)
            # the next window starts after the sync-point work, so it
            # measures training steps only
            win_t0, win_steps = time.time(), 0
    finally:
        profile.close()
        data_iter.close()            # stops the prefetch thread
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        writer.close()
        test_writer.close()
        if tb is not None:
            tb.close()
    print()
    return save_dir


def _synthesis_probe(state: TrainState, cfg: Config, data_dir: str,
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
    wavs = synthesize_mels(state.params, cfg, [mel[:frames]],
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
    parser.add_argument("--log_every", type=int, default=50,
                        help="heartbeat and host-sync interval in steps")
    parser.add_argument("--tensorboard", action="store_true",
                        help="also mirror metrics into TensorBoard event "
                             "files (needs the tensorboard package)")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="trace N steps after the first with "
                             "torch.profiler into <logdir>/profile")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    cfg = get_config(args.config)
    data_dir = os.path.join(args.base_dir, args.data_dir)
    logdir = os.path.join(args.base_dir, args.logdir)
    os.makedirs(logdir, exist_ok=True)
    train(cfg, data_dir, logdir, restore=args.restore,
          train_steps=args.train_steps,
          summary_interval=args.summary_interval,
          checkpoint_interval=args.checkpoint_interval,
          eval_interval=args.eval_interval, log_every=args.log_every,
          tensorboard=args.tensorboard, profile_steps=args.profile_steps,
          device=args.device)


if __name__ == "__main__":
    main()
