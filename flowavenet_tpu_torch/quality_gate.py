"""Route-quality gate on trained weights: every synthesis route of
``synthesis/routes.py:ROUTES`` scored against the plain route on a trained
model.  Counterpart of the JAX package's ``tools/int8_quality_gate.py``
(build a corpus, preprocess, train, synthesize each route from the same
noise, score) and ``tools/gate_spread.py`` (several noise draws, per-
utterance spread, paired route deltas).

    python -m flowavenet_tpu_torch.quality_gate [WORKDIR] [--steps 3000]
        [--config tiny] [--ref_wavs DIR_OR_WAV ...] [--seeds N]
        [--frames 200] [--json OUT] [--device cuda|cpu]
    python -m flowavenet_tpu_torch.quality_gate --ckpt_dir DIR
        --data_dir DIR [--config lj22k] [--seeds 8] [--json OUT]

1. Corpus: the wavs of ``--ref_wavs`` (a directory or a list of files;
   by default the repository's own 22.05 kHz wavs in ``docs/runs/``) copied
   into the reference's layout (``corpus/book1/wavs``, ``metadata.csv``).
2. Preprocess with ``audio/preprocessing.py:preprocess`` unless
   ``training_data/train.txt`` exists.
3. Train with ``training/train.py:train`` (restored if the workdir holds a
   checkpoint), in the preset's own compute dtype, at the JAX tool's
   intervals.
4. Load the newest checkpoint cast to bf16, stack the corpus mels cut to
   ``_usable_frames(min(shortest mel, --frames))`` frames, and draw z
   (numpy, seed 1000 + s, times 0.7) once per seed for every route.
5. Synthesize in bf16 on the plain route (``use_pallas=False``, the JAX
   tool's "xla") and on every route of ``ROUTES``, each route's switches
   set for its call and restored after it; each route's kernel launches
   are counted (on the CPU the kernels' plain versions run and count
   none).
6. Score by the JAX tool's formulas: ``corr`` and ``relmax`` of each route
   against the plain route and against FWN_INT8=0 (the JAX tool's
   "bf16"), ``mel_corr`` of each route's audio against its conditioning
   mel (``audio/mel.py:process_wav``).
7. Verdict, by ``tools/int8_quality_gate.py:195-197`` with "xla" read as
   the plain route and "bf16" as FWN_INT8=0: a route passes when its corr
   to FWN_INT8=0 is at least 0.999, or at least FWN_INT8=0's own corr to
   the plain route less 1e-3 with its mel_corr within 5e-3 of the plain
   route's; FWN_INT8=0 takes the second clause against the plain route.
   Over several seeds the scores are the means over the seeds.

``--ckpt_dir``/``--data_dir`` skip steps 1-3 and score an existing
checkpoint (gate_spread's mode).  A route that raises, or whose audio is
not finite, stops the gate with an error: that is no FAIL.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import sys

import numpy as np
import torch

from .audio.mel import process_wav
from .config import Config, get_config
from .models.flowavenet import reverse
from .ops import launch
from .synthesis.routes import ROUTES, int8_route, patched, route_patches
from .synthesis.synthesize import _usable_frames, load_params, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository's own 22.05 kHz speech (~11.5 s)
DEFAULT_WAVS = tuple(os.path.join(REPO, "docs", "runs", f) for f in (
    "flagship_150k_target.wav", "flagship_150k_prediction.wav",
    "u004_50k.wav", "u005_50k.wav"))
PLAIN = "plain"
BASE = "FWN_INT8=0"             # the JAX tool's "bf16" route
GATE_ROUTES = (PLAIN,) + tuple(r[0] for r in ROUTES)
TEMP = 0.7
SEED0 = 1000                    # z of seed s: numpy seed SEED0 + s
CORR_PASS = 0.999               # int8_quality_gate.py:195
CORR_SLACK = 1e-3               # :196
MEL_DRIFT = 5e-3                # :197


def corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def relmax(a, b) -> float:
    return float(np.abs(a - b).max() / max(1e-9, float(np.abs(b).max())))


def mel_corr(wavs: np.ndarray, c: np.ndarray, audio_cfg) -> np.ndarray:
    """Per utterance: the correlation of the mel of the synthesized audio
    wavs [U, T, 1] with its conditioning mel c [U, frames, M]."""
    out = []
    for i in range(wavs.shape[0]):
        _, m = process_wav(wavs[i, :, 0], audio_cfg)
        n = min(m.shape[0], c.shape[1])
        out.append(corr(m[:n], c[i, :n]))
    return np.asarray(out)


def verdict(route_corr: float, base_floor: float, mc_route: float,
            mc_plain: float, *, second_only: bool = False) -> bool:
    """The JAX gate (int8_quality_gate.py:195-197): ``route_corr`` (the
    route's corr to FWN_INT8=0) of at least 0.999, or no lower than
    FWN_INT8=0's own corr to the plain route (``base_floor``) less 1e-3
    with the mel_corr within 5e-3 of the plain route's.  ``second_only``:
    the second clause alone (FWN_INT8=0 itself, against the plain
    route)."""
    second = (route_corr >= base_floor - CORR_SLACK
              and abs(mc_route - mc_plain) <= MEL_DRIFT)
    return bool(second if second_only else route_corr >= CORR_PASS or second)


def ref_wav_list(ref_wavs) -> list:
    """The wavs of ``ref_wavs``: each directory's ``*.wav`` sorted, each
    file as given."""
    names = []
    for p in ref_wavs:
        names += (sorted(glob.glob(os.path.join(p, "*.wav")))
                  if os.path.isdir(p) else [p])
    if not names:
        raise FileNotFoundError(f"no wavs in {list(ref_wavs)}")
    return names


def write_corpus(names: list, work: str) -> str:
    """The wavs copied into the reference's LJSpeech layout under
    ``work/corpus`` (as int8_quality_gate.py:108-121); returns its root."""
    corpus = os.path.join(work, "corpus", "book1")
    wav_dir = os.path.join(corpus, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i, src in enumerate(names):
        dst = f"u{i:03d}"
        shutil.copy(src, os.path.join(wav_dir, dst + ".wav"))
        lines.append(f"{dst}|x|ref {os.path.basename(src)}")
    with open(os.path.join(corpus, "metadata.csv"), "w") as f:
        f.write("\n".join(lines))
    return os.path.join(work, "corpus")


def train_model(cfg: Config, work: str, names: list, steps: int,
                summary_interval, device) -> tuple[str, str]:
    """Steps 1-3: corpus, preprocessing and training; returns the
    checkpoint directory and the preprocessed corpus."""
    from .audio.preprocessing import preprocess
    from .training.train import train
    corpus = write_corpus(names, work)
    data_dir = os.path.join(work, "training_data")
    if not os.path.exists(os.path.join(data_dir, "train.txt")):
        preprocess(corpus, data_dir, cfg, num_workers=2)
    logdir = os.path.join(work, "logs")
    ckpt_dir = train(cfg, data_dir, logdir, restore=True, train_steps=steps,
                     summary_interval=summary_interval
                     or max(1, steps // 10),
                     checkpoint_interval=max(1, steps // 3),
                     eval_interval=10 ** 9, device=device)
    return ckpt_dir, data_dir


def corpus_mels(data_dir: str, cfg: Config, max_frames: int):
    """(c [U, frames, M] float32, utterance names): the corpus mels stacked
    at the usable frame count of the shortest (at most ``max_frames``)."""
    paths = sorted(glob.glob(os.path.join(data_dir, "mels", "*.npy")))
    if not paths:
        raise FileNotFoundError(f"no mels in {data_dir}/mels")
    mels = [np.load(p) for p in paths]
    frames = _usable_frames(min(min(m.shape[0] for m in mels), max_frames),
                            cfg)
    return (np.stack([m[:frames] for m in mels]).astype(np.float32),
            [os.path.basename(p) for p in paths])


def _launch_counts() -> dict:
    return dict(launch.LAUNCHES)


def synthesize_route(params, cfg: Config, z: np.ndarray, c: np.ndarray,
                     route: str, device):
    """Audio [U, T, 1] (float32 numpy) of one route from z [U, T, 1] and c
    in bf16, and the kernel launches it made.  Raises on non-finite
    audio."""
    dev = torch.device(device)
    model = dataclasses.replace(cfg.model, use_pallas=route != PLAIN)
    zt = torch.from_numpy(z).to(dev)
    ct = torch.from_numpy(c).to(dev)
    with patched(route_patches(route)):
        n0 = _launch_counts()
        out = reverse(params, model, zt, ct, compute_dtype=torch.bfloat16)
        wav = out.float().cpu().numpy()
        launches = {k: v - n0[k] for k, v in _launch_counts().items()
                    if v != n0[k]}
    if not np.all(np.isfinite(wav)):
        raise RuntimeError(f"route {route}: non-finite audio")
    return wav, launches


def route_noise(seed: int, shape) -> np.ndarray:
    """z of one seed, shared by every route: numpy normal times 0.7."""
    return (np.random.RandomState(SEED0 + seed).randn(*shape)
            * TEMP).astype(np.float32)


def score_routes(params, cfg: Config, c: np.ndarray, seeds: int, device,
                 log=print) -> dict:
    """Steps 5-7 on every route of ``GATE_ROUTES`` over ``seeds`` noise
    draws.  Returns per route its mean scores, launches (of one reverse)
    and verdict, mc [seed][utt] per route, and the frame count."""
    routes = GATE_ROUTES
    U, frames = c.shape[0], c.shape[1]
    T = frames * cfg.audio.hop_size
    keys = ("corr_to_plain", "relmax_to_plain", "corr_to_base",
            "relmax_to_base")
    acc = {r: {k: [] for k in keys} for r in routes}
    mc = {r: np.zeros((seeds, U)) for r in routes}
    launches = {}
    for s in range(seeds):
        z = route_noise(s, (U, T, 1))
        wavs = {}
        for r in routes:
            wavs[r], launches[r] = synthesize_route(params, cfg, z, c, r,
                                                    device)
            mc[r][s] = mel_corr(wavs[r], c, cfg.audio)
        for r in routes:
            acc[r]["corr_to_plain"].append(corr(wavs[r], wavs[PLAIN]))
            acc[r]["relmax_to_plain"].append(relmax(wavs[r], wavs[PLAIN]))
            acc[r]["corr_to_base"].append(corr(wavs[r], wavs[BASE]))
            acc[r]["relmax_to_base"].append(relmax(wavs[r], wavs[BASE]))
        log(f"seed {s}: mel-corr " + "  ".join(
            f"{r}={mc[r][s].mean():.4f}" for r in routes))
    out = {}
    floor = float(np.mean(acc[BASE]["corr_to_plain"]))
    mc_plain = float(mc[PLAIN].mean())
    for r in routes:
        res = {k: float(np.mean(v)) for k, v in acc[r].items()}
        res["mel_corr"] = float(mc[r].mean())
        res["launches"] = launches[r]
        res["verdict"] = None
        if r != PLAIN:
            # FWN_INT8=0 takes the second clause against the plain route
            ok = verdict(floor if r == BASE else res["corr_to_base"], floor,
                         res["mel_corr"], mc_plain, second_only=r == BASE)
            res["verdict"] = "PASS" if ok else "FAIL"
        out[r] = res
    return {"routes": out, "mc": mc, "frames": frames}


def _delta_pairs(routes) -> list:
    """The paired deltas: every kernel route against the plain route, and
    every int8 route against FWN_INT8=0."""
    pairs = [(r, PLAIN) for r in routes if r != PLAIN]
    return pairs + [(r, BASE) for r in routes
                    if r not in (PLAIN, BASE) and int8_route(r)]


def report(res: dict, names: list, step: int, seeds: int,
           log=print) -> dict:
    """Prints the gate's lines (scores, launches and the JAX tool's GATE
    line per route, gate_spread's spread and paired deltas) and returns
    the JSON record."""
    routes, mc = res["routes"], res["mc"]
    floor = routes[BASE]["corr_to_plain"]
    mc_plain = routes[PLAIN]["mel_corr"]
    for r, v in routes.items():
        log(f"route {r}: corr vs plain {v['corr_to_plain']:.6f} relmax "
            f"{v['relmax_to_plain']:.4f}; vs {BASE} corr "
            f"{v['corr_to_base']:.6f} relmax {v['relmax_to_base']:.4f}; "
            f"mel-corr {v['mel_corr']:.4f}; launches {v['launches']}")
    for r, v in routes.items():
        if r == PLAIN:
            continue
        against = PLAIN if r == BASE else BASE
        c_r = floor if r == BASE else v["corr_to_base"]
        log(f"GATE {r}: {r}-vs-{against} corr {c_r:.6f} vs {BASE}-route "
            f"reorder floor {floor:.6f}; mel-corr drift "
            f"{v['mel_corr'] - mc_plain:+.4f} -> "
            + ("PASS (promotable)" if v["verdict"] == "PASS"
               else "FAIL (stays opt-in)"))
    log(f"per-utterance mel-corr over {seeds} seeds (mean +- std "
        f"[min..max]):")
    for i, name in enumerate(names):
        row = f"  {name:<14}"
        for r in routes:
            x = mc[r][:, i]
            row += (f"  {r}: {x.mean():.4f}+-{x.std():.4f} "
                    f"[{x.min():.4f}..{x.max():.4f}]")
        log(row)
    stats = {}
    for a, b in _delta_pairs(routes):
        d = (mc[a] - mc[b]).ravel()
        stats[f"{a}-{b}"] = dict(mean=float(d.mean()), std=float(d.std()),
                                 min=float(d.min()), max=float(d.max()))
        log(f"  paired {a} - {b}: {d.mean():+.4f} +- {d.std():.4f} "
            f"[{d.min():+.4f} .. {d.max():+.4f}]")
    return {"step": int(step), "seeds": seeds, "frames": int(res["frames"]),
            "per_route_seed_means": {r: mc[r].mean(axis=1).tolist()
                                     for r in routes},
            "paired_deltas": stats, "routes": routes}


def run_gate(cfg: Config, ckpt_dir: str, data_dir: str, *, seeds: int,
             frames: int, device, log=print) -> dict:
    """Steps 4-8 on a checkpoint and a preprocessed corpus: the JSON
    record (gate_spread's keys plus each route's scores, launches and
    verdict)."""
    params, step = load_params(ckpt_dir, cfg, compute_dtype=torch.bfloat16,
                               device=device)
    log(f"checkpoint step {step}")
    c, names = corpus_mels(data_dir, cfg, frames)
    res = score_routes(params, cfg, c, seeds, device, log=log)
    return report(res, names, step, seeds, log=log)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("workdir", nargs="?", default=None)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--config", default="tiny")
    p.add_argument("--ref_wavs", nargs="+", default=list(DEFAULT_WAVS),
                   help="a directory of wavs or wav files")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--logs_l2", type=float, default=None)
    p.add_argument("--logs_hinge", type=float, default=None)
    p.add_argument("--summary_interval", type=int, default=None)
    p.add_argument("--ckpt_dir", default=None,
                   help="score this checkpoint directory (skips training)")
    p.add_argument("--data_dir", default=None,
                   help="its preprocessed corpus (with --ckpt_dir)")
    p.add_argument("--seeds", type=int, default=1)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if (args.ckpt_dir is None) != (args.data_dir is None):
        p.error("--ckpt_dir and --data_dir go together")
    device = resolve_device(args.device)
    cfg = get_config(args.config)
    if args.batch_size is not None:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, batch_size=args.batch_size))
    for key in ("logs_l2", "logs_hinge"):
        if getattr(args, key) is not None:
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, **{key: getattr(args, key)}))
    if args.ckpt_dir is None:
        import tempfile
        work = args.workdir or tempfile.mkdtemp(prefix="fwn_gate_")
        os.makedirs(work, exist_ok=True)
        print(f"workdir: {work}")
        ckpt_dir, data_dir = train_model(
            cfg, work, ref_wav_list(args.ref_wavs), args.steps,
            args.summary_interval, device)
    else:
        ckpt_dir, data_dir = args.ckpt_dir, args.data_dir
    out = run_gate(cfg, ckpt_dir, data_dir, seeds=args.seeds,
                   frames=args.frames, device=device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
