"""Tacotron-2 GTA mel adaptation (twin of
``flowavenet_tpu/audio/tacotron.py``), on the host with numpy:

    python -m flowavenet_tpu_torch.audio.tacotron --audio_dir audios \\
        --gta_dir gta --out_dir gta_data

Ground-truth-aligned mels of a Tacotron-2 teacher live in [-4, 4]; they
are rescaled into the [0, 1] conditioning convention (``clip(mel, -4, 4);
(mel + 4) / 8``), the paired audio is aligned, and train/test FwRecords
are written so the vocoder can be fine-tuned on them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import Config, get_config
from ..data.records import FwRecordWriter, train_test_split_indices


def adapt_gta_mel(mel: np.ndarray) -> np.ndarray:
    """[-4, 4] Tacotron GTA mel -> [0, 1] FloWaveNet conditioning."""
    return ((np.clip(mel, -4.0, 4.0) + 4.0) / 8.0).astype(np.float32)


def align_audio(audio: np.ndarray, mel_frames: int, hop: int) -> np.ndarray:
    """Pad/trim audio to exactly mel_frames * hop samples."""
    target = mel_frames * hop
    if len(audio) < target:
        audio = np.pad(audio, (0, target - len(audio)))
    return audio[:target].astype(np.float32)


def build_records(pairs: list[tuple[str, str, int]], out_dir: str,
                  cfg: Config) -> tuple[str, str]:
    """pairs: (audio_npy_path, gta_mel_npy_path, speaker_id)."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(pairs)
    test_size = min(cfg.data.test_size, max(1, n // 5))
    train_idx, test_idx = train_test_split_indices(
        n, test_size, cfg.data.split_random_state)
    paths = []
    for name, indices in (("train.fwrec", train_idx),
                          ("test.fwrec", test_idx)):
        path = os.path.join(out_dir, name)
        with FwRecordWriter(path) as w:
            for i in indices:
                audio_p, mel_p, sid = pairs[i]
                mel = adapt_gta_mel(np.load(mel_p))
                audio = align_audio(np.load(audio_p), mel.shape[0],
                                    cfg.audio.hop_size)
                w.write(audio, mel, sid)
        paths.append(path)
    return paths[0], paths[1]


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Adapt Tacotron-2 GTA mels into FloWaveNet records "
                    "(PyTorch port)")
    p.add_argument("--audio_dir", required=True,
                   help="dir of audio .npy (from flowavenet-torch-preprocess)")
    p.add_argument("--gta_dir", required=True,
                   help="dir of Tacotron GTA mel .npy (matching stems)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--config", default="lj22k")
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(args.gta_dir)
                   if f.endswith(".npy"))
    pairs = []
    for s in stems:
        ap = os.path.join(args.audio_dir, s.replace("mel", "audio") + ".npy")
        if not os.path.exists(ap):
            ap = os.path.join(args.audio_dir, s + ".npy")
        if not os.path.exists(ap):
            print(f"skip {s}: no matching audio")
            continue
        pairs.append((ap, os.path.join(args.gta_dir, s + ".npy"), 0))
    if not pairs:
        raise FileNotFoundError("no audio/GTA-mel pairs found")
    tr, te = build_records(pairs, args.out_dir, cfg)
    print(f"Wrote {tr} and {te} from {len(pairs)} GTA pairs")


if __name__ == "__main__":
    main()
