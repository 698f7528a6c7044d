"""Offline corpus preprocessing CLI (twin of
``flowavenet_tpu/audio/preprocessing.py``), on the host with numpy:

    python -m flowavenet_tpu_torch.audio.preprocessing --in_dir LJSpeech \\
        --out_dir training_data --config lj22k

* corpus walk: ``in_dir/<book>/metadata.csv`` + ``wavs/*.wav`` rows
  ``id|_|text``; multi-speaker layout ``in_dir/<speaker>/<book>/...`` when
  ``gin_channels > 0`` (writes ``speakers.txt``);
* per utterance: load -> peak-normalize -> normalized mel -> pad/trim
  (``audio/mel.py``) -> paired ``audios/*.npy`` + ``mels/*.npy``;
* ``train.txt`` metadata rows ``audio|mel|timesteps|speaker_id|text``;
* train/test FwRecords with the reference's split (test_size=10,
  random_state=123).

The files are byte-identical to the JAX package's: the mels come from the
numpy pipeline, so this CLI runs no device work.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..config import AudioConfig, Config, get_config
from ..data.records import FwRecordWriter, train_test_split_indices
from .mel import process_wav
from .wavio import load_audio


def _process_utterance(out_dir: str, index: int, wav_path: str, text: str,
                       speaker_id: int, cfg: AudioConfig):
    wav = load_audio(wav_path, cfg.sample_rate)
    out, mel = process_wav(wav, cfg)
    audio_filename = f"dataset-audio-{index:05d}.npy"
    mel_filename = f"dataset-mel-{index:05d}.npy"
    np.save(os.path.join(out_dir, "audios", audio_filename), out,
            allow_pickle=False)
    np.save(os.path.join(out_dir, "mels", mel_filename), mel,
            allow_pickle=False)
    return audio_filename, mel_filename, len(out), speaker_id, text


def walk_corpus(in_dir: str, multi_speaker: bool,
                speakers_txt: str | None = None):
    """Yield (speaker_id, wav_path, text) rows of an LJSpeech-layout
    corpus."""
    if multi_speaker:
        speakers = sorted(f for f in os.listdir(in_dir)
                          if os.path.isdir(os.path.join(in_dir, f)))
        books = []
        lines = []
        for i, speaker in enumerate(speakers):
            lines.append(f"{speaker} - {i}\n")
            sdir = os.path.join(in_dir, speaker)
            for book in sorted(os.listdir(sdir)):
                if os.path.isdir(os.path.join(sdir, book)):
                    books.append((i, os.path.join(sdir, book)))
        if speakers_txt:
            with open(speakers_txt, "wt", encoding="utf-8") as f:
                f.writelines(lines)
    else:
        books = [(0, os.path.join(in_dir, f))
                 for f in sorted(os.listdir(in_dir))
                 if os.path.isdir(os.path.join(in_dir, f))]

    for speaker_id, book in books:
        meta_path = os.path.join(book, "metadata.csv")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path, encoding="utf-8") as f:
            for line in f.read().strip().split("\n"):
                parts = line.strip().split("|")
                wav_path = os.path.join(book, "wavs", f"{parts[0]}.wav")
                text = parts[2] if len(parts) > 2 else ""
                yield speaker_id, wav_path, text


def preprocess(in_dir: str, out_dir: str, cfg: Config,
               num_workers: int | None = None) -> list:
    """Process every utterance of ``in_dir`` into ``out_dir`` (worker
    processes start by ``spawn``), then write the metadata and records."""
    os.makedirs(os.path.join(out_dir, "audios"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "mels"), exist_ok=True)
    multi_speaker = cfg.model.gin_channels > 0
    rows = list(walk_corpus(in_dir, multi_speaker,
                            os.path.join(out_dir, "speakers.txt")
                            if multi_speaker else None))
    num_workers = num_workers or os.cpu_count() or 1
    metadata = []
    with ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = [
            ex.submit(_process_utterance, out_dir, i + 1, wav_path, text,
                      sid, cfg.audio)
            for i, (sid, wav_path, text) in enumerate(rows)]
        for fu in futures:
            metadata.append(fu.result())
    write_metadata(metadata, out_dir, cfg)
    return metadata


def write_metadata(metadata: list, out_dir: str, cfg: Config) -> None:
    with open(os.path.join(out_dir, "train.txt"), "w", encoding="utf-8") as f:
        for m in metadata:
            f.write("|".join(str(x) for x in m) + "\n")
    frames = sum(m[2] for m in metadata)
    sr = cfg.audio.sample_rate
    print(f"Wrote {len(metadata)} utterances, {frames} time steps "
          f"({frames / sr / 3600:.2f} hours)")
    create_records(os.path.join(out_dir, "train.txt"), cfg)


def create_records(metadata_path: str, cfg: Config) -> tuple[str, str]:
    """train/test FwRecords from a metadata file."""
    basedir = os.path.dirname(metadata_path)
    with open(metadata_path, encoding="utf-8") as f:
        metadata = [line.strip().split("|") for line in f if line.strip()]
    n = len(metadata)
    # cap the held-out set on tiny corpora so train keeps the majority
    test_size = min(cfg.data.test_size, max(1, n // 5))
    train_idx, test_idx = train_test_split_indices(
        n, test_size, cfg.data.split_random_state)

    paths = []
    for name, indices in (("train.fwrec", train_idx), ("test.fwrec", test_idx)):
        path = os.path.join(basedir, name)
        with FwRecordWriter(path) as w:
            for i in indices:
                audio_f, mel_f, _, sid, _ = metadata[i][:5]
                audio = np.load(os.path.join(basedir, "audios", audio_f))
                mel = np.load(os.path.join(basedir, "mels", mel_f))
                w.write(audio, mel, int(sid))
        paths.append(path)
    print(f"Wrote {paths[0]} ({len(train_idx)}) and {paths[1]} "
          f"({len(test_idx)})")
    return paths[0], paths[1]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="FloWaveNet corpus preprocessing (PyTorch port; host "
                    "numpy, the JAX package's files byte for byte)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--in_dir", "-i", type=str, default="./")
    parser.add_argument("--out_dir", "-o", type=str, default="./")
    parser.add_argument("--config", type=str, default="lj22k",
                        help="preset: lj22k | lj8k | lj8k_gin | tiny")
    parser.add_argument("--num_workers", type=int, default=None)
    args = parser.parse_args(argv)
    preprocess(args.in_dir, args.out_dir, get_config(args.config),
               args.num_workers)


if __name__ == "__main__":
    main()
