"""PyTorch port, the audio frontend (``audio/mel.py``, ``audio/wavio.py``,
``audio/preprocessing.py``, ``audio/tacotron.py``): held against the JAX
package on ``tests/test_audio.py``'s cases and on corpora written here.
The numpy pipeline and the files it writes are bit- and byte-identical;
``mel_spectrogram_torch`` meets the JAX package's own bar for its device
mel (atol 2e-4, ``tests/test_audio.py``)."""

import os

import numpy as np
import pytest
import torch

from flowavenet_tpu.audio import mel as jmel
from flowavenet_tpu.audio import preprocessing as jpre
from flowavenet_tpu.audio import tacotron as jtaco
from flowavenet_tpu.audio import wavio as jwav
from flowavenet_tpu.config import (AudioConfig as JAudioConfig,
                                   Config as JConfig, DataConfig as JData,
                                   ModelConfig as JModel)
from flowavenet_tpu_torch.audio import mel as tmel
from flowavenet_tpu_torch.audio import preprocessing as tpre
from flowavenet_tpu_torch.audio import tacotron as ttaco
from flowavenet_tpu_torch.audio import wavio as twav
from flowavenet_tpu_torch.config import (AudioConfig as TAudioConfig,
                                         Config as TConfig,
                                         DataConfig as TData,
                                         ModelConfig as TModel)

JCFG, TCFG = JAudioConfig(), TAudioConfig()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# every numpy function of mel.py on tests/test_audio.py's inputs
NUMPY_CASES = {
    "hann_window": lambda m: m.hann_window(8),
    "hann_window_1024": lambda m: m.hann_window(1024),
    "hz_to_mel": lambda m: m.hz_to_mel(
        np.array([0.0, 125.0, 999.0, 1000.0, 4000.0, 7600.0, 11025.0])),
    "mel_to_hz": lambda m: m.mel_to_hz(m.hz_to_mel(
        np.array([0.0, 125.0, 999.0, 1000.0, 4000.0, 7600.0, 11025.0]))),
    "mel_filterbank": lambda m: m.mel_filterbank(22050, 1024, 80, 125.0,
                                                 7600.0),
    "mel_filterbank_8k": lambda m: m.mel_filterbank(8000, 512, 80, 125.0,
                                                    4000.0),
    "stft_power": lambda m: m.stft_power(
        np.random.RandomState(0).randn(4096).astype(np.float32), 512, 128),
    "normalize_mel": lambda m: m.normalize_mel(
        np.array([[1e-6, 1e-4, 1.0, 10.0]], np.float32),
        JCFG if m is jmel else TCFG),
    "mel_spectrogram": lambda m: m.mel_spectrogram(
        np.random.RandomState(2).randn(4096).astype(np.float32),
        JCFG if m is jmel else TCFG),
}


@pytest.mark.parametrize("case", sorted(NUMPY_CASES))
def test_numpy_mel_functions_are_bit_identical(case):
    _same(NUMPY_CASES[case](tmel), NUMPY_CASES[case](jmel))


@pytest.mark.parametrize("n", [5000, 255, 256, 8191, 22050])
def test_process_wav_is_bit_identical(n):
    wav = np.random.RandomState(n).randn(n).astype(np.float32)
    (ta, tm), (ja, jm) = tmel.process_wav(wav, TCFG), jmel.process_wav(
        wav, JCFG)
    _same(ta, ja)
    _same(tm, jm)
    assert len(ta) == tm.shape[0] * TCFG.hop_size


@pytest.mark.parametrize("B,T", [(2, 4096), (1, 5000), (3, 1000)])
def test_mel_spectrogram_torch_matches_jax(B, T):
    """The device mel on the CPU against mel_spectrogram_jax and the numpy
    pipeline, to the JAX package's bar for its own device mel."""
    wav = np.random.RandomState(B * T).randn(B, T).astype(np.float32)
    got = tmel.mel_spectrogram_torch(torch.from_numpy(wav), TCFG).numpy()
    want = np.asarray(jmel.mel_spectrogram_jax(wav, JCFG))
    ref = np.stack([jmel.normalize_mel(jmel.mel_spectrogram(w, JCFG), JCFG)
                    for w in wav])
    assert got.shape == want.shape == ref.shape
    np.testing.assert_allclose(got, want, atol=2e-4)
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_is_bit_identical(tmp_path, width, channels):
    """PCM of 8, 16 and 32 bits, mono and stereo (written with the stdlib
    ``wave`` module), read by both packages."""
    import wave
    rng = np.random.RandomState(width * 10 + channels)
    if width == 1:
        raw = rng.randint(0, 256, 300 * channels).astype(np.uint8)
    else:
        raw = rng.randint(-2 ** (8 * width - 1), 2 ** (8 * width - 1),
                          300 * channels).astype(f"<i{width}")
    p = str(tmp_path / "x.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(16000)
        w.writeframes(raw.tobytes())
    (td, tsr), (jd, jsr) = twav.read_wav(p), jwav.read_wav(p)
    assert tsr == jsr == 16000 and len(td) == 300
    _same(td, jd)


def test_write_wav_is_byte_identical(tmp_path):
    y = np.clip(np.random.RandomState(3).randn(1000) * 0.5, -1.2, 1.2)
    twav.write_wav(str(tmp_path / "t.wav"), y, 22050)
    jwav.write_wav(str(tmp_path / "j.wav"), y, 22050)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav"
                                                  ).read_bytes()


@pytest.mark.parametrize("rates", [(22050, 22050), (16000, 8000),
                                   (44100, 22050), (8000, 22050)])
def test_resample_and_load_audio_are_bit_identical(tmp_path, rates):
    orig, target = rates
    y = np.random.RandomState(4).randn(8000).astype(np.float32)
    _same(twav.resample(y, orig, target), jwav.resample(y, orig, target))
    if orig == target:
        assert twav.resample(y, orig, target) is y
    p = str(tmp_path / "a.wav")
    jwav.write_wav(p, 0.3 * y, orig)
    _same(twav.load_audio(p, target), jwav.load_audio(p, target))


def _corpus(root, speakers=None, n=3, sr=8000):
    """An LJSpeech-layout corpus of ``n`` utterances (per speaker when
    ``speakers`` is given: ``root/<speaker>/book1``)."""
    rng = np.random.RandomState(0)
    for s, speaker in enumerate(speakers or [None]):
        book = root / speaker / "book1" if speaker else root / "book1"
        (book / "wavs").mkdir(parents=True)
        lines = []
        for i in range(n):
            wav = 0.4 * np.sin(np.linspace(0, 50 + 10 * i + 20 * s,
                                           3000 + 333 * i))
            wav = (wav + 0.05 * rng.randn(len(wav))).astype(np.float32)
            jwav.write_wav(str(book / "wavs" / f"utt{i:03d}.wav"), wav, sr)
            lines.append(f"utt{i:03d}|x|hello world {i}")
        (book / "metadata.csv").write_text("\n".join(lines))


def _tree_bytes(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files}


def _cfgs(gin: int = 0):
    audio = dict(sample_rate=8000, n_fft=256, hop_size=64, fmin=50,
                 fmax=3800)
    return (JConfig(audio=JAudioConfig(**audio),
                    model=JModel(gin_channels=gin, n_speakers=2),
                    data=JData(test_size=2)),
            TConfig(audio=TAudioConfig(**audio),
                    model=TModel(gin_channels=gin, n_speakers=2),
                    data=TData(test_size=2)))


@pytest.mark.parametrize("speakers", [None, ["alice", "bob"]],
                         ids=["one_speaker", "two_speakers"])
def test_preprocess_writes_the_jax_packages_files(tmp_path, speakers):
    """preprocess (one worker) on a 3-utterance corpus (two speakers: 3
    each, with speakers.txt): audios/*.npy, mels/*.npy, train.txt and the
    train/test records are byte-identical to the JAX package's."""
    _corpus(tmp_path / "corpus", speakers)
    jcfg, tcfg = _cfgs(16 if speakers else 0)
    jmeta = jpre.preprocess(str(tmp_path / "corpus"), str(tmp_path / "j"),
                            jcfg, num_workers=1)
    tmeta = tpre.preprocess(str(tmp_path / "corpus"), str(tmp_path / "t"),
                            tcfg, num_workers=1)
    assert tmeta == jmeta
    jfiles, tfiles = (_tree_bytes(tmp_path / d) for d in ("j", "t"))
    assert sorted(tfiles) == sorted(jfiles)
    assert {"train.txt", "train.fwrec", "test.fwrec",
            "train.fwidx.npy"} <= set(tfiles)
    if speakers:
        assert tfiles["speakers.txt"] == b"alice - 0\nbob - 1\n"
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name


def test_walk_corpus_matches_jax(tmp_path):
    _corpus(tmp_path / "c1")
    _corpus(tmp_path / "c2", ["alice", "bob"])
    assert (list(tpre.walk_corpus(str(tmp_path / "c1"), False))
            == list(jpre.walk_corpus(str(tmp_path / "c1"), False)))
    assert (list(tpre.walk_corpus(str(tmp_path / "c2"), True))
            == list(jpre.walk_corpus(str(tmp_path / "c2"), True)))


def test_tacotron_records_are_byte_identical(tmp_path):
    """adapt_gta_mel, align_audio and build_records (3 pairs, one audio
    shorter than its mel, one longer; GTA mels beyond [-4, 4]), and the
    CLI, against the JAX package's."""
    rng = np.random.RandomState(5)
    (tmp_path / "audio").mkdir()
    (tmp_path / "gta").mkdir()
    pairs = []
    for i, (frames, samples) in enumerate([(20, 20 * 256 - 100),
                                           (15, 15 * 256 + 300),
                                           (31, 31 * 256)]):
        a = str(tmp_path / "audio" / f"dataset-audio-{i:05d}.npy")
        m = str(tmp_path / "gta" / f"dataset-mel-{i:05d}.npy")
        np.save(a, (0.1 * rng.randn(samples)).astype(np.float32))
        np.save(m, (5.0 * rng.randn(frames, 80)).astype(np.float32))
        pairs.append((a, m, 0))
        _same(ttaco.adapt_gta_mel(np.load(m)), jtaco.adapt_gta_mel(np.load(m)))
        _same(ttaco.align_audio(np.load(a), frames, 256),
              jtaco.align_audio(np.load(a), frames, 256))
    from flowavenet_tpu.config import lj22k as jlj22k
    from flowavenet_tpu_torch.config import lj22k as tlj22k
    jtaco.build_records(pairs, str(tmp_path / "j"), jlj22k())
    ttaco.build_records(pairs, str(tmp_path / "t"), tlj22k())
    args = ["--audio_dir", str(tmp_path / "audio"), "--gta_dir",
            str(tmp_path / "gta")]
    jtaco.main(args + ["--out_dir", str(tmp_path / "jcli")])
    ttaco.main(args + ["--out_dir", str(tmp_path / "tcli")])
    for j, t in (("j", "t"), ("jcli", "tcli")):
        jfiles, tfiles = _tree_bytes(tmp_path / j), _tree_bytes(tmp_path / t)
        assert sorted(jfiles) == sorted(tfiles) and len(jfiles) == 4
        for name in jfiles:
            assert tfiles[name] == jfiles[name], (t, name)
