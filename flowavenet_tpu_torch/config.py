"""Configuration for the PyTorch port of FloWaveNet.

A standalone copy of ``flowavenet_tpu/config.py``: the same frozen
dataclasses, presets and JSON round trip, so a config written by either
package loads in the other.  The port keeps its own copy because it may
not import ``flowavenet_tpu`` (whose package import pulls in JAX).

In the port, ``ModelConfig.use_pallas`` selects the hand-written CUDA pair
kernels (``ops/pair_flow.py``) on the blocks they cover; ``False`` runs the
plain pair-scan everywhere.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class AudioConfig:
    """Audio / mel-spectrogram frontend (reference hparams.py:13-31)."""

    sample_rate: int = 22050
    num_mels: int = 80
    n_fft: int = 1024
    hop_size: int = 256
    fmin: float = 125.0
    fmax: float = 7600.0
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    rescaling_max: float = 0.999


@dataclass(frozen=True)
class ModelConfig:
    """Flow model shape (reference hparams.py:38-49, model.py:282-314)."""

    n_block: int = 8
    n_flow: int = 6
    n_layer: int = 2
    affine: bool = True
    causal: bool = False          # reference key: ``causality`` (model.py:297)
    filter_size: int = 256        # hard-coded 256 in reference (model.py:217)
    num_mels: int = 80
    upsample_scales: tuple[int, ...] = (16, 16)
    gin_channels: int = -1        # <=0 disables global (speaker) conditioning
    n_speakers: int = 7
    # Reference bug (modules.py:188-189): WaveNet.__call__ drops ``g`` so global
    # conditioning never reaches the coupling nets.  We fix it; set True to
    # reproduce the reference's behaviour bit-for-bit.
    parity_drop_global_cond: bool = False
    # Route synthesis (reverse) through the fused pair-flow kernel on the
    # blocks it covers (the name is kept from the JAX package so configs
    # round-trip between the two).
    use_pallas: bool = True
    # Recompute each flow step in the backward pass instead of keeping its
    # activations (torch.utils.checkpoint in the port): less device memory
    # per step for more arithmetic.  No effect on numerics or inference.
    remat: bool = True
    # With remat on, rematerialize only the first N blocks' flow steps
    # (-1 = all).  The deep blocks' activations shrink geometrically
    # (time halves per block while the coupling nets stay 256-wide), so
    # saving them costs little HBM while deleting their backward-pass
    # recompute — a remat-policy middle ground between full recompute
    # and the OOM of no remat at large batch (tools/bench_train_phases).
    remat_blocks: int = -1
    # Soft bound on every coupling's log_s: log_s' = B * tanh(log_s / B)
    # (0.0 = off = exact reference family).  Bounds the per-flow scale to
    # exp(±B) in BOTH directions, so the flow stays invertible and the
    # logdet uses the bounded value — a structural fix for the measured
    # flagship divergence mode (unbounded log_s growth on an overfit
    # corpus, docs/benchmarks.md).  Changes the model family: checkpoints
    # are only compatible across equal values, and the fused pair kernels
    # (which bake exp(log_s) in-kernel) are bypassed when set: synthesis
    # and training run the plain scans.
    logs_clamp: float = 0.0

    @property
    def hop_size(self) -> int:
        h = 1
        for s in self.upsample_scales:
            h *= s
        return h

    @property
    def squeeze_factor(self) -> int:
        return 2 ** self.n_block


@dataclass(frozen=True)
class DataConfig:
    """Input pipeline (reference hparams.py:28-36, dataset.py)."""

    max_time_steps: int = 6400     # training crop length in audio samples
    batch_size: int = 8            # per-replica batch (reference: per tower)
    test_size: int = 10
    split_random_state: int = 123
    shuffle_buffer: int = 64
    eval_max_time_steps: int = 22050 * 4


@dataclass(frozen=True)
class TrainConfig:
    """Optimization (reference train.py:15-32, hparams.py:9-10)."""

    learning_rate: float = 1e-3
    # (boundary_step, divisor) applied as in train.py:17-20
    lr_boundaries: tuple[tuple[int, float], ...] = (
        (200_000, 2.0), (400_000, 4.0), (600_000, 6.0))
    grad_clip_norm: float = 1.0
    # Skip the optimizer apply when the loss or any gradient is non-finite
    # (params/opt state pass through unchanged; the step counter still
    # advances and metrics report skipped_nonfinite=1).  Motivated by a
    # measured flagship divergence: overfit logdet growth produced a NaN
    # step that poisoned params irrecoverably (docs/benchmarks.md, the
    # lj22k gate note).  A skipped step is recoverable; NaN params are not.
    # In the port the skip is a torch.where per parameter and optimizer
    # leaf inside the step, with no host readback.
    skip_nonfinite_updates: bool = True
    # L2 penalty weight on the couplings' log_s outputs (mean of log_s^2
    # added to the NLL; 0.0 = off).  Training-only — the model family and
    # synthesis are untouched.  Counteracts the measured divergence mode
    # where -mean(log_s) grows without bound chasing logdet on an overfit
    # corpus; metrics log the penalty and max|log_s| so the dynamics are
    # observable either way (training/train_state.py).
    logs_l2: float = 0.0
    # Hinge-squared penalty weight on |log_s| past LOGS_HINGE_MARGIN
    # (flowavenet.py; 5.0, env FWN_HINGE_MARGIN).  EXACTLY ZERO in the
    # healthy regime (measured runs keep max|log_s| < 4 while stable), so
    # it is safe on by default; normalized like the logdet, so weight w
    # stalls the measured runaway at |log_s| = margin + 1/(2w).  Chosen
    # over logs_l2 after a 50k flagship run diverged UNDER logs_l2=0.1:
    # the L2 pressures mean(log_s^2) (2.3 at blow-up) while the MAX ran
    # 19 -> 36 (docs/benchmarks.md, divergence study).  Training-only —
    # the model family, checkpoints, and synthesis are untouched.
    logs_hinge: float = 1.0
    # Same dead-zone hinge applied to the ActNorm SCALES (|3*logs| past
    # LOGS_HINGE_MARGIN; parameters, not activations, so it costs one tiny
    # reduction in the train step).  Motivated by the round-4 50k flagship
    # telemetry: actnorm_max_logs3 climbed monotonically 1.92 -> 3.20 with
    # no plateau while the coupling hinge held log_s — the next slow-burn
    # divergence candidate.  EXACTLY ZERO below the margin, so guarded
    # runs are bit-identical to unguarded ones until a scale actually
    # runs away; normalized per-channel like the ActNorm logdet
    # (sum relu(|3 logs|-m)^2 / C_level), so weight w stalls growth at
    # |3*logs| = margin + 1/(2w).  Training-only.
    actnorm_hinge: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    train_steps: int = 2_000_000
    # bf16 compute / fp32 params replaces the reference's fp16 + static loss
    # scaling (utils.py:3-31, train.py:64,77): bf16 keeps fp32's exponent
    # range, so no loss scale is needed.
    compute_dtype: str = "bfloat16"
    seed: int = 75                 # reference tf_random_seed (hparams.py:47)
    temp: float = 0.7              # synthesis noise temperature (hparams.py:48)
    summary_interval: int = 500
    checkpoint_interval: int = 2000
    eval_interval: int = 5000


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for SPMD (replaces tower replication, train.py:35-83)."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1: use all devices on the data axis, model axis size 1.
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)

        def _mk(cls, dd):
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kw = {}
            for k, v in dd.items():
                if k not in fields:
                    continue
                if isinstance(v, list):
                    v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
                kw[k] = v
            return cls(**kw)

        return Config(
            audio=_mk(AudioConfig, d.get("audio", {})),
            model=_mk(ModelConfig, d.get("model", {})),
            data=_mk(DataConfig, d.get("data", {})),
            train=_mk(TrainConfig, d.get("train", {})),
            mesh=_mk(MeshConfig, d.get("mesh", {})),
        )


def lj22k() -> Config:
    """Default 22.05 kHz profile == reference hparams.py."""
    return Config()


def lj8k() -> Config:
    """8 kHz profile == reference hparams8000.py:18-49."""
    return Config(
        audio=AudioConfig(sample_rate=8000, n_fft=512, hop_size=96,
                          fmax=4000.0),
        model=ModelConfig(n_block=5, upsample_scales=(8, 12)),
        data=DataConfig(max_time_steps=2320),
    )


def lj8k_gin() -> Config:
    """8 kHz multi-speaker profile: hparams8000.py with global (speaker)
    conditioning enabled (reference hparams.py:39-40: gin_channels=256 when
    on, n_speakers=7; BASELINE.json configs[2])."""
    base = lj8k()
    return base.replace(
        model=dataclasses.replace(base.model, gin_channels=256,
                                  n_speakers=7))


def tiny() -> Config:
    """Tiny config for tests and the end-to-end smoke slice
    (BASELINE.json configs[0]: 2 blocks x 2 flows)."""
    return Config(
        audio=AudioConfig(),
        model=ModelConfig(n_block=2, n_flow=2, n_layer=2, filter_size=32),
        data=DataConfig(max_time_steps=2048, batch_size=2),
        train=TrainConfig(compute_dtype="float32"),
    )


def tiny_gin() -> Config:
    """Tiny profile with global (speaker) conditioning — fast gin smoke
    tests and the CPU leg of tools/gin_study.py."""
    base = tiny()
    return base.replace(
        model=dataclasses.replace(base.model, gin_channels=16,
                                  n_speakers=4))


PRESETS = {"lj22k": lj22k, "lj8k": lj8k, "lj8k_gin": lj8k_gin,
           "tiny": tiny, "tiny_gin": tiny_gin}


def get_config(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; choose from {sorted(PRESETS)}")
    return PRESETS[name]()
