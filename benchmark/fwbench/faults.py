"""Faults planted under the timed path, to show that the comparison catches
them (the benchmark's tests and ``readings.py --fault``):

* ``unchanged_state``: the train step returns the state it was given;
* ``half_batch``: the train step sees the first half of the batch's rows
  (its loss is the mean over those); a synthesis dispatch keeps the first
  half of its rows (rounded down) and returns silence for the rest;
* ``altered_answer``: a synthesis dispatch returns each row with its
  middle sample moved by 8192 steps of 16-bit audio.

The cells run on one card, so there is no exchange between cards to leave
out.
"""

from __future__ import annotations

import contextlib

NAMES = ("unchanged_state", "half_batch", "altered_answer")


def _synth_patch(orig, name: str):
    def dispatch(params, cfg, mels, *a, **kw):
        wav, frames = orig(params, cfg, mels, *a, **kw)
        n = len(mels)
        if name == "half_batch":
            wav[n // 2: n] = 0
        else:
            for r in range(n):
                i = frames[r] * cfg.audio.hop_size // 2
                moved = int(wav[r, i]) + 8192
                wav[r, i] = moved - 16384 if moved > 32767 else moved
        return wav, frames
    return dispatch


def _train_patch(orig, name: str):
    def make(cfg, *a, **kw):
        step = orig(cfg, *a, **kw)

        def train_step(state, batch):
            if name == "half_batch":
                half = batch["audio"].shape[0] // 2
                return step(state, {k: v[:half] for k, v in batch.items()})
            _, metrics = step(state, batch)
            return state, metrics
        return train_step
    return make


@contextlib.contextmanager
def planted(name: str):
    """Plant fault ``name`` ("" plants none) while the block runs."""
    if not name:
        yield
        return
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; choose from {NAMES}")
    from flowavenet_tpu_torch.serving import server
    from flowavenet_tpu_torch.synthesis import synthesize
    from flowavenet_tpu_torch.training import train_state
    saved = [(synthesize, "dispatch_mels"), (server, "dispatch_mels"),
             (train_state, "make_train_step")]
    old = [getattr(m, a) for m, a in saved]
    try:
        if name in ("half_batch", "altered_answer"):
            synthesize.dispatch_mels = _synth_patch(old[0], name)
            server.dispatch_mels = _synth_patch(old[1], name)
        if name in ("unchanged_state", "half_batch"):
            train_state.make_train_step = _train_patch(old[2], name)
        yield
    finally:
        for (m, a), o in zip(saved, old):
            setattr(m, a, o)
