"""The benchmark's plain reference and yardsticks against the measured
package on the CPU, in fp32 at the tiny presets: synthesis, the loss and
its gradients, DDI and the device noise; the FLOP count against a count by
hand; the weights' layout against the package's init."""

import dataclasses

import numpy as np
import pytest
import torch

from fwbench import flops, noise, weights
from fwbench.families import flowavenet as family
from fwbench.references import flowavenet as ref
from flowavenet_tpu_torch.config import get_config
from flowavenet_tpu_torch.models import flowavenet as fwn
from flowavenet_tpu_torch.synthesis.noise import row_noise
from flowavenet_tpu_torch.training.train_state import actnorm_hinge_penalty
from flowavenet_tpu_torch.utils.tree import leaves, tree_map


def _config(model: dict) -> dict:
    """A configuration file's sections that the yardsticks read."""
    return {"reference": "flowavenet", "model": model}


@pytest.fixture(params=["tiny", "tiny_gin"])
def setup(request, monkeypatch):
    cfg = get_config(request.param)
    m32 = dataclasses.replace(cfg.model, use_pallas=False)
    model = dataclasses.asdict(cfg.model)
    params = weights.make(_config(model), 7, "cpu")
    g = torch.Generator().manual_seed(1)
    frames = 16
    z = torch.randn(2, frames * cfg.audio.hop_size, generator=g) * 0.7
    mel = torch.rand(2, frames, cfg.model.num_mels, generator=g)
    spk = torch.tensor([1, 3]) if cfg.model.gin_channels > 0 else None
    monkeypatch.setattr(fwn, "PAIR_KERNEL_INT8", False)
    return m32, model, params, z, mel, spk


def test_layout_matches_the_package(setup):
    m32, model, params, *_ = setup
    pkg = fwn.init_flowavenet(torch.Generator().manual_seed(0), m32)
    assert [tuple(x.shape) for x in leaves(params)] == \
        [tuple(x.shape) for x in leaves(pkg)]
    assert weights.n_params(_config(model)) == \
        sum(x.numel() for x in leaves(pkg))


def test_reverse_matches_the_package(setup):
    m32, model, params, z, mel, spk = setup
    want = fwn.reverse(params, m32, z[..., None], mel, spk)[..., 0]
    got = ref.reverse(params, model, z, mel, spk)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())
    assert float(want.std()) > 0.05            # the couplings do work


def test_loss_gradients_and_ddi_match_the_package(setup):
    m32, model, params, z, mel, spk = setup
    x = ref.reverse(params, model, z, mel, spk)
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    tot, aux = fwn.loss_fn(p, m32, x[..., None], mel, spk, logs_hinge=1.0)
    tot = tot + actnorm_hinge_penalty(p)
    want = torch.autograd.grad(tot, leaves(p), allow_unused=True)
    flat = [t.detach().requires_grad_() for t in ref.leaves(params)]
    tot2, nll = ref.loss(ref.rebuild(params, iter(flat)), model, x, mel, spk)
    got = torch.autograd.grad(tot2, flat, allow_unused=True)
    assert abs(float(tot2) - float(tot)) < 1e-5
    assert abs(float(nll) - float(aux["loss"])) < 1e-5
    for a, b in zip(got, want):
        a = torch.zeros(1) if a is None else a
        b = torch.zeros(1) if b is None else b
        assert float((a - b).norm()) <= 1e-5 * float(b.norm()) + 1e-9
    d_pkg = fwn.ddi(params, m32, x[..., None], mel, spk)
    d_ref = ref.ddi(params, model, x, mel, spk)
    for a, b in zip(ref.leaves(d_ref), leaves(d_pkg)):
        assert float((a - b).abs().max()) < 1e-5


def test_row_blocks_give_the_whole_batch_step(setup):
    _, model, params, z, mel, spk = setup
    batch = {"audio": ref.reverse(params, model, z, mel, spk), "mel": mel}
    if spk is not None:
        batch["speaker"] = spk
    outs = []
    for rows in (None, 1):
        opt = ref.Adam(1e-3, 1.0, 0.9, 0.999, 1e-8)
        outs.append(ref.train_step(params, opt, model, batch, rows=rows))
    assert abs(outs[0][1] - outs[1][1]) < 1e-5
    for a, b in zip(outs[0][3], outs[1][3]):
        assert float((a - b).norm()) <= 1e-5 * float(b.norm()) + 1e-9


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 + 7, 2 ** 32 + 5])
def test_noise_is_the_device_stream(seed):
    got = noise.normal(seed, 20000)
    want = row_noise(np.array([seed % 2 ** 32]), np.array([1.0], np.float32),
                     20000, "cpu")[0, :, 0].numpy()
    assert np.abs(got - want).max() < 2e-6


def test_flops_of_one_flow_by_hand():
    """lj22k block 0 (level 1: 2 channels, 160 conditioning channels, the
    net reads 1 channel and 80 of them) per row of that level."""
    model = dataclasses.asdict(get_config("lj22k").model)
    R = 256
    hand = (2 * 3 * 1 * R                    # front
            + 2 * 2 * 3 * R * 2 * R          # filter|gate, two layers
            + 2 * 2 * 80 * 2 * R             # conditioning, two layers
            + 2 * 2 * R * R                  # skip, two layers
            + 2 * R * R                      # res, first layer
            + 2 * R * R + 2 * R * 2)         # final, zero
    per_row, g = family._net_flops(model, 1)
    assert per_row == hand and g == 0
    total = flops.model_flops(_config(model), 1.0, 0.0)
    assert 16.4e6 < total < 16.6e6
