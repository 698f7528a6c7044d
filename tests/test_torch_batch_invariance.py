"""PyTorch port, synthesis rows that do not follow their batch companions:
the coupling nets' dilated convs run as one GEMM over their taps
(``ops/conv.py:dilated_conv1d``), which gives the conv's result (fp64
here, to rounding) in place of cuDNN, whose algorithm, and so a row's
bits, follows the batch size on the card; the compute-dtype conditioning
products run one row at a time (``conv1x1(per_row=True)``), as cuBLAS
splits their long K by the number of rows.  The card's own check is
``tests/test_torch_card.py::test_synthesis_row_does_not_follow_its_companions``.
No JAX here."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flowavenet_tpu_torch.config import tiny
from flowavenet_tpu_torch.models import flowavenet as fwn
from flowavenet_tpu_torch.ops import conv


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which stall
    when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("dilation,T", [(1, 40), (3, 40), (9, 40), (9, 5)])
def test_conv_as_gemm_is_the_conv(causal, dilation, T):
    """fp64, bias, 3 taps: the GEMM over the taps against F.conv1d with the
    same padding, including a T shorter than the dilated receptive
    field."""
    g = torch.Generator().manual_seed(dilation * T)
    x = torch.randn(3, T, 7, generator=g, dtype=torch.float64)
    k = torch.randn(3, 7, 5, generator=g, dtype=torch.float64)
    b = torch.randn(5, generator=g, dtype=torch.float64)
    pad = (2 * dilation, 0) if causal else (dilation, dilation)
    want = F.conv1d(F.pad(x.transpose(1, 2), pad), k.permute(2, 1, 0), b,
                    dilation=dilation).transpose(1, 2)
    got = conv.dilated_conv1d(x, k, b, dilation, causal)
    assert got.shape == want.shape == (3, T, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


def test_conv_as_gemm_rows_are_their_own(monkeypatch):
    """Each output row depends on its own input row only (a row of zeros
    beside it changes nothing), and the GEMM is the one product run."""
    calls = []
    mm = torch.matmul
    monkeypatch.setattr(torch, "matmul",
                        lambda a, b: calls.append(a.shape) or mm(a, b))
    x = torch.randn(2, 30, 4, dtype=torch.float64)
    k = torch.randn(3, 4, 6, dtype=torch.float64)
    both = conv.dilated_conv1d(x, k, None, 3)
    alone = conv.dilated_conv1d(x[:1], k, None, 3)
    assert calls == [(2, 30, 12), (1, 30, 12)]
    np.testing.assert_array_equal(both[:1].numpy(), alone.numpy())


def _spy_conv1d(monkeypatch):
    seen = []
    real = F.conv1d
    monkeypatch.setattr(F, "conv1d",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    return seen


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_no_cudnn_conv_in_either_direction(monkeypatch, causal):
    """tiny on the plain route (use_pallas=False, every block a plain
    pair-scan): neither ``reverse`` nor ``loss_fn`` with its gradient calls
    F.conv1d, and the gradient reaches the first coupling net's front
    conv."""
    import dataclasses
    cfg = dataclasses.replace(tiny().model, use_pallas=False, causal=causal)
    gen = torch.Generator().manual_seed(5)
    params = fwn.init_flowavenet(gen, cfg)
    for bp in params["blocks"]:
        bp["flows"]["coupling"]["zero"]["w"].normal_(0, 0.05, generator=gen)
    z = torch.randn(2, 1024, 1, generator=gen, dtype=torch.float64)
    c = torch.rand(2, 4, cfg.num_mels, generator=gen, dtype=torch.float64)
    seen = _spy_conv1d(monkeypatch)
    x = fwn.reverse(params, cfg, z, c, compute_dtype=torch.float64)
    v = params["blocks"][0]["flows"]["coupling"]["front"]["v"]
    v.requires_grad_()
    total, _ = fwn.loss_fn(params, cfg, x, c, compute_dtype=torch.float64)
    total.backward()
    assert seen == []
    assert v.grad is not None and bool(torch.isfinite(v.grad).all())
    assert float(v.grad.abs().max()) > 0


def test_plain_reverse_row_equals_itself_alone_in_fp64():
    """On the CPU in fp64 the plain route's row beside two companions
    equals the row alone to rounding (the card holds bf16 to identity)."""
    import dataclasses
    cfg = dataclasses.replace(tiny().model, use_pallas=False)
    gen = torch.Generator().manual_seed(6)
    params = fwn.init_flowavenet(gen, cfg)
    z = torch.randn(3, 1024, 1, generator=gen, dtype=torch.float64)
    c = torch.rand(3, 4, cfg.num_mels, generator=gen, dtype=torch.float64)
    both = fwn.reverse(params, cfg, z, c, compute_dtype=torch.float64)
    alone = fwn.reverse(params, cfg, z[1:2], c[1:2],
                        compute_dtype=torch.float64)
    np.testing.assert_allclose(both[1:2].numpy(), alone.numpy(), rtol=0,
                               atol=1e-12)


def test_conv1x1_per_row_is_one_matmul_per_row(monkeypatch):
    calls = []
    mm = torch.matmul
    monkeypatch.setattr(torch, "matmul",
                        lambda a, b: calls.append(tuple(a.shape)) or mm(a, b))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 20, 40, generator=g, dtype=torch.float64)
    k = torch.randn(1, 40, 8, generator=g, dtype=torch.float64)
    b = torch.randn(8, generator=g, dtype=torch.float64)
    got = conv.conv1x1(x, k, b, per_row=True)
    assert calls == [(1, 20, 40)] * 3
    want = conv.conv1x1(x, k, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_dilated_conv1d_per_row_is_one_gemm_per_row(monkeypatch, causal):
    """``per_row=True``: one tap GEMM per row, the batched result in fp64;
    ``apply_wavenet(per_row=True)`` (synthesis) runs its front conv one
    row at a time and its layer convs batched, and by default (training)
    the front conv batched too."""
    from flowavenet_tpu_torch.models import modules
    g = torch.Generator().manual_seed(9)
    x = torch.randn(3, 25, 4, generator=g, dtype=torch.float64)
    k = torch.randn(3, 4, 6, generator=g, dtype=torch.float64)
    b = torch.randn(6, generator=g, dtype=torch.float64)
    calls = []
    mm = torch.matmul
    monkeypatch.setattr(torch, "matmul",
                        lambda a, w: calls.append(tuple(a.shape)) or mm(a, w))
    got = conv.dilated_conv1d(x, k, b, 2, causal, per_row=True)
    assert calls == [(1, 25, 12)] * 3
    want = conv.dilated_conv1d(x, k, b, 2, causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    params = modules.init_wavenet(g, 2, 4, 2, 16, 3)
    args = (params, x[..., :2].float(), x[..., :3].float())
    calls.clear()
    rows = modules.apply_wavenet(*args, causal=causal, per_row=True)
    assert calls[:3] == [(1, 25, 6)] * 3          # the front conv, per row
    assert (3, 25, 48) in calls                   # a layer conv, batched
    assert (1, 25, 3) in calls                    # conditioning, per row
    calls.clear()
    batched = modules.apply_wavenet(*args, causal=causal)
    assert calls[0] == (3, 25, 6) and (1, 25, 3) not in calls
    np.testing.assert_allclose(rows.numpy(), batched.numpy(), rtol=0,
                               atol=1e-5)
