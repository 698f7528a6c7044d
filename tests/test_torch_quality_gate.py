"""PyTorch port, the route-quality gate (``flowavenet_tpu_torch/
quality_gate.py``) against the JAX package's gate (``tools/
int8_quality_gate.py``, ``tools/gate_spread.py``): each route's audio
against ``flowavenet_tpu.models.flowavenet.reverse`` with the same
switches, the scores against the same formulas over the JAX package's
mel, the verdict at its boundaries, and the whole gate end to end on the
CPU."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowavenet_tpu.audio.mel import process_wav as jax_process_wav
from flowavenet_tpu.config import tiny as jtiny
from flowavenet_tpu.models import flowavenet as jfwn
from flowavenet_tpu_torch import quality_gate as qg
from flowavenet_tpu_torch.checkpoint.bridge import to_numpy, to_torch
from flowavenet_tpu_torch.config import tiny
from flowavenet_tpu_torch.models import flowavenet as tfwn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 8                      # 2048 samples per utterance


@pytest.fixture(scope="module")
def routed():
    """tiny's init weights (the port's init, bridged) plus 0.05-scale
    noise (at init the zero convs make every coupling the identity), then
    the JAX package's DDI on a seeded batch; bridged back to the port and
    cast to bf16 on both sides.  Two utterances of seeded mels and z
    (times 0.7).  Returns the JAX and the port audio of the plain, int8 and
    FWN_INT8=0 routes, the mels and the config."""
    jcfg, cfg = jtiny(), tiny()
    params = to_numpy(tfwn.init_flowavenet(torch.Generator().manual_seed(0),
                                           cfg.model))
    leaves, treedef = jax.tree.flatten(params)
    r = np.random.RandomState(3)
    params = jax.tree.unflatten(treedef, [
        l + 0.05 * r.randn(*l.shape).astype(np.float32) for l in leaves])
    hop = jcfg.audio.hop_size
    x = 0.3 * r.randn(2, FRAMES * hop, 1).astype(np.float32)
    c = r.rand(2, FRAMES, jcfg.audio.num_mels).astype(np.float32)
    params = jax.jit(lambda p, x, c: jfwn.ddi(p, jcfg.model, x, c))(
        params, jnp.asarray(x), jnp.asarray(c))
    params = jax.tree.map(np.asarray, params)
    z = qg.route_noise(0, (2, FRAMES * hop, 1))
    jp = jax.tree.map(lambda l: jnp.asarray(l, jnp.bfloat16), params)
    tp = to_torch(params, "cpu", torch.bfloat16)
    switches = {"plain": (False, False), "int8": (True, True),
                "FWN_INT8=0": (True, False)}
    want, got = {}, {}
    saved = (jfwn.PAIR_KERNEL_INT8, jfwn.PAIR_KERNEL_CPU_INTERPRET)
    try:
        jfwn.PAIR_KERNEL_CPU_INTERPRET = True
        for route, (pallas, int8) in switches.items():
            jfwn.PAIR_KERNEL_INT8 = int8
            m = dataclasses.replace(jcfg.model, use_pallas=pallas)
            want[route] = np.asarray(jax.jit(
                lambda p, z, c, m=m: jfwn.reverse(
                    p, m, z, c, compute_dtype=jnp.bfloat16))(
                jp, jnp.asarray(z), jnp.asarray(c)).astype(jnp.float32))
            got[route], _ = qg.synthesize_route(tp, cfg, z, c, route, "cpu")
    finally:
        jfwn.PAIR_KERNEL_INT8, jfwn.PAIR_KERNEL_CPU_INTERPRET = saved
    return want, got, c, cfg


@pytest.mark.parametrize("route", ["plain", "int8", "FWN_INT8=0"])
def test_gate_route_audio_matches_jax_reverse(routed, route):
    """The gate's bf16 synthesis on the plain, int8 and FWN_INT8=0 routes
    (the kernels' plain versions on the CPU) against the JAX package's bf16
    reverse with the same switches (its kernels in interpret mode):
    rel-to-max < 0.08 and corr > 0.998, the bar test_torch_family.py's
    test_reverse_matches_jax holds a kernel route to (the JAX package's
    int8 bar, test_pallas_flow.py:698); the two frameworks round to bf16
    at other points, so the fp32 bar does not apply."""
    want, got, _, _ = routed
    a, b = got[route], want[route]
    assert a.shape == b.shape and np.all(np.isfinite(a))
    assert qg.relmax(a, b) < 0.08
    assert qg.corr(a, b) > 0.998


def test_gate_scores_match_the_jax_formulas(routed):
    """corr, relmax and mel_corr of the port's route audio equal the JAX
    tool's formulas (int8_quality_gate.py:164-182) over
    ``flowavenet_tpu.audio.mel.process_wav`` to 1e-6."""
    _, got, c, cfg = routed

    def jcorr(a, b):
        return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])

    def jmel_corr(wavs):
        cs = []
        for i in range(wavs.shape[0]):
            _, m = jax_process_wav(wavs[i, :, 0], jtiny().audio)
            n = min(m.shape[0], FRAMES)
            cs.append(jcorr(m[:n], c[i, :n]))
        return float(np.mean(cs))

    for r in ("int8", "FWN_INT8=0"):
        a, b = got[r], got["plain"]
        assert abs(qg.corr(a, b) - jcorr(a, b)) <= 1e-6
        want = float(np.abs(a - b).max() / max(1e-9, np.abs(b).max()))
        assert abs(qg.relmax(a, b) - want) <= 1e-6
    for r, w in got.items():
        assert abs(float(qg.mel_corr(w, c, cfg.audio).mean())
                   - jmel_corr(w)) <= 1e-6


_BELOW = np.nextafter
# (route corr to FWN_INT8=0, FWN_INT8=0's corr to plain, mel_corr of the
# route, of the plain route, second clause only, verdict)
VERDICTS = [
    (0.999, 1.0, 0.9, 0.0, False, True),            # first clause, at 0.999
    (_BELOW(0.999, 0.0), 1.0, 0.0, 0.0, False, False),  # just below both
    (0.5 - qg.CORR_SLACK, 0.5, 0.005, 0.0, False, True),  # both bounds
    (_BELOW(0.5 - qg.CORR_SLACK, 0.0), 0.5, 0.0, 0.0, False, False),
    (0.6, 0.5, _BELOW(0.005, 1.0), 0.0, False, False),  # drift past 5e-3
    (0.6, 0.5, -0.005, 0.0, False, True),            # drift -5e-3
    (0.6, 0.5, _BELOW(-0.005, -1.0), 0.0, False, False),
    (0.9995, 0.5, 0.3, 0.0, False, True),            # drift, first clause
    (0.9995, 0.9995, 0.3, 0.0, True, False),         # FWN_INT8=0: drift
    (0.9995, 0.9995, 0.004, 0.0, True, True),
    (0.9, 0.9, 0.005, 0.0, True, True),             # the floor is its own
    (0.9, 0.9, _BELOW(0.005, 1.0), 0.0, True, False),
]


@pytest.mark.parametrize("rc,floor,mc,mc_plain,second,ok", VERDICTS)
def test_gate_verdict_at_its_boundaries(rc, floor, mc, mc_plain, second,
                                        ok):
    """int8_quality_gate.py:195-197: corr >= 0.999, or corr >= floor - 1e-3
    with |mel_corr drift| <= 5e-3; FWN_INT8=0 takes the second clause."""
    assert qg.verdict(rc, floor, mc, mc_plain, second_only=second) is ok


def test_gate_runs_end_to_end_without_jax(tmp_path):
    """``main`` on the CPU in a subprocess: a corpus of two short wavs cut
    from docs/runs/, 2 training steps, 2 seeds, 20 frames, then the same
    checkpoint scored again through --ckpt_dir/--data_dir.  The JSON has
    gate_spread's keys and every route with its scores, launches and
    verdict; neither jax nor flowavenet_tpu was imported."""
    from flowavenet_tpu_torch.audio.wavio import read_wav, write_wav
    wavs = []
    for name in ("u004_50k.wav", "u005_50k.wav"):
        y, sr = read_wav(os.path.join(REPO, "docs", "runs", name))
        wavs.append(str(tmp_path / name))
        write_wav(wavs[-1], y[: int(0.6 * sr)], sr)
    work, out, out2 = (str(tmp_path / n) for n in ("work", "a.json",
                                                   "b.json"))
    code = (
        "import sys, json\n"
        "from flowavenet_tpu_torch.quality_gate import main\n"
        f"main([{work!r}, '--steps', '2', '--seeds', '2', '--frames', '20',"
        f" '--device', 'cpu', '--json', {out!r}, '--ref_wavs', *{wavs!r}])\n"
        f"main(['--ckpt_dir', {work!r} + '/logs/pretrained', '--data_dir',"
        f" {work!r} + '/training_data', '--config', 'tiny', '--seeds', '1',"
        f" '--frames', '20', '--device', 'cpu', '--json', {out2!r}])\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'flowavenet_tpu'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert proc.stdout.count("GATE ") == 2 * (len(qg.GATE_ROUTES) - 1)
    for path, seeds in ((out, 2), (out2, 1)):
        with open(path) as f:
            res = json.load(f)
        assert res["step"] == 2 and res["seeds"] == seeds
        assert 0 < res["frames"] <= 20
        assert set(res["routes"]) == set(qg.GATE_ROUTES)
        assert set(res["per_route_seed_means"]) == set(qg.GATE_ROUTES)
        for r, v in res["routes"].items():
            assert len(res["per_route_seed_means"][r]) == seeds
            for k in ("corr_to_plain", "relmax_to_plain", "corr_to_base",
                      "relmax_to_base", "mel_corr"):
                assert np.isfinite(v[k]), (r, k)
            assert v["launches"] == {}          # plain versions on the CPU
            assert v["verdict"] in ((None,) if r == qg.PLAIN
                                    else ("PASS", "FAIL"))
        assert "FWN_INT8=0-plain" in res["paired_deltas"]
        assert "int8-FWN_INT8=0" in res["paired_deltas"]
