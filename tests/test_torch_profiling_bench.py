"""PyTorch port, measurement: ``utils/profiling.py`` against
``flowavenet_tpu/utils/profiling.py``, the port's bench
(``flowavenet_tpu_torch/bench.py``) against the top-level ``bench.py``,
and the trainer's ``--tensorboard`` / ``--profile_steps`` (``train(device=
"cpu")`` on tiny), all on the CPU."""

import glob
import importlib.util
import json
import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from flowavenet_tpu.config import lj8k as jlj8k
from flowavenet_tpu.config import tiny as jtiny
from flowavenet_tpu.utils import profiling as jprof
from flowavenet_tpu_torch import bench as tbench
from flowavenet_tpu_torch.config import get_config
from flowavenet_tpu_torch.config import tiny as ttiny
from flowavenet_tpu_torch.data.records import FwRecordWriter
from flowavenet_tpu_torch.training.train import train as ttrain
from flowavenet_tpu_torch.utils import profiling as tprof

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run many small ops, which stall
    when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bench():
    """The top-level bench.py as a module (it imports JAX only in main)."""
    spec = importlib.util.spec_from_file_location("top_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("skip_first", [0, 1, 2])
def test_step_timer_matches_jax(monkeypatch, skip_first):
    """Both timers over one scripted clock: the same kept times, mean and
    best (and 0.0 with nothing kept)."""
    ticks = [0.0, 1.5, 2.0, 2.25, 3.0, 3.125, 4.0, 4.5, 5.0, 5.75]

    def run(mod):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        t = mod.StepTimer(skip_first=skip_first)
        empty = (t.mean, t.best)
        for _ in range(len(ticks) // 2):
            with t:
                pass
        return t.times, t.mean, t.best, empty

    assert run(tprof) == run(jprof)
    assert run(tprof)[3] == (0.0, 0.0)


def test_trace_writes_a_chrome_trace_naming_its_ops(tmp_path):
    """trace() on the CPU: one Chrome trace under logdir whose events name
    the ops run inside the window (and not those run after it)."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "prof")) as prof:
        torch.mm(a, b)
    torch.bmm(a[None], b[None])
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "aten::mm" in names and "aten::bmm" not in names
    assert "aten::mm" in {e.key for e in prof.key_averages()}


def test_trace_stops_and_writes_when_the_body_raises(tmp_path):
    with pytest.raises(ValueError):
        with tprof.trace(str(tmp_path)):
            torch.mm(torch.ones(2, 2), torch.ones(2, 2))
            raise ValueError("stop")
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1
    with tprof.trace(str(tmp_path)):      # a new window opens after it
        pass


def test_device_memory_stats_keys_match_jax():
    t, j = tprof.device_memory_stats(), jprof.device_memory_stats()
    assert len(t) >= 1
    assert all(set(x) == set(j[0]) == {"device", "bytes_in_use",
                                       "peak_bytes_in_use"} for x in t)
    if not torch.cuda.is_available():
        assert t == [{"device": "cpu", "bytes_in_use": -1,
                      "peak_bytes_in_use": -1}]


@pytest.mark.parametrize("name,seconds,frames", [
    ("lj22k", 7.0, 600), ("lj22k", 3.83, 300), ("lj22k", 0.5, 30),
    ("lj8k", 7.0, 570), ("tiny", 0.2, 17)])
def test_bench_frames_follow_the_jax_bench(name, seconds, frames):
    """BENCH_SECONDS is trimmed to a 30-frame multiple, then aligned to the
    squeeze factor, as bench.py:102-109 does."""
    cfg = get_config(name)
    got = tbench.bench_frames(cfg, seconds)
    assert got == frames
    assert (got * cfg.audio.hop_size) % cfg.model.squeeze_factor == 0


def test_speech_mels_equal_the_jax_bench():
    """BENCH_MELS=speech: the port's frontend gives the top-level bench's
    speech mels bit for bit (22.05 kHz and 8 kHz presets)."""
    top = _jax_bench()
    for tcfg, jcfg in ((ttiny(), jtiny()), (get_config("lj8k"), jlj8k())):
        got = tbench._speech_mels(tcfg, 3, 25)
        want = top._speech_mels(jcfg, 3, 25)
        assert got.dtype == want.dtype and got.shape == (3, 25, 80)
        np.testing.assert_array_equal(got, want)


def _run_bench(monkeypatch, capsys, mels="synthetic", argv=("--device",
                                                            "cpu")):
    for k, v in {"BENCH_CONFIG": "tiny", "BENCH_SECONDS": "0.2",
                 "BENCH_BATCH": "2", "BENCH_ITERS": "2",
                 "BENCH_MELS": mels}.items():
        monkeypatch.setenv(k, v)
    result = tbench.main(list(argv))
    out, err = capsys.readouterr()
    return result, out, err


@pytest.mark.parametrize("mels", ["synthetic", "speech", "dir"])
def test_bench_prints_one_json_line_with_the_jax_keys(monkeypatch, capsys,
                                                      tmp_path, mels):
    """``--device cpu``, tiny, 2 x 0.2 s: stdout is one JSON line with the
    top-level bench's keys and metric name; the '#' lines go to stderr."""
    if mels == "dir":
        for i in range(3):
            np.save(tmp_path / f"m{i}.npy",
                    np.random.RandomState(i).rand(10 + 5 * i, 80
                                                  ).astype(np.float32))
        mels = str(tmp_path)
    result, out, err = _run_bench(monkeypatch, capsys, mels)
    lines = out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == result
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "synthesis_khz_per_sec_per_chip"
    assert line["unit"] == "kHz/s" and line["value"] > 0
    # both rounded to 2 decimals, as the top-level bench rounds them
    assert line["vs_baseline"] == pytest.approx(line["value"] / 22.05,
                                                rel=1e-2, abs=0.01)
    assert "# device: cpu" in err and "# first call" in err


def test_bench_env_device_and_empty_mels_dir(monkeypatch, capsys, tmp_path):
    """BENCH_DEVICE=cpu stands for --device cpu; a mels directory without
    .npy files raises."""
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    result, _, err = _run_bench(monkeypatch, capsys, argv=())
    assert result["value"] > 0 and "# device: cpu" in err
    with pytest.raises(FileNotFoundError):
        _run_bench(monkeypatch, capsys, mels=str(tmp_path), argv=())


def _corpus(d, n=5, seed=0):
    os.makedirs(d, exist_ok=True)
    r = np.random.RandomState(seed)
    recs = [((0.1 * r.randn(f * 256)).astype(np.float32),
             r.rand(f, 80).astype(np.float32), 0)
            for f in (20, 11, 40, 9, 33)[:n]]
    for name in ("train", "test"):
        with FwRecordWriter(os.path.join(d, f"{name}.fwrec")) as w:
            for a, m, s in recs:
                w.write(a, m, s)
    return d


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(logdir)
    acc.Reload()
    return acc


def test_trainer_tensorboard_and_profile_window(tmp_path):
    """train(device="cpu") on tiny, 3 steps, ``tensorboard=True``,
    ``profile_steps=1``: TensorBoard events under ``<logdir>/train`` with
    the loss at the summary steps and the probe's audio; one Chrome trace
    under ``<logdir>/profile`` holding the traced step's ops; a run of 2
    steps resumed to 3 with the same switches reaches the same checkpoint
    bit for bit."""
    data = _corpus(str(tmp_path / "data"))
    kw = dict(summary_interval=2, checkpoint_interval=2, eval_interval=3,
              device="cpu", log_every=0, tensorboard=True, profile_steps=1)
    a = ttrain(ttiny(), data, str(tmp_path / "a"), train_steps=3, **kw)
    acc = _scalars(str(tmp_path / "a" / "train"))
    assert [e.step for e in acc.Scalars("loss")] == [1, 2]
    assert all(np.isfinite(e.value) for e in acc.Scalars("loss"))
    assert {"eval/prediction", "eval/target"} <= set(acc.Tags()["audio"])
    traces = glob.glob(str(tmp_path / "a" / "profile" / "*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)

    ttrain(ttiny(), data, str(tmp_path / "b"), train_steps=2,
           probe_synthesis=False, **kw)
    b = ttrain(ttiny(), data, str(tmp_path / "b"), train_steps=3,
               probe_synthesis=False, **kw)
    with np.load(os.path.join(a, "ckpt-3.npz")) as fa, \
            np.load(os.path.join(b, "ckpt-3.npz")) as fb:
        assert set(fa.files) == set(fb.files)
        for k in fa.files:
            if k != "__meta__":
                np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_trainer_goes_on_without_tensorboard(tmp_path, monkeypatch, capsys):
    """Where ``torch.utils.tensorboard`` cannot be imported, maybe_tb_writer
    gives None and the trainer says so and trains with JSONL metrics."""
    from flowavenet_tpu_torch.training import tb_writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert tb_writer.maybe_tb_writer(str(tmp_path / "tb")) is None
    data = _corpus(str(tmp_path / "data"), n=3)
    ttrain(ttiny(), data, str(tmp_path / "a"), train_steps=1,
           probe_synthesis=False, device="cpu", tensorboard=True)
    assert "tensorboard writer unavailable" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "a" / "train" / "metrics.jsonl")
    assert not glob.glob(str(tmp_path / "a" / "train" / "events.*"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,cls", [
    ("void pair_reverse_kernel<__nv_bfloat16, 1, 1, 0, 1>(pf::Params)",
     "pair kernels"),
    ("void pair_bwd_kernel<__nv_bfloat16, true>(TcArgs)", "pair kernels"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "cuDNN convs"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopB_TNN", "cuBLAS GEMMs"),
    ("sm80_xmma_gemm_i8i8_i8i32_f32_tn_n_tilesize128x128x64",
     "_int_mm (int8 GEMM)"),
    ("Memcpy HtoD (Pinned -> Device)", "copies"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::tanh_kernel_cuda>", "elementwise and reductions"),
    ("mystery_kernel", "other")])
def test_chip_smoke_op_classes(name, cls):
    assert _chip_smoke()._op_class(name) == cls


def test_chip_smoke_trace_split_reads_busy_idle_and_gaps():
    """trace_split on a scripted trace: a CPU range over [0, 100] us and
    device kernels at [10, 30], [20, 40] (overlapping) and [70, 80]: busy
    40 of 100 us, the longest idle gap 30 us (between 40 and 70), time
    per class and op summed over calls."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType
    cs = _chip_smoke()

    def ev(name, s, e, dev=DeviceType.CUDA):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=float(s), end=float(e)))
    evs = [ev("aten::mm", 0, 100, DeviceType.CPU),
           ev("nvjet_gemm", 10, 30), ev("nvjet_gemm", 20, 40),
           ev("void pair_reverse_kernel<x>", 70, 80)]
    out = cs.trace_split(NS(events=lambda: evs), 5.0, "scripted")
    assert out["span_ms"] == pytest.approx(0.1)
    assert out["device_ops"] == 3
    assert out["busy_ms"] == pytest.approx(0.04)
    assert out["idle_share"] == pytest.approx(0.6)
    assert out["idle_gaps"][0]["ms"] == pytest.approx(0.03)
    assert out["idle_gaps"][0]["after"] == "nvjet_gemm"
    assert out["device_ms_by_class"]["cuBLAS GEMMs"] == {"ms": 0.04,
                                                          "calls": 2}
    assert out["top_ops"][0] == {"name": "nvjet_gemm", "ms": 0.04,
                                 "calls": 2}
    assert cs.trace_split(NS(events=lambda: evs[:1]), 1.0, "none") is None


def test_chip_smoke_trace_split_names_gaps_by_program_span():
    """The same scripted trace with program spans: ``fwn.synth.dispatch``
    over [0, 90] us and ``fwn.model.reverse`` inside it over [35, 60], each
    also projected onto the device timeline over [10, 80].  The gap
    between 40 and 70 us (middle 55) is named by the innermost span open
    there, the one over [0, 10] by the dispatch span; the projections are
    not counted as device work."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType
    cs = _chip_smoke()

    def ev(name, s, e, dev=DeviceType.CUDA):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=float(s), end=float(e)))
    evs = [ev("aten::mm", 0, 100, DeviceType.CPU),
           ev("fwn.synth.dispatch", 0, 90, DeviceType.CPU),
           ev("fwn.model.reverse", 35, 60, DeviceType.CPU),
           ev("fwn.synth.dispatch", 10, 80), ev("fwn.model.reverse", 10, 80),
           ev("nvjet_gemm", 10, 30), ev("nvjet_gemm", 20, 40),
           ev("void pair_reverse_kernel<x>", 70, 80)]
    out = cs.trace_split(NS(events=lambda: evs), 5.0, "scripted")
    assert out["device_ops"] == 3
    assert out["busy_ms"] == pytest.approx(0.04)
    gaps = {round(g["ms"] * 1e3): g["span"] for g in out["idle_gaps"]}
    assert gaps == {30: "fwn.model.reverse", 10: "fwn.synth.dispatch",
                    20: "-"}


def _tiny_reverse(seed: int, B: int = 3):
    """A plain-route tiny reverse in fp64 on the CPU: (run, n_block)."""
    import dataclasses

    from flowavenet_tpu_torch.models import flowavenet as fwn
    cfg = dataclasses.replace(ttiny().model, use_pallas=False)
    gen = torch.Generator().manual_seed(seed)
    params = fwn.init_flowavenet(gen, cfg)
    for bp in params["blocks"]:
        bp["flows"]["coupling"]["zero"]["w"].normal_(0, 0.05, generator=gen)
    z = torch.randn(B, 1024, 1, generator=gen, dtype=torch.float64)
    c = torch.rand(B, 4, cfg.num_mels, generator=gen, dtype=torch.float64)
    return (lambda: fwn.reverse(params, cfg, z, c,
                                compute_dtype=torch.float64)), cfg.n_block


def test_block_stages_names_times_and_keeps_rows():
    """BlockStages on a CPU reverse: the upsampler, then blocks n_block - 1
    down to 0, each with a host-clock time and row 0 of its output; the
    model's functions are back after the block."""
    from flowavenet_tpu_torch.models import flowavenet as fwn
    run, n_block = _tiny_reverse(7)
    saved = (fwn.block_reverse, fwn.apply_upsample)
    with tprof.BlockStages(rows=True) as st:
        out = run()
    names = ["upsampler"] + [f"block {b}" for b in range(n_block - 1, -1, -1)]
    assert [n for n, _ in st.rows] == names
    assert st.stage == "-"
    assert list(st.ms()) == names and all(v > 0 for v in st.ms().values())
    assert all(r.shape[0] == 1 and r.dtype == torch.float32
               for _, r in st.rows)
    np.testing.assert_array_equal(st.rows[-1][1].numpy(),
                                  out[:1].float().numpy())
    assert (fwn.block_reverse, fwn.apply_upsample) == saved


def test_chip_smoke_product_paths_and_op_split():
    """chip_smoke's replays of the nets' products (``library``: cuDNN convs
    and batched products; ``per-row``: every product one row at a time;
    ``batched``: none per row; ``synthesis``: reverse's schedule) give the
    port's reverse in fp64 to rounding, and ``_op_split`` finds
    no product that follows the batch there, but names the matmul of each
    stage when a matmul mixes a row with its companions."""
    cs = _chip_smoke()
    run, n_block = _tiny_reverse(8)
    base = run()
    for path in ("library", "per-row", "batched", "synthesis"):
        with cs._patched(cs._path_patches(path)):
            got = run()
        np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=0,
                                   atol=1e-12)
    ops = cs._op_split(run, 3)
    assert {k.rsplit(" ", 1)[0] for k in ops} == {"upsampler matmul"} | {
        f"block {b} matmul" for b in range(n_block)}
    assert not any(v["differ"] for v in ops.values())
    mm = torch.matmul

    def mixing(a, b):
        out = mm(a, b)
        return out + 1e-3 * out.mean(0, keepdim=True) if a.dim() == 3 else out
    with cs._patched([(torch, "matmul", mixing)]):
        ops = cs._op_split(run, 3)
    assert all(v["differ"] == v["calls"] > 0 for v in ops.values()), ops
