"""The PyTorch port stands alone: no module of ``flowavenet_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package (the data modules keep
their own jax-free copies), and the entry points (synthesis and training)
run on the card unless the caller asks for the CPU."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "flowavenet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flowavenet_tpu"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_sources_found():
    assert len(SOURCES) > 15
    assert (ROOT / "flowavenet_tpu_torch/ops/csrc/pair_flow.cu").exists()
    assert (ROOT / "flowavenet_tpu_torch/ops/csrc/pair_flow_train.cu").exists()
    assert (ROOT / "flowavenet_tpu_torch/ops/csrc/pair_flow_wino.cu").exists()
    assert (ROOT / "flowavenet_tpu_torch/ops/csrc/resblock.cu").exists()
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"flowavenet_tpu_torch/ops/pair_flow_train.py",
            "flowavenet_tpu_torch/training/optimizer.py",
            "flowavenet_tpu_torch/training/train_state.py",
            "flowavenet_tpu_torch/training/metrics.py",
            "flowavenet_tpu_torch/training/train.py",
            "flowavenet_tpu_torch/checkpoint/checkpoint.py",
            "flowavenet_tpu_torch/data/records.py",
            "flowavenet_tpu_torch/data/dataset.py",
            "flowavenet_tpu_torch/synthesis/noise.py",
            "flowavenet_tpu_torch/synthesis/streaming.py",
            "flowavenet_tpu_torch/serving/server.py",
            "flowavenet_tpu_torch/ops/resblock.py",
            "flowavenet_tpu_torch/utils/device.py",
            "flowavenet_tpu_torch/utils/profiling.py",
            "flowavenet_tpu_torch/bench.py",
            "flowavenet_tpu_torch/audio/mel.py",
            "flowavenet_tpu_torch/audio/preprocessing.py",
            "flowavenet_tpu_torch/audio/tacotron.py",
            "flowavenet_tpu_torch/training/tb_writer.py",
            "flowavenet_tpu_torch/checkpoint/tf_import.py",
            "flowavenet_tpu_torch/checkpoint/import_cli.py"} <= names


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    """Without CUDA, synthesize_mels, load_params and the CLI, the trainer
    (also with ``--tensorboard`` and ``--profile_steps``), the bench and
    the TF import CLI raise rather than fall back to the CPU; device='cpu'
    (``--device cpu``) is the explicit way there.  The preprocessing and
    Tacotron CLIs run no device work (host numpy, the JAX package's files
    byte for byte: tests/test_torch_audio.py)."""
    from flowavenet_tpu_torch.config import tiny
    from flowavenet_tpu_torch.synthesis import synthesize as tsyn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.synthesize_mels({}, cfg, [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.load_params(str(tmp_path), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.main(["--saved_dir", str(tmp_path), "--config", "tiny"])
    assert tsyn.resolve_device("cpu").type == "cpu"
    from flowavenet_tpu_torch.training import train as ttrain
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(cfg, str(tmp_path), str(tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--config", "tiny", "--data_dir", str(tmp_path),
                     "--logdir", str(tmp_path / "logs")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--config", "tiny", "--data_dir", str(tmp_path),
                     "--logdir", str(tmp_path / "logs"), "--tensorboard",
                     "--profile_steps", "2"])
    from flowavenet_tpu_torch import bench
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    monkeypatch.setenv("BENCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    from flowavenet_tpu_torch.checkpoint import import_cli
    with pytest.raises(RuntimeError, match="device='cpu'"):
        import_cli.main(["--npz", str(tmp_path / "tf.npz"), "--out_dir",
                         str(tmp_path / "out"), "--config", "tiny"])


def test_serving_entry_points_need_cuda_unless_cpu(monkeypatch):
    """Without CUDA, dispatch_mels, stream_reverse, synthesize_time_parallel,
    SynthesisService and serve raise rather than fall back to the CPU."""
    import numpy as np

    from flowavenet_tpu_torch.config import tiny
    from flowavenet_tpu_torch.serving import server
    from flowavenet_tpu_torch.synthesis import streaming
    from flowavenet_tpu_torch.synthesis import synthesize as tsyn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny()
    mel = np.zeros((16, 80), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.dispatch_mels({}, cfg, [mel])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(streaming.stream_reverse({}, cfg, mel))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        streaming.synthesize_time_parallel({}, cfg, mel)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.SynthesisService({}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        server.serve({}, cfg, port=0)


def test_package_data_ships_every_kernel_source():
    """pyproject's package-data for the port's ops covers every file the
    kernel builds read (the .cu sources and the shared .cuh headers), so
    an installed copy builds its kernels."""
    import fnmatch
    import tomllib
    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    globs = data["flowavenet_tpu_torch.ops"]
    csrc = ROOT / "flowavenet_tpu_torch/ops/csrc"
    files = sorted(p.relative_to(csrc.parent).as_posix()
                   for p in csrc.iterdir())
    assert {p.suffix for p in csrc.iterdir()} == {".cu", ".cuh"}
    for name in files:
        assert any(fnmatch.fnmatch(name, g) for g in globs), name


def test_port_sources_state_no_tpu_measurement():
    """No module of the port (nor chip_smoke.py) quotes a time, rate or
    batch measured on a TPU: the JAX package's TPU numbers say nothing
    about the port (its config comments once did)."""
    import re
    tpu = re.compile(r"\bv5e\b|\bv5 ?lite|\bTPU v\d|\bv\d+ TPU")
    for path in SOURCES + sorted(
            (ROOT / "flowavenet_tpu_torch/ops/csrc").iterdir()):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not tpu.search(line), f"{path.name}:{i}: {line.strip()}"


@pytest.mark.parametrize("script", ["flowavenet-torch-synthesize",
                                    "flowavenet-torch-preprocess",
                                    "flowavenet-torch-adapt-tacotron",
                                    "flowavenet-torch-import-tf"])
def test_port_console_scripts_resolve(script):
    """Each of the port's console scripts in pyproject.toml names a main
    function of the port that takes an argv list, as its JAX twin does
    (flowavenet-synthesize, -preprocess, -adapt-tacotron, -import-tf)."""
    import importlib
    import inspect
    import tomllib
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    module, func = scripts[script].split(":")
    assert module.startswith("flowavenet_tpu_torch.")
    assert script.replace("-torch", "") in scripts
    fn = getattr(importlib.import_module(module), func)
    assert "argv" in inspect.signature(fn).parameters
