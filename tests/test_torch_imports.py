"""The PyTorch port stands alone: no module of ``flowavenet_tpu_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and the entry points run
on the card unless the caller asks for the CPU."""

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


def test_entry_points_need_cuda_unless_cpu(monkeypatch, tmp_path):
    """Without CUDA, synthesize_mels, load_params and the CLI raise rather
    than fall back to the CPU; device='cpu' is the explicit way there."""
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
