"""Build the port's CUDA sources with ``nvcc`` on first use and load them
through ctypes.

Each ``csrc/<name>.cu`` becomes ``build/flowavenet_tpu_torch/lib<name>-
<hash>.so`` beside the package (the hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source rebuilds).  The sources expose a plain C interface;
nothing here includes PyTorch's headers, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "flowavenet_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output) of builds made by this process
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from source on the machine with the card")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists (the
    hash covers the source, every header in ``csrc`` and the flags)."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO[name] = (time.perf_counter() - t0,
                        proc.stdout + proc.stderr)
    return out


def build_all(names) -> None:
    """Build several sources at once (one nvcc process each, started
    together); raises the first build error."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for f in [pool.submit(build, n) for n in names]:
            f.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
