"""Build the port's CUDA sources with ``nvcc`` on first use and load them
through ctypes.

Each ``csrc/<name>.cu`` becomes ``build/flowavenet_tpu_torch/lib<name>-
<hash>.so`` beside the package (the hash covers the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source rebuilds).  The sources expose a plain C interface;
nothing here includes PyTorch's headers, which keeps a build to seconds.

:func:`build_host` is the host compiler's twin for C++ sources (the native
data loader): ``g++`` (or ``$CXX``) with ``native/Makefile``'s flags into
the same directory, the hash covering the source, the flags, the
compiler's version and the CPU that ``-march=native`` resolves to.
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

# native/Makefile's CXXFLAGS and LDFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wextra"]
LD_FLAGS = ["-shared", "-lpthread"]

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


def _compile(name: str, key: bytes, cmd: list, src: Path) -> Path:
    """Run ``cmd + ["-o", <out>]`` into ``lib<name>-<hash of key>.so``
    unless that build exists; the output appears atomically."""
    out = BUILD_DIR / f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([*cmd, "-o", tmp], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed for {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO[name] = (time.perf_counter() - t0,
                        proc.stdout + proc.stderr)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date build exists (the
    hash covers the source, every header in ``csrc`` and the flags)."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    return _compile(name, key, [_nvcc(), *NVCC_FLAGS, str(src)], src)


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(
            f"C++ compiler {cxx!r} not found (set CXX); the native data "
            "loader is built from source with it")
    return found


def build_host(src: Path) -> Path:
    """Compile the C++ source ``src`` with the host compiler unless an
    up-to-date build exists.  The hash covers the source, the flags, the
    compiler's version and the ``-march`` that ``-march=native`` resolves
    to, so a build made for another CPU is never loaded."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, check=True).stdout
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    march = [l for l in target.splitlines() if l.strip().startswith(
        "-march=")]
    key = (src.read_bytes() + " ".join(CXX_FLAGS + LD_FLAGS).encode()
           + version.encode() + "".join(march).encode())
    return _compile(src.stem, key, [cxx, *CXX_FLAGS, str(src), *LD_FLAGS],
                    src)


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
