"""The repo-root `conftest.py`: each xdist worker's thread budget, and the
time limit that fails a hung test while the run goes on.  JAX-free."""

import importlib.util
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest
import torch

ROOT_CONFTEST = pathlib.Path(__file__).resolve().parents[1] / "conftest.py"


def _root_conftest():
    """The repo-root conftest, imported as a module of its own."""
    spec = importlib.util.spec_from_file_location("_root_conftest",
                                                  ROOT_CONFTEST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_worker_threads_follow_the_budget():
    if "PYTEST_XDIST_WORKER_COUNT" not in os.environ:
        pytest.skip("without xdist the root conftest sets no thread pool")
    assert threading.current_thread() is threading.main_thread()
    # The budget's value is checked by the nested run below, whose
    # environment is controlled; here, that torch was sized before import.
    # torch follows MKL_NUM_THREADS where it is set, else OMP_NUM_THREADS.
    want = os.environ.get("MKL_NUM_THREADS", os.environ.get("OMP_NUM_THREADS"))
    assert want is not None and torch.get_num_threads() == int(want)


def test_time_limit_fails_the_block_with_its_name():
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception,
                       match=r"test_sleeper \(call\) ran past its time limit"):
        with _root_conftest().time_limit("test_sleeper (call)", 1):
            time.sleep(30)
    assert time.monotonic() - t0 < 3


# Run by a nested pytest under the root conftest with its limit cut to 1 s:
# the hung test sleeps past it, the other reads the environment left.
_TESTS = """
import os, time

def test_hung():
    time.sleep(2)

def test_env():
    if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
        n = max(1, len(os.sched_getaffinity(0))
                // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
        assert os.environ["OMP_NUM_THREADS"] == str(n)
        assert os.environ["MKL_NUM_THREADS"] == str(n)
    else:
        assert "OMP_NUM_THREADS" not in os.environ
        assert "MKL_NUM_THREADS" not in os.environ
        assert "XLA_FLAGS" not in os.environ
"""


@pytest.mark.parametrize("xdist", [True, False], ids=["n2", "no_xdist"])
def test_hung_test_fails_and_the_run_goes_on(tmp_path, xdist):
    src = ROOT_CONFTEST.read_text()
    assert "\nLIMIT_S = 300\n" in src
    (tmp_path / "conftest.py").write_text(
        src.replace("\nLIMIT_S = 300\n", "\nLIMIT_S = 1\n"))
    (tmp_path / "test_hang.py").write_text(_TESTS)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_") and k not in (
               "OMP_NUM_THREADS", "MKL_NUM_THREADS", "XLA_FLAGS")}
    env["PYTEST_DISABLE_PLUGIN_AUTOLOAD"] = "1"
    args = ["-p", "xdist", "-n", "2"] if xdist else []
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", *args,
         "test_hang.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    out = proc.stdout
    if xdist:
        assert proc.returncode == 1, out[-3000:]
        assert "1 failed, 1 passed" in out, out[-3000:]
        assert ("test_hang.py::test_hung (call) ran past its time limit of "
                "1 s") in out, out[-3000:]
        assert "time.sleep(2)" in out, out[-3000:]  # the hung line
        assert "most recent call first" in out, out[-3000:]  # every stack
    else:
        assert proc.returncode == 0, out[-3000:]
        assert "2 passed" in out, out[-3000:]
