"""Repo-root pytest hooks: one CPU thread budget per xdist worker, and a time
limit on each phase of each test that a worker runs.

Pytest loads this file before ``tests/conftest.py``, in the controller and in
every xdist worker.  In a worker it sizes the thread pools of torch, MKL and
OpenBLAS (``OMP_NUM_THREADS``) before anything imports them, and subprocesses
that a test starts inherit them.  Without that, each of ``-n`` workers starts
a pool thread per core.  XLA's CPU pool is left as it is: ``XLA_FLAGS`` takes
no thread count, and switching off XLA's multi-threaded Eigen made the JAX
tests no faster under xdist and slower alone.

Outside an xdist worker the hooks do nothing: a run without ``-n`` (one file
at a time) keeps its threads, its environment and no time limit.  The card's
tests run with ``--noconftest``, which skips this file too.
"""

import contextlib
import faulthandler
import os
import signal
import sys
import threading

import pytest

# Seconds that each of a test's setup, call and teardown may take in a worker.
LIMIT_S = 300


def budget():
    """Threads per worker: the cores this process may use, split evenly among
    the run's ``PYTEST_XDIST_WORKER_COUNT`` workers, at least one."""
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count())
    return max(1, cores // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))


@contextlib.contextmanager
def time_limit(name, seconds):
    """Fails the block, with its traceback, once it has run ``seconds``.

    SIGALRM raises pytest's failure in the main thread wherever it is, also in
    a ``join``, a ``sleep`` or a subprocess wait.  The failure is no
    ``Exception``, so no ``except Exception`` in the test swallows it.  Every
    thread's stack goes to stderr first, so a test stuck on a server thread
    shows where that thread waits.
    """
    def expire(signum, frame):
        __tracebackhide__ = True
        with contextlib.suppress(AttributeError, ValueError):  # no stderr fd
            faulthandler.dump_traceback(sys.stderr)
        pytest.fail(f"{name} ran past its time limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _limited(item, phase):
    """The hook wrapper's body: ``phase`` of ``item`` under ``LIMIT_S`` in an
    xdist worker's main thread, and as it is anywhere else."""
    if ("PYTEST_XDIST_WORKER" not in os.environ
            or not hasattr(signal, "setitimer")
            or threading.current_thread() is not threading.main_thread()):
        return (yield)
    with time_limit(f"{item.nodeid} ({phase})", LIMIT_S):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item, "setup"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item, "call"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    return (yield from _limited(item, "teardown"))


# A caller who set either count keeps it: torch follows MKL_NUM_THREADS where it
# is set, so setting only the other would override the caller's.
if ("PYTEST_XDIST_WORKER_COUNT" in os.environ
        and not {"OMP_NUM_THREADS", "MKL_NUM_THREADS"} & os.environ.keys()):
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(budget())
