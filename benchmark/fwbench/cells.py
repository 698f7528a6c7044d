"""Finding a cell's pieces by name, and the record of one run.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``configs/<config>.json``, the mix ``traffic/<mix>.json``
(which names its driver, ``drivers/<driver>.py``), a per-layer metric is
``metrics/<metric>.py`` and a cell's correctness limits are
``limits/<cell>.json``.  A configuration's ``reference`` key names its
model family, ``fwbench/families/<reference>.py``, and its plain
reference, ``fwbench/references/<reference>.py``.  Adding a cell, a
configuration, a model family, a mix or a metric adds files and entries;
nothing here names one.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import families

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list          # metric entries this cell reports
    per_layer: list
    limits: dict
    bench: Path = BENCH

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def family(self):
        """The configuration's model family (``fwbench/families/``)."""
        return families.of(self.config)

    def driver(self):
        return _module(self.bench / "drivers" / f"{self.traffic['driver']}.py",
                       f"bench_driver_{self.traffic['driver']}")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A per-layer metric is read in the cells it lists, or, without a
    list, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def find_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"choose from {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _applies(m, name, reported)]
    lim_path = bench / "limits" / f"{name}.json"
    limits = load_json(lim_path) if lim_path.exists() else {}
    return Cell(name, w["config"], config, traffic, int(w["chips"]), e2e,
                per_layer, limits, bench)


def metric_reader(name: str, bench: Path = BENCH):
    return _module(bench / "metrics" / f"{name}.py",
                   "bench_metric_" + name.replace(".", "_"))


def set_routes(config: dict) -> None:
    """The configuration's route switches, which the measured package reads
    when it is imported."""
    for k, v in config.get("env", {}).items():
        os.environ[k] = str(v)


def port_config(config: dict, **data):
    """The measured package's Config for a configuration file (``data``
    overrides the data section, e.g. the training batch), checked to hold
    every value the file states."""
    import dataclasses

    from flowavenet_tpu_torch.config import Config
    sections = {k: dict(config[k]) for k in ("audio", "model", "data",
                                             "train")}
    sections["data"].update(data)
    cfg = Config.from_json(json.dumps(sections))
    got = dataclasses.asdict(cfg)
    for sec, vals in sections.items():
        for k, v in vals.items():
            have = got[sec].get(k)
            if json.loads(json.dumps(have)) != v:
                raise ValueError(f"{sec}.{k}: the file says {v!r}, the "
                                 f"package's config holds {have!r}")
    return cfg


@dataclass
class Run:
    """What a driver records in one run: host spans (seconds each),
    counters, the window, the trace, the outputs to check."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: object = None
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    end_to_end: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    memory_peak_bytes: int = 0
    tracer: object = None
    checks: list = field(default_factory=list)   # (name, value, limit)
    notes: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, record: bool = True):
        """A host span around a call into the program: named in a trace,
        and its seconds kept when ``record``."""
        from .trace import span
        t0 = time.perf_counter()
        with span(name):
            yield
        if record:
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def count(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def window_started(self) -> None:
        self.setup_s = time.time() - self.t_start

    def check(self, name: str, value: float) -> None:
        """A compared number, held to the cell's limit for it."""
        self.checks.append((name, float(value), self.cell.limits.get(name)))

    @property
    def correct(self) -> bool:
        import math
        return bool(self.checks) and all(
            lim is not None and math.isfinite(v) and v <= lim
            for _, v, lim in self.checks)
