"""The harness: finds a cell's configuration, traffic and metric readers by
the names in ``BENCHMARK.json``, runs set-up, the measured window and the
check against the reference, and assembles the result line.

A cell ``<config>.<traffic name>`` has its parameters in
``benchmark/workloads/<cell>.json``, which names its traffic kind; the kind
is the module ``benchmark/traffic/<kind>.py`` with three functions:

  setup(ctx) → state          build the program, make the inputs, warm up
  window(ctx, state) → Window the measured window (``ctx.seconds``), calling
                              ``ctx.tracer.tick()`` at every item boundary
  check(ctx, state, window) → [Check]
                              free the program's state, then compare what the
                              window produced with the reference; with
                              ``ctx.diagnose`` also the numbers that are
                              reported and not compared (``readings.py``)

A per-layer metric ``<name>`` is ``benchmark/metrics/<name>.py`` with
``read(r: Reading) → float | None`` (None: nothing to read in this run).
A configuration is the JSON file that ``BENCHMARK.json`` names.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pmpu_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is,
    whole, one that no run may load."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module of a file that need not be importable by name (metric
    files carry dots in theirs)."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclass
class Check:
    """One number of the comparison with the reference: it passes at or
    under its limit. Without a limit it is reported and not compared."""

    name: str
    value: float
    limit: float = None

    @property
    def ok(self) -> bool:
        return self.limit is None or (self.value == self.value and self.value <= self.limit)


@dataclass
class Window:
    attempted: int
    failed: int
    e2e: dict                                   # end-to-end metric → value
    counts: dict = field(default_factory=dict)  # what the readers may read
    outputs: object = None                      # what the check compares


class Benchmark:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, path: Path = ROOT / "BENCHMARK.json"):
        self.spec = load_json(path)
        self.cells = {w["name"]: w for w in self.spec["workloads"]}
        self.configs = {c["name"]: c for c in self.spec["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(self.cells)})")
        return self.cells[name]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def config(self, cell: str) -> dict:
        return load_json(ROOT / self.configs[self.cell(cell)["config"]]["file"])

    def workload(self, cell: str) -> dict:
        return load_json(HERE / "workloads" / f"{cell}.json")

    def traffic(self, kind: str):
        return load_module(HERE / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")

    def reader(self, metric: str):
        return metric_reader(metric)


def metric_reader(metric: str):
    """The reader of a per-layer metric, ``benchmark/metrics/<metric>.py``."""
    return load_module(HERE / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_"))


@dataclass
class Context:
    cell: str
    config: dict
    workload: dict
    seed: int
    seconds: float
    device: object
    tracer: object
    variant: str = "program"   # or "control": the lower precision in its place
    diagnose: bool = False     # also the numbers that decide nothing (readings.py)


@dataclass
class Reading:
    """What a per-layer metric reads of a traced run."""

    trace: object      # tracing.TraceReading
    config: dict
    workload: dict
    counts: dict


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
             device="cuda", variant: str = "program", bench: Benchmark = None,
             overrides: dict = None, diagnose: bool = False) -> dict:
    """One run of a cell → the result line's object. ``t_start`` is the
    process's start on ``time.perf_counter``'s clock (set-up counts from
    it). ``overrides`` ({"config": {...}, "workload": {...}}) replace keys of
    the cell's files: the tests' small sizes. ``diagnose`` adds
    ``not_compared``, the numbers of the comparison that have no limit."""
    import torch

    from benchmark.tracing import Tracer

    bench = bench or Benchmark()
    entry = bench.cell(cell)
    cfg, wl = bench.config(cell), bench.workload(cell)
    if overrides:
        cfg.update(overrides.get("config", {}))
        wl.update(overrides.get("workload", {}))
    device = torch.device(device)
    traffic = bench.traffic(wl["traffic"])
    tracer = Tracer(trace, wl["trace_seconds"], device)
    ctx = Context(cell, cfg, wl, int(seed), float(seconds), device, tracer, variant, diagnose)

    state = traffic.setup(ctx)
    tracer.warm_up()
    sync(device)
    setup_s = time.perf_counter() - t_start
    win = traffic.window(ctx, state)
    tracer.stop()
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    checks = traffic.check(ctx, state, win)
    del state
    compared = [c for c in checks if c.limit is not None]
    correct = bool(compared) and all(c.ok for c in compared) and win.failed == 0

    metrics = {}
    if not trace:
        values = dict(win.e2e, setup_s=setup_s)
        for m in bench.end_to_end(cell):
            if m["name"] not in values:
                raise KeyError(f"traffic {wl['traffic']!r} gives no {m['name']!r}")
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    reading = tracer.reading()
    if reading is not None:
        r = Reading(reading, cfg, wl, win.counts)
        for m in bench.per_layer(cell):
            v = bench.reader(m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": entry["chips"], "memory_peak_bytes": peak}
    if reading is not None:
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
    out = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
           "metrics": metrics, "device": dev, "window": dict(win.counts)}
    if reading is not None:
        out["breakdown"] = reading.breakdown()
    if diagnose:
        out["not_compared"] = {c.name: c.value for c in checks if c.limit is None}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    return out
