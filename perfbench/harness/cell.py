"""One run of one cell: the manifest's files found by name, the cell's loop
driven, its metrics read, its outputs judged, one result made.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by the name in ``BENCHMARK.json``:

- ``perfbench/configs/<config>.json``: the sizes under the source's key
  names; its ``reference`` names the plain reference,
  ``perfbench/reference/<reference>.py``, which reads the file
  (``Dims.from_file``), states the program's configuration fields
  (``program_fields``) and computes the reference's answers;
- ``perfbench/traffic/<mix>.json``: parameters; its ``loop`` names the
  loop that drives the program (``train`` or ``serve``) and its
  ``generator`` the general generator, ``perfbench/generators/<name>.py``,
  whose ``Feed`` makes the inputs from the seed;
- ``perfbench/metrics/<metric>.py``: a ``read(r)`` that returns the
  number or None;
- ``perfbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path

import torch

from . import serve_loop, train_loop

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
LOOPS = {"train": train_loop.run, "serve": serve_loop.run}
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str) -> dict:
    """The paths of a cell's files, by the names the manifest gives."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"cell": cell,
            "config": ROOT / conf["file"],
            "traffic": BENCH / "traffic" / f"{cell['traffic']}.json",
            "limits": BENCH / "limits" / f"{workload}.json",
            "metrics": {m["name"]: BENCH / "metrics" / f"{m['name']}.py"
                        for m in bench["per_layer"]
                        if workload in m.get("workloads", [workload])}}


def inputs(f: dict) -> tuple[dict, dict, dict]:
    """The contents of a cell's configuration, mix and limits files."""
    return tuple(json.loads(f[k].read_text())
                 for k in ("config", "traffic", "limits"))


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py``: a reference or a generator, imported
    as ``perfbench.<kind>.<name>`` (so the tools that patch it patch the
    module the run uses)."""
    if not name.isidentifier():
        raise ValueError(f"{kind} module {name!r} is not a Python name")
    return importlib.import_module(f"perfbench.{kind}.{name}")


def reader(path: Path):
    """A metric's ``read``, loaded from its file (a metric's name may
    hold a dot)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a loop is given and what it leaves: its inputs, the end-to-end
    values, host measurements and the traced window for the metric
    readers, the numbers that decide ``correct``."""
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    ref: object = None              # the configuration's reference module
    feeds: object = None            # the mix's generator module
    dims: object = None
    setup_s: float = None
    peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)
    host: dict = dataclasses.field(default_factory=dict)
    work: dict = dataclasses.field(default_factory=dict)
    traced: object = None
    checks: dict = dataclasses.field(default_factory=dict)
    phases: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.ref = module("reference", self.config["reference"])
        self.feeds = module("generators", self.traffic["generator"])
        self.dims = self.ref.Dims.from_file(self.config)

    def phase(self, name: str):
        """Note the seconds since the process started at the end of a
        set-up phase (printed beside the result, not a metric)."""
        self.sync()
        self.phases[name] = time.perf_counter() - self.t_start

    def mark_setup(self):
        self.phase("setup")
        self.setup_s = self.phases["setup"]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def read_peak(self):
        if self.device.type == "cuda":
            self.sync()
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: float | None = None):
    """Drive ``workload`` once.  Returns the ``Run``, the result line's
    object and the per-check report."""
    bench = manifest()
    f = cell_files(bench, workload)
    config, traffic, limits = inputs(f)
    r = Run(config=config, traffic=traffic, seed=seed, seconds=seconds,
            trace=trace, device=torch.device(device),
            t_start=time.perf_counter() if t_start is None else t_start)
    r.phase("imports")
    LOOPS[r.traffic["loop"]](r)
    r.free()
    return r, result(bench, f, r, limits)


def result(bench: dict, f: dict, r: Run, limits: dict) -> dict:
    name = f["cell"]["name"]
    checks = {k: {"value": v, "limit": limits[k]["limit"]}
              for k, v in sorted(r.checks.items()) if k in limits}
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    if r.trace:
        metrics = {}
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for m, path in f["metrics"].items():
            value = reader(path)(r)
            if value is not None:
                metrics[m] = {"value": value, "unit": units[m]}
    else:
        values = dict(r.e2e, setup_s=r.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if name in m.get("workloads", [name])}
    device = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(r.device)
                       if r.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": r.peak_bytes}
    out = {"correct": correct, "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": device}
    if r.trace and r.traced is not None:
        device["busy_s"] = r.traced.busy_s
        device["window_s"] = r.traced.window_s
        out["breakdown"] = {"device_ops": r.traced.top_ops(),
                            "idle_gaps": r.traced.top_gaps()}
    out["checks"] = checks
    return out


def forbidden_modules(modules) -> list[str]:
    """Top-level names, compared whole, of the JAX side found loaded."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)
