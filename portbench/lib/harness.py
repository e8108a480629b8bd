"""The general harness: find a cell, run its kind of traffic, read its
metrics, judge its outputs and print the result line.

Everything particular to a cell is data found by name:

* ``BENCHMARK.json`` names the cell's configuration and traffic mix;
* ``configs/<file>`` (the configuration's ``file``) holds the model sizes;
* ``traffic/<traffic>.json`` holds the mix's parameters and its ``kind``,
  the module ``kinds/<kind>.py`` that runs it;
* ``limits/<cell>.json`` holds the limits of the numbers ``correct``
  compares;
* ``metrics/<metric>.py`` reads one per-layer metric from what the run
  observed (``read(obs) -> float | None``; None: nothing to read, and the
  metric is left out of the line).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "privacy_preserve_federated_asr_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Check:
    """One compared number: correct where ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float           # process start, on the perf_counter clock
    control: bool = False      # run the program's lower-precision path


@dataclass
class Outcome:
    e2e: dict                  # end-to-end metric name -> value
    attempted: int
    failed: int
    t_window: float            # perf_counter at the first timed operation
    memory_peak: int
    checks: list = field(default_factory=list)
    obs: dict = field(default_factory=dict)  # what the per-layer readers read
    trace: object = None       # lib.trace.Trace of the sub-window, or None


def load_spec(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, spec: dict) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, traffic, limits) of a cell named in ``spec``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((REPO / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())
    return cell, config, traffic, limits


def run_kind(ctx: Context) -> Outcome:
    kind = importlib.import_module(f"portbench.kinds.{ctx.traffic['kind']}")
    return kind.run(ctx)


def read_metric(name: str, obs: dict):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(obs)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def free_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def result(spec: dict, ctx: Context, out: Outcome) -> dict:
    values = {}
    for m in cell_metrics(spec, ctx.cell["name"], ctx.trace):
        if ctx.trace:
            v = read_metric(m["name"], out.obs)
        elif m["name"] == "setup_s":
            v = out.t_window - ctx.t_process
        else:
            v = out.e2e[m["name"]]
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(out.memory_peak)}
    line = {"correct": out.failed == 0 and all(c.ok for c in out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": values, "device": device}
    if ctx.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": float(c.value), "limit": float(c.limit)}
                      for c in out.checks}
    return line


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv, t_process: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the program's lower-precision path in the program's place "
                         "(calibration of the limits; the benchmark's runs do not use it)")
    args = ap.parse_args(argv)
    spec = load_spec()
    cell, config, traffic, limits = load_cell(args.workload, spec)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available()="
            f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}")
        return 3
    log(f"card: {power_limit()}")
    ctx = Context(cell, config, traffic, limits, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), t_process, args.control)
    out = run_kind(ctx)
    line = result(spec, ctx, out)
    found = forbidden_modules()
    if found:
        log(f"refusing to report: loaded modules {found}")
        return 4
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0
