"""The result line's schema, BENCHMARK.json against the benchmark's
contract, the data files every cell needs, and the check that no JAX
module was loaded."""

import json
import math
import os
import re
import subprocess
import sys

import pytest

from portbench.lib import harness
from portbench.tests.conftest import SERVING, load_cell, run_tiny, spec_with_test_cells

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
TEST_SPEC = spec_with_test_cells()
TEST_CELLS = CELLS + [w["name"] for w in SERVING["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"] == ["python3", "portbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for item in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    assert len(set(CELLS)) == len(CELLS)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in SPEC["end_to_end"]}["setup_s"] == 0.25


@pytest.mark.parametrize("cell", TEST_CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = [m["name"] for m in harness.cell_metrics(TEST_SPEC, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(TEST_SPEC, cell, True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e  # a per-layer metric's cells report what it moves


@pytest.mark.parametrize("cell", TEST_CELLS)
def test_every_cell_has_its_files(cell):
    c, config, traffic, limits = load_cell(cell, TEST_SPEC)
    assert (harness.BENCH_DIR / "kinds" / f"{traffic['kind']}.py").exists()
    for m in harness.cell_metrics(TEST_SPEC, cell, True):
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
    assert c["chips"] == 1 and len(c["why"]) <= 200
    assert all(v > 0 for v in limits.values())


@pytest.mark.parametrize("spec", [SPEC, TEST_SPEC], ids=["benchmark", "with_test_cells"])
def test_configs_are_used_and_their_files_under_paths(spec):
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert c["name"] in used and c["file"].startswith("portbench/")
        assert c["source"].startswith("https://")


@pytest.mark.parametrize("cell,trace", [(CELLS[0], True), ("serve.backlog", False),
                                        ("serve.open", True)])
def test_result_line_schema(cell, trace):
    line = run_tiny(cell, trace=trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    json.dumps(line)  # serializable, no NaN
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = {m["name"]: m["unit"] for m in harness.cell_metrics(TEST_SPEC, cell, trace)}
    assert set(line["metrics"]) <= set(wanted)
    for name, v in line["metrics"].items():
        assert v["unit"] == wanted[name] and math.isfinite(v["value"])
    if not trace:
        assert set(line["metrics"]) == set(wanted)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "privacy_preserve_federated_asr_tpu_torch.x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "privacy_preserve_federated_asr_tpu.models", sys)
    assert harness.forbidden_modules() == ["jax", "privacy_preserve_federated_asr_tpu"]


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process: the harness, the kinds of traffic, the
    port and the reference load neither JAX nor the JAX package."""
    code = ("from portbench.tests.conftest import run_tiny\n"
            "from portbench.lib.harness import forbidden_modules\n"
            "run_tiny('serve.open')\n"
            "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                         cwd=harness.REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
