"""Fixtures of the benchmark's own tests: a card check made inside a
fixture (never at import), and cells run on the CPU at a tiny size.

Run them from the repository root: ``python -m pytest portbench/tests``.
The tests marked ``cuda`` need the card and skip without one.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import pytest
import torch

from portbench.lib import harness

# serving cells that only the tests run (BENCHMARK.json has none yet)
SERVING = json.loads((Path(__file__).parent / "serving_cells.json").read_text())

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            conv_dim=[16] * 7, conv_pos_kernel_size=5, num_conv_pos_embedding_groups=4)


def tiny_config(name: str) -> dict:
    """A configuration file's model at a width and depth the CPU runs in
    seconds (the conv strides kept, so frames per second are the real
    ones)."""
    cfg = json.loads((harness.BENCH_DIR / "configs" / f"{name}.json").read_text())
    cfg.update(copy.deepcopy(TINY))
    cfg["num_conv_pos_embeddings"] = 2 if cfg["pos_conv_type"] == "stacked" else 8
    return cfg


def tiny_traffic(traffic: dict) -> dict:
    traffic = dict(traffic)
    if traffic["kind"] == "trainer":
        traffic.update(batch_size=4, batches=3, reference_block=2, warmup_steps=1,
                       trace_steps=2, label_chars=8)
    else:
        # a sample of 64 judges about every request of a tiny run, so a fault
        # that spoils some rows of a batch cannot slip past by the sample
        traffic.update(max_seconds=4.0, lengths={"dist": "uniform", "lo_s": 1.0, "hi_s": 3.0},
                       warmup_buckets_s=[1, 4], clips=2, clip_s=4.0, outstanding=8,
                       warmup_s=0.3, trace_s=0.5, check_sample=64, rate_rps=10.0)
    return traffic


def spec_with_test_cells() -> dict:
    """``BENCHMARK.json`` with the serving test cells, their configurations
    and their metrics added."""
    spec = harness.load_spec()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        spec[key] = spec[key] + copy.deepcopy(SERVING[key])
    return spec


def load_cell(name: str, spec: dict) -> tuple[dict, dict, dict, dict]:
    """``harness.load_cell``, which also finds the serving test cells."""
    if name not in SERVING["limits"]:
        return harness.load_cell(name, spec)
    cell = {w["name"]: w for w in spec["workloads"]}[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((harness.REPO / conf["file"]).read_text())
    return (cell, config, copy.deepcopy(SERVING["traffic"][cell["traffic"]]),
            dict(SERVING["limits"][name]))


def run_tiny(cell_name: str, seed: int = 2_718_281_828, seconds: float = 1.0,
             trace: bool = False, dtype: str | None = None) -> dict:
    """One run of a cell on the CPU at the tiny size, through the harness
    (its traffic, the reference comparison and the result line); the card
    check of ``run.py`` is the only step left out."""
    spec = spec_with_test_cells()
    cell, config, traffic, limits = load_cell(cell_name, spec)
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = tiny_config(conf["file"].rsplit("/", 1)[-1][:-len(".json")])
    if dtype is not None:
        config["compute_dtype"] = dtype
    ctx = harness.Context(cell, config, tiny_traffic(traffic), limits, seed, seconds, trace,
                          torch.device("cpu"), time.perf_counter())
    return harness.result(spec, ctx, harness.run_kind(ctx))


@pytest.fixture
def card():
    """The CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
