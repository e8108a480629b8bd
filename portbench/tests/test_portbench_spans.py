"""The readers of the card's idle time split by the program's spans
(``lib/spans.py``, ``metrics/idle_*.train.py``, ``ctc_launches.train``)
on hand-built traces with fixed CPU and device events, and on the card one
traced run of the training kind, whose CTC backward runs on autograd's
device thread.

    python -m pytest portbench/tests/test_portbench_spans.py [-m cuda]
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.lib import harness
from portbench.lib.trace import Trace
from portbench.tests.conftest import tiny_config, tiny_traffic

SHARES = ("idle_ctc.train", "idle_forward.train", "idle_backward.train",
          "idle_optim.train", "idle_other.train")
READERS = SHARES + ("ctc_launches.train",)


def _event(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def _trace(cpu, device, window_us) -> Trace:
    """A Trace of CPU events ``(name, start_us, end_us)`` and device
    kernels ``(start_us, end_us)`` over a sub-window of ``window_us``."""
    events = [_event(*c) for c in cpu]
    events += [_event(f"kernel{i}", a, b, DeviceType.CUDA) for i, (a, b) in enumerate(device)]
    return Trace(events, window_us / 1e6)


# one step over a 300 us sub-window: kernels busy 50 us, idle gaps (10, 20),
# (30, 50), (60, 100), (110, 200), and 90 us after the last kernel
DEVICE = [(0, 10), (20, 30), (50, 60), (100, 110), (200, 210)]
STEP = [("dacs.train.step", 0, 250), ("dacs.train.gather", 0, 5),
        ("dacs.train.forward", 5, 40), ("dacs.train.loss", 40, 95),
        ("dacs.ctc.forward", 45, 70), ("dacs.train.backward", 95, 180),
        ("dacs.ctc.backward", 120, 150), ("dacs.train.optim", 180, 205)]
# by phase, in us of idle: ctc (45, 50) + (60, 70) + (120, 150); forward
# and loss (10, 20) + (30, 45) + (70, 95); backward (95, 100) + (110, 120)
# + (150, 180); optim (180, 200); other the 90 us after the last kernel
WANT = {"idle_ctc.train": 45 / 3, "idle_forward.train": 50 / 3,
        "idle_backward.train": 45 / 3, "idle_optim.train": 20 / 3,
        "idle_other.train": 90 / 3}


def _obs(trace, steps=1):
    return {"trace": trace, "trace_steps": steps, "window_s": 1.0, "flops": 0.0}


def test_idle_shares_are_split_exactly():
    obs = _obs(_trace(STEP, DEVICE, 300))
    for name, want in WANT.items():
        assert harness.read_metric(name, obs) == pytest.approx(want, abs=1e-9), name


def test_shares_sum_to_idle():
    obs = _obs(_trace(STEP, DEVICE, 300))
    idle = harness.read_metric("idle.train", obs)
    assert idle == pytest.approx(250 / 3, abs=1e-9)
    assert sum(harness.read_metric(n, obs) for n in SHARES) == pytest.approx(idle, abs=1e-9)


def test_straddling_gap_is_split_by_time():
    """One gap (10, 50) under the forward to 30 and the backward from 30,
    whose CTC backward (35, 45) takes its own part of the backward's."""
    cpu = [("dacs.train.forward", 0, 30), ("dacs.train.backward", 30, 60),
           ("dacs.ctc.backward", 35, 45)]
    obs = _obs(_trace(cpu, [(0, 10), (50, 60)], 100))
    got = {n: harness.read_metric(n, obs) for n in SHARES}
    assert got["idle_forward.train"] == pytest.approx(20.0)
    assert got["idle_backward.train"] == pytest.approx(10.0)
    assert got["idle_ctc.train"] == pytest.approx(10.0)
    assert got["idle_optim.train"] is None  # no optimizer span in this trace
    assert got["idle_other.train"] == pytest.approx(40.0)


def test_only_launches_inside_ctc_spans_count():
    cpu = STEP + [("cudaLaunchKernel", 46, 47), ("cudaLaunchKernelExC", 69, 70),
                  ("cuLaunchKernel", 121, 122), ("cudaLaunchKernel", 150, 151),
                  ("cudaLaunchKernel", 44, 45), ("cudaLaunchKernel", 160, 161),
                  ("cudaMemcpyAsync", 130, 131), ("aten::logaddexp", 125, 126)]
    obs = _obs(_trace(cpu, DEVICE, 300), steps=2)
    # inside: 46, 69 (forward) and 121, 150 (backward, its end included)
    assert harness.read_metric("ctc_launches.train", obs) == 2.0


@pytest.mark.parametrize("name", READERS)
def test_readers_need_a_trace_and_spans(name):
    assert harness.read_metric(name, _obs(None)) is None
    no_spans = [("portbench.train_step", 0, 250), ("aten::mm", 5, 40),
                ("cudaLaunchKernel", 46, 47)]
    assert harness.read_metric(name, _obs(_trace(no_spans, DEVICE, 300))) is None


@pytest.mark.cuda
def test_ctc_backward_is_recorded_on_card(card):
    """A traced run of the training kind on the card (the model cut to two
    layers of 2 heads of 64, the kernels' head size): each traced step
    records the CTC forward and, from autograd's device thread, its
    backward; the five shares add up to ``idle.train``."""
    spec = harness.load_spec()
    cell, _, traffic, limits = harness.load_cell("d2v-large.train-s0.b64x5s", spec)
    config = tiny_config("data2vec-audio-large.dacs")
    config.update(hidden_size=128, num_attention_heads=2, intermediate_size=256)
    ctx = harness.Context(cell, config, tiny_traffic(traffic), limits, 2_147_483_659, 1.0,
                          True, card, time.perf_counter())
    obs = harness.run_kind(ctx).obs
    names = [n for n, _, _ in obs["trace"].cpu]
    assert names.count("dacs.ctc.backward") == obs["trace_steps"]
    assert names.count("dacs.ctc.forward") == obs["trace_steps"]
    got = {n: harness.read_metric(n, obs) for n in READERS}
    assert all(v is not None for v in got.values()), got
    assert got["ctc_launches.train"] > 0
    idle = harness.read_metric("idle.train", obs)
    assert sum(got[n] for n in SHARES) == pytest.approx(idle, abs=1e-6)
