"""On the card, at each cell's own size with a short window: a sound run
comes out correct, and the control (the program's own lower-precision
path: int8 W8A8 serving, int8 SwitchBack training) comes out not correct.

    python -m pytest portbench/tests -m cuda

Each case builds its cell in full (about a minute on an H100).
"""

import time

import pytest

from portbench.lib import harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 3_141_592_653


def _run(card, cell_name: str, control: bool) -> dict:
    cell, config, traffic, limits = harness.load_cell(cell_name, SPEC)
    ctx = harness.Context(cell, config, traffic, limits, SEED, 3.0, False, card,
                          time.perf_counter(), control)
    return harness.result(SPEC, ctx, harness.run_kind(ctx))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(card, cell):
    line = _run(card, cell, control=False)
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    line = _run(card, cell, control=True)
    assert not line["correct"], line["checks"]
