"""Runs with the timed path broken underneath see ``correct`` come out
false: the whole run (traffic, window, reference comparison) on the CPU at
the tiny size, with the card check of ``run.py`` the only step left out.
One case per fault a cell can have; a one-card cell has no exchange between
chips to leave out. The case ``none`` is the sound run beside them."""

import numpy as np
import pytest

from portbench.lib.faults import FAULTS
from portbench.tests.conftest import run_tiny

TRAIN = "d2v-large.train-s0.b64x5s"
SERVE = "serve.backlog"  # a serving test cell


@pytest.mark.parametrize("cell,fault", [
    (TRAIN, "none"), (TRAIN, "state_unchanged"), (TRAIN, "half_batch"),
    (TRAIN, "label_altered"),
    (SERVE, "none"), (SERVE, "token_altered"), (SERVE, "serve_half_batch"),
])
def test_fault_makes_run_incorrect(monkeypatch, cell, fault):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    line = run_tiny(cell)
    assert line["correct"] is (fault == "none"), line["checks"]
    assert np.isfinite([c["value"] for c in line["checks"].values()]).all()
