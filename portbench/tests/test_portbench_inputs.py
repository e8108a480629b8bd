"""The traffic generators and weights are functions of the seed, and seeds
change the order of the work, not its amount."""

import json

import numpy as np
import pytest
import torch

from portbench.lib import inputs
from portbench.lib.harness import BENCH_DIR
from portbench.tests.conftest import SERVING

SEEDS = (1, 2_147_483_659, 3_000_000_019)


def _traffic(name):
    if name in SERVING["traffic"]:
        return SERVING["traffic"][name]
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def test_train_corpus_is_a_function_of_the_seed():
    tr = dict(_traffic("train-s0.b64x5s"), batches=2, batch_size=4)
    a, b = inputs.train_corpus(tr, SEEDS[1]), inputs.train_corpus(tr, SEEDS[1])
    c = inputs.train_corpus(tr, SEEDS[2])
    assert all(np.array_equal(x, y) for x, y in zip(a["waves"], b["waves"]))
    assert np.array_equal(a["labels"], b["labels"])
    assert not np.array_equal(a["labels"], c["labels"])
    # the same lengths, in another order
    assert sorted(map(len, a["waves"])) == sorted(map(len, c["waves"]))
    assert [len(w) for w in a["waves"]] != [len(w) for w in c["waves"]]
    assert a["labels"].shape == (8, tr["label_chars"])
    assert a["labels"].min() >= 4 and a["labels"].max() < 32


@pytest.mark.parametrize("name", ["serve.backlog", "serve.open"])
def test_request_lengths_are_one_grid_in_seeded_orders(name):
    tr = _traffic(name)
    runs = [inputs.request_lengths(tr, s, tr["grid"]) for s in SEEDS]
    assert np.array_equal(runs[0], inputs.request_lengths(tr, SEEDS[0], tr["grid"]))
    for r in runs[1:]:
        assert np.allclose(np.sort(r), np.sort(runs[0]))
        assert not np.array_equal(r, runs[0])
    lo, hi = tr["lengths"]["lo_s"], tr["lengths"]["hi_s"]
    assert runs[0].min() >= lo and runs[0].max() <= hi


def test_lognormal_grid_has_the_stated_median():
    tr = _traffic("serve.open")
    grid = inputs.lengths_from(tr["lengths"], tr["grid"])
    assert np.median(grid) == pytest.approx(tr["lengths"]["median_s"], rel=0.01)


def test_arrivals_are_the_same_gaps_in_seeded_orders():
    tr = _traffic("serve.open")
    a = inputs.arrival_offsets(tr, SEEDS[0], 50.0, 10.0)
    b = inputs.arrival_offsets(tr, SEEDS[1], 50.0, 10.0)
    assert np.array_equal(a, inputs.arrival_offsets(tr, SEEDS[0], 50.0, 10.0))
    assert len(a) == len(b) == 500 and a[0] == 0.0 and np.all(np.diff(a) > 0)
    grid = inputs.quantiles_exponential(1.0 / 50.0, 500)
    for offsets in (a, b):  # every gap is one of the grid's
        assert np.isin(np.round(np.diff(offsets), 9), np.round(grid, 9)).all()
        assert offsets[-1] == pytest.approx(10.0, rel=0.05)
    assert not np.array_equal(a, b)


def test_clip_pool_cuts_are_seeded_views():
    p, q = inputs.ClipPool(SEEDS[1], 2, 4.0), inputs.ClipPool(SEEDS[1], 2, 4.0)
    a, b = p.cut(2.5), q.cut(2.5)
    assert len(a) == 40000 and np.array_equal(a, b)
    assert any(a.base is c for c in p.clips)


def test_weights_are_a_function_of_the_seed():
    from portbench.tests.conftest import tiny_config

    cfg = tiny_config("data2vec-audio-large.dacs")
    a = inputs.draw_weights(cfg, SEEDS[1], "cpu")
    b = inputs.draw_weights(cfg, SEEDS[1], "cpu")
    c = inputs.draw_weights(cfg, SEEDS[2], "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    ln = a["backbone.encoder.layers.0.layer_norm.weight"]
    assert abs(float(ln.mean()) - 1.0) < 0.05
