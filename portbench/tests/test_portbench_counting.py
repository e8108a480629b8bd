"""The benchmark's operation and byte counts against the kernel table's
bound column (PERF.md, "Every TPU kernel of the repo"), at its shapes, and
the model-step counts against a count made layer by layer."""

import json

import pytest

from portbench.lib import counting
from portbench.lib.harness import BENCH_DIR

H, D = 16, 64

# (backward, dtype, B, Tq, Tk, bound ms as the table gives it)
TABLE = [
    (False, "bfloat16", 8, 1499, 1499, 0.0744),
    (False, "bfloat16", 8, 249, 249, 0.0049),
    (False, "bfloat16", 16, 249, 249, 0.0097),
    (False, "float32", 8, 1499, 1499, 0.4462),
    (False, "float32", 8, 249, 249, 0.0123),
    (False, "bfloat16", 16, 125, 249, 0.0073),
    (False, "bfloat16", 8, 750, 1499, 0.0372),
    (False, "float32", 16, 125, 249, 0.0146),
    (False, "float32", 8, 750, 1499, 0.2233),
    (True, "bfloat16", 16, 249, 249, 0.0195),
    (True, "bfloat16", 8, 1499, 1499, 0.1861),
    (True, "float32", 16, 249, 249, 0.0616),
    (True, "float32", 8, 1499, 1499, 1.1156),
    # the table read 0.0147 here: its stated formula gives 0.0146 (0.0147
    # also counts B1's 128 KB of LSE, which no other row counts)
    (True, "bfloat16", 16, 125, 249, 0.0146),
    (True, "bfloat16", 8, 750, 1499, 0.0931),
    (True, "float32", 16, 125, 249, 0.0309),
    (True, "float32", 8, 750, 1499, 0.5582),
]


@pytest.mark.parametrize("backward,dtype,b,tq,tk,bound_ms", TABLE)
def test_attention_bound_matches_kernel_table(backward, dtype, b, tq, tk, bound_ms):
    w = counting.attention_call([tq] * b, [tk] * b, H, D, backward=backward, dtype=dtype)
    assert round(w.least_s * 1e3, 4) == bound_ms


def test_attention_counts_valid_rows_only():
    full = counting.attention_call([249] * 8, None, H, D)
    padded = counting.attention_call([249] * 4 + [0] * 4, None, H, D)
    assert padded.flops == pytest.approx(full.flops / 2)
    assert padded.bytes == pytest.approx(full.bytes / 2)


def _cfg(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["data2vec-audio-large.dacs", "hubert-large-ls960.dacs"])
def test_encoder_flops_by_layer(name):
    cfg = _cfg(name)
    t, d, f = 249, 1024, 4096
    proj = 2 * t * 512 * d
    if cfg["pos_conv_type"] == "stacked":
        pos = 5 * 2 * t * d * 64 * 19
    else:
        pos = 2 * t * d * 64 * 128
    layer = 2 * t * d * d * 4 + 2 * t * d * f * 2 + 2 * (2 * t * t * d)
    assert counting.encoder_flops(cfg, t) == pytest.approx(proj + pos + 24 * layer)


def test_frontend_flops_per_audio_second():
    cfg = _cfg("data2vec-audio-large.dacs")
    frames = counting.conv_frames(cfg, 16000)
    assert frames == [3199, 1599, 799, 399, 199, 99, 49]
    expect = 2 * 512 * 10 * 3199 + sum(2 * 512 * 512 * k * n for k, n in
                                       zip([3, 3, 3, 3, 2, 2], frames[1:]))
    assert counting.frontend_flops(cfg, 16000) == pytest.approx(expect)


def test_train_step_is_three_forwards_of_the_trained_part():
    cfg = _cfg("data2vec-audio-large.dacs")
    one = counting.encoder_flops(cfg, 200) + 2 * 1024 * 32 * 200
    assert counting.train_step_flops(cfg, [200, 200]) == pytest.approx(6 * one)
