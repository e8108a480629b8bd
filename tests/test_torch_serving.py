"""The port's serving path (privacy_preserve_federated_asr_tpu_torch/serving)
on the CPU: the engine against the JAX InferenceEngine under the same
weights at stages 0 and 1, batching and bucketing invariants, the
micro-batching dispatcher, the HTTP front-end, and stage-2 determinism."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from privacy_preserve_federated_asr_tpu.models import (
    BackboneConfig as JaxBackboneConfig,
    DACSConfig as JaxDACSConfig,
    DACSModel as JaxDACSModel,
)
from privacy_preserve_federated_asr_tpu.serving import (
    InferenceEngine as JaxEngine,
    ServingConfig as JaxServingConfig,
)
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.serving import (
    InferenceEngine,
    ServingConfig,
    make_server,
)
from test_torch_backbone import TINY, one_torch_thread, random_flax_params  # noqa: F401

# tests/test_serving.py::_engine's setting
SCFG = dict(batch_size=4, time_multiple=3200, max_seconds=2.0,
            batch_window_ms=5.0, compute_dtype="float32")


@pytest.fixture(scope="module")
def params():
    """numpy flax params for the tiny DACS model (shared by both engines)."""
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**TINY))
    return random_flax_params(
        JaxDACSModel(jcfg), (np.zeros((1, 3200), np.float32),), seed=9,
        rng_names=("params", "gumbel", "dropout"))


def _engine(params, stage=0, **kw):
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=stage)
    sd = state_dict_from_flax(params, cfg)
    return InferenceEngine(cfg, sd, scfg=ServingConfig(**{**SCFG, **kw}), device="cpu")


def _wave(n, seed=0):
    return np.random.default_rng(seed).normal(0, 0.3, size=n).astype(np.float32)


@pytest.mark.parametrize("stage", [0, 1])
def test_engine_matches_jax_engine(params, stage):
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**TINY), stage=stage)
    jeng = JaxEngine(jcfg, params, scfg=JaxServingConfig(**SCFG))
    eng = _engine(params, stage)
    waves = [_wave(3200, 1), _wave(4000, 2), _wave(6000, 3)]
    for got, want in zip(eng.infer_batch(waves), jeng.infer_batch(waves)):
        assert got.transcript == want.transcript
        assert got.ad_pred == want.ad_pred
        assert (got.frames, got.samples) == (want.frames, want.samples)
        np.testing.assert_allclose(got.ad_prob, want.ad_prob, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stage", [0, 1])
def test_single_vs_batched(params, stage):
    """Padding rows and the row in the batch do not change a result. All
    three waves share one bucket: across buckets the last frames differ,
    because the stacked positional convs see zeroed padding only at their
    first layer (the JAX model's behaviour, kept)."""
    eng = _engine(params, stage)
    a, b, c = _wave(4000, 1), _wave(5000, 2), _wave(6000, 3)
    solo = eng.infer_batch([a])[0]
    batched = eng.infer_batch([b, a, c])[1]
    assert solo.transcript == batched.transcript
    assert solo.ad_pred == batched.ad_pred
    assert solo.frames == batched.frames
    np.testing.assert_allclose(solo.ad_prob, batched.ad_prob, rtol=1e-5)


def test_truncation_and_bucketing_as_jax(params):
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**TINY))
    for max_seconds in (2.0, 0.5):  # on the bucket grid, and off it
        eng = _engine(params, max_seconds=max_seconds)
        jeng = JaxEngine(jcfg, params, scfg=JaxServingConfig(
            **{**SCFG, "max_seconds": max_seconds}))
        for n in (1, 3200, 3201, 7999, 31_999, 10**9):
            assert eng._bucket(n) == jeng._bucket(n)
        assert eng._buckets() == jeng._buckets()
        assert eng.max_samples == jeng.max_samples == int(max_seconds * 16000)
    r = eng.infer_batch([_wave(100_000, 4)])[0]  # > max_seconds
    assert r.samples == 8000
    assert len(eng.infer_batch([_wave(3300, i) for i in range(7)])) == 7
    assert eng.infer_batch([]) == []


def test_dispatcher_coalesces_submits(params):
    eng = _engine(params, batch_window_ms=500.0)
    waves = [_wave(4800, seed=10 + i) for i in range(6)]
    sync = eng.infer_batch(waves)
    n0 = eng.forwards
    eng.start()
    try:
        futs = [eng.submit(w) for w in waves]
        got = [f.result(timeout=60) for f in futs]
    finally:
        eng.stop()
    assert eng.forwards - n0 == 2  # 6 requests -> batches of 4 and 2
    for s, a in zip(sync, got):
        assert (s.transcript, s.ad_pred, s.frames) == (a.transcript, a.ad_pred, a.frames)
        np.testing.assert_allclose(s.ad_prob, a.ad_prob, rtol=1e-5)


def test_http_server_roundtrip(params):
    eng = _engine(params)
    eng.start()
    srv = make_server(eng, host="127.0.0.1", port=0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert json.load(r)["ok"] is True
        wave = _wave(4800, seed=20)
        req = urllib.request.Request(
            f"{url}/asr", data=json.dumps({"audio": wave.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.load(r)
        want = eng.infer_batch([wave])[0]
        assert out["transcript"] == want.transcript
        assert (out["frames"], out["samples"]) == (want.frames, want.samples)

        s16 = (wave * 32767).astype("<i2")
        req = urllib.request.Request(
            f"{url}/asr", data=s16.tobytes(),
            headers={"Content-Type": "application/octet-stream",
                     "X-Audio-Format": "s16"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.load(r)
        want = eng.infer_batch([s16.astype(np.float32) / 32768.0])[0]
        assert out["transcript"] == want.transcript
        assert out["samples"] == 4800

        req = urllib.request.Request(f"{url}/stream/start", data=b"{}")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.load(r)["session"]
        for path, code in (("/stream/unknown", 404), ("/nope", 404)):
            req = urllib.request.Request(f"{url}{path}", data=b"{}")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.code == code
    finally:
        srv.shutdown()
        srv.server_close()
        eng.stop()
        th.join(timeout=10)
    assert not th.is_alive()


def test_stage2_answers_are_deterministic(params):
    eng = _engine(params, stage=2)
    waves = [_wave(3200, 1), _wave(6000, 3)]
    first, second = eng.infer_batch(waves), eng.infer_batch(waves)
    assert first == second
