"""The port's streaming and int16 serving paths on the CPU
(privacy_preserve_federated_asr_tpu_torch/serving/streaming.py, the engine's
int16 transport and resident windows, the /stream/* routes, cli
stream-client and cli stream-report), held against the JAX package's
StreamingSession, StreamingHub, measure_finalization_flips and int16 engine
on the same weights (bridged by state_dict_from_flax) and the same numpy
audio.

Shapes are chosen so that every pass of every path lands in one time bucket
(6400 samples): the JAX engine compiles one program per bucket and path, and
one JAX engine (built with ``beam_size`` and the int16 transport so that
every program it can run exists) serves all the comparisons, its
``ServingConfig`` swapped per case; the swapped fields are read at call
time. Stage 0, where the served streams carry no Gumbel noise. Tolerances:
transcripts, frame counts and AD votes equal; AD probabilities within 1e-5
(float32) or 1e-4 (int16: the same int16 codes, dequantized and normalized
on the device in another summation order)."""

import contextlib
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from scipy.io import wavfile

from privacy_preserve_federated_asr_tpu.data.tokenizer import CTCCharTokenizer as JaxTok
from privacy_preserve_federated_asr_tpu.models import (
    BackboneConfig as JaxBackboneConfig,
    DACSConfig as JaxDACSConfig,
    DACSModel as JaxDACSModel,
)
from privacy_preserve_federated_asr_tpu.ops.beam import CharBigramLM as JaxLM
from privacy_preserve_federated_asr_tpu.serving import (
    InferenceEngine as JaxEngine,
    ServingConfig as JaxServingConfig,
    StreamingConfig as JaxStreamingConfig,
    StreamingHub as JaxHub,
    StreamingSession as JaxSession,
    measure_finalization_flips as jax_flips,
)
from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.data.tokenizer import CTCCharTokenizer
from privacy_preserve_federated_asr_tpu_torch.ops.beam import CharBigramLM
from privacy_preserve_federated_asr_tpu_torch.serving import (
    InferenceEngine,
    ServingConfig,
    StreamingConfig,
    StreamingHub,
    StreamingSession,
    make_server,
    measure_finalization_flips,
)
from test_torch_backbone import TINY, one_torch_thread, random_flax_params  # noqa: F401

# one encoder layer: every JAX program here compiles in about half the time
ONE_LAYER = dict(**TINY, num_hidden_layers=1)

Q = 3200                      # one feed: 0.2 s
SCFG = dict(batch_size=2, time_multiple=2 * Q, max_seconds=0.8, compute_dtype="float32")
TOK = CTCCharTokenizer()
LM_TEXTS = ("HELLO WORLD", "OK GO", "THE BOY")
BEAM = 4


@pytest.fixture(scope="module")
def params():
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**ONE_LAYER), stage=0)
    return random_flax_params(JaxDACSModel(jcfg), (np.zeros((1, Q), np.float32),), seed=9,
                              rng_names=("params", "gumbel", "dropout"))


@pytest.fixture(scope="module")
def jax_engine(params):
    """One JAX engine for every comparison; ``use(**scfg)`` swaps its
    ServingConfig fields that are read per call (transport, beam)."""
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**ONE_LAYER), stage=0)
    jtok = JaxTok()
    lm = JaxLM(jcfg.backbone.vocab_size).fit([jtok.encode(t) for t in LM_TEXTS])
    base = JaxServingConfig(**SCFG, beam_size=BEAM, transport="int16")
    eng = JaxEngine(jcfg, params, jtok, base, lm_fn=lm)

    def use(**kw):
        eng.scfg = dataclasses.replace(base, **{"beam_size": 0, "transport": "float32", **kw})
        return eng

    return use


# the port-only cases: a finer bucket grid, smaller forwards
SMALL = dict(time_multiple=Q // 2, max_seconds=0.6)
H = Q // 2                    # one feed of the port-only cases: 0.1 s


def _engine(params, **kw):
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(**ONE_LAYER), stage=0)
    lm = None
    if kw.get("beam_size"):
        lm = CharBigramLM(cfg.backbone.vocab_size).fit([TOK.encode(t) for t in LM_TEXTS])
    return InferenceEngine(cfg, state_dict_from_flax(params, cfg), TOK,
                           ServingConfig(**{**SCFG, **kw}), lm_fn=lm, device="cpu")


def _wave(n, seed=0):
    return np.random.default_rng(seed).normal(0, 0.3, size=n).astype(np.float32)


def _state(r):
    return (r.transcript, r.final_transcript, r.final_frames, r.total_frames, r.ad_pred,
            r.is_final)


def _same(got, want, atol=1e-5):
    assert _state(got) == _state(want)
    np.testing.assert_allclose(got.ad_prob, want.ad_prob, rtol=0, atol=atol)


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "legacy"])
def test_session_matches_jax_every_feed(params, jax_engine, resident):
    """Per feed: transcript, final transcript, finalized and total frames
    against the JAX session (right context 0.1 s: frames finalize early),
    then finish(); one engine forward per pass."""
    jeng, eng = jax_engine(), _engine(params)
    audio = _wave(2 * Q, seed=1)
    kw = dict(right_context_seconds=0.1, min_hop_seconds=0.0, resident=resident)
    js, s = JaxSession(jeng, JaxStreamingConfig(**kw)), StreamingSession(eng, StreamingConfig(**kw))
    for i in range(2):
        chunk = audio[i * Q : (i + 1) * Q]
        got, want = s.feed(chunk), js.feed(chunk)
        _same(got, want)
        assert 0 < got.final_frames < got.total_frames
        assert s._final_ids == js._final_ids and s._tail_ids == js._tail_ids
    final = s.finish()
    _same(final, js.finish())
    assert (s.result().transcript, s.result().samples) == (final.transcript, 2 * Q)
    assert eng.forwards == 3


def test_int16_transport_matches_jax(params, jax_engine):
    """transport="int16": the batch path and a resident session (each piece
    its own int16 scale) against the JAX int16 engine; the int16 batch
    against the float32 batch (votes and transcripts equal); the upload is
    half the float32 batch's."""
    jeng, eng = jax_engine(transport="int16"), _engine(params, transport="int16")
    waves = [_wave(2 * Q, seed=2), _wave(5000, seed=3)]
    for got, want in zip(eng.infer_batch(waves), jeng.infer_batch(waves)):
        assert (got.transcript, got.ad_pred, got.frames, got.samples) == (
            want.transcript, want.ad_pred, want.frames, want.samples)
        np.testing.assert_allclose(got.ad_prob, want.ad_prob, rtol=0, atol=1e-4)
    f32 = _engine(params)
    n0, b0 = f32.h2d_bytes, eng.h2d_bytes
    for a, b in zip(eng.infer_batch(waves), f32.infer_batch(waves)):
        assert (a.transcript, a.ad_pred, a.frames) == (b.transcript, b.ad_pred, b.frames)
    assert (eng.h2d_bytes - b0) * 2 - (f32.h2d_bytes - n0) < 64  # + the scales
    kw = dict(right_context_seconds=0.1, min_hop_seconds=0.0)
    js, s = JaxSession(jeng, JaxStreamingConfig(**kw)), StreamingSession(eng, StreamingConfig(**kw))
    for i in range(2):
        chunk = waves[0][i * Q : (i + 1) * Q]
        _same(s.feed(chunk), js.feed(chunk), atol=1e-4)
    _same(s.finish(), js.finish(), atol=1e-4)


def test_hub_matches_standalone_and_jax_hub(params, jax_engine):
    """Two hub members against standalone resident sessions fed alike (the
    hub changes dispatch, not results) and against the JAX hub, feed by
    feed; one batched pass per fleet hop, the finishes one each."""
    jeng, eng = jax_engine(), _engine(params)
    kw = dict(right_context_seconds=0.1, min_hop_seconds=0.0)
    hub, jhub = StreamingHub(eng, StreamingConfig(**kw)), JaxHub(jeng, JaxStreamingConfig(**kw))
    audios = [_wave(2 * Q, seed=20), _wave(Q, seed=21)]
    hs, js = [hub.open(), hub.open()], [jhub.open(), jhub.open()]
    solo = [StreamingSession(eng, StreamingConfig(**kw)) for _ in audios]
    for i in range(2):
        for k, audio in enumerate(audios):
            chunk = audio[i * Q : (i + 1) * Q]
            if len(chunk):
                got = hs[k].feed(chunk)
                _same(got, js[k].feed(chunk))
                _same(got, solo[k].feed(chunk))
    assert hub.passes == 3
    for k in range(2):
        got = hs[k].finish()
        _same(got, js[k].finish())
        _same(got, solo[k].finish())
    assert hub.passes == 5 and hub.active_sessions() == 0


def test_hub_rows_reuse_coalesce_and_close(params):
    """A full hub refuses, a freed row is zeroed (its next member decodes
    like the batch path), lockstep feeds run one pass per hop, a member 2
    hops ahead of a stalled peer forces one, and close() frees the row."""
    eng = _engine(params, **SMALL)
    hub = StreamingHub(eng, StreamingConfig(right_context_seconds=10.0, min_hop_seconds=0.0))
    a, b = hub.open(), hub.open()
    with pytest.raises(RuntimeError, match="hub full"):
        hub.open()
    a.feed(_wave(2 * H, seed=22))
    a.finish()
    c = hub.open()                      # a's row, zeroed
    audio = _wave(H, seed=23)
    c.feed(audio)
    assert c.finish().transcript == eng.infer_batch([audio])[0].transcript
    b.close()
    assert b.finish().is_final and hub.active_sessions() == 0

    hub = StreamingHub(eng, StreamingConfig(right_context_seconds=0.1, min_hop_seconds=0.1))
    a, b = hub.open(), hub.open()
    for i in range(3):                  # lockstep: a's first pass runs alone
        for k, s in enumerate((a, b)):
            s.feed(_wave(H, seed=40 + 10 * k + i))
    assert hub.passes == 3
    hub._step()                         # b's last chunk
    n0 = hub.passes
    a.feed(_wave(H, seed=50))
    assert hub.passes == n0             # b is not fresh: deferred
    a.feed(_wave(H, seed=51))
    assert hub.passes == n0 + 1         # 2 hops pending: forced
    a.finish()
    b.finish()
    assert hub.active_sessions() == 0


def test_warmup_buckets(params, jax_engine):
    """``warmup_buckets`` picks the shapes that warmup() and
    warmup_streaming(hub=True) run: each given sample count's bucket once
    (20000 caps at max_seconds), the same list as the JAX engine's; empty,
    the whole grid."""
    wb = (1000, 4800, 5000, 20000)
    eng = _engine(params, **SMALL, warmup_buckets=wb)
    want = [H, 3 * H, 4 * H, 6 * H]
    jeng = jax_engine()
    jeng.scfg = dataclasses.replace(jeng.scfg, **SMALL, warmup_buckets=wb)
    assert eng._buckets() == jeng._buckets() == want
    shapes, run = [], eng._run
    eng._run = lambda x, lengths: shapes.append(tuple(x.shape)) or run(x, lengths)
    assert eng.warmup() == 4 and shapes == [(2, t) for t in want]
    shapes.clear()
    assert eng.warmup_streaming(hub=True) == 8
    assert shapes == [(1, t) for t in want] + [(2, t) for t in want]
    assert _engine(params, **SMALL)._buckets() == [H * k for k in range(1, 7)]


def test_beam_streaming_matches_jax(params, jax_engine):
    """Beam 4 with the bigram LM: the carried beam state over early
    finalized frames against the JAX session, every feed."""
    jeng = jax_engine(beam_size=BEAM, lm_alpha=0.4)
    eng = _engine(params, beam_size=BEAM, lm_alpha=0.4)
    audio = _wave(Q, seed=7)
    kw = dict(right_context_seconds=0.05, min_hop_seconds=0.0, resident=False)
    js, s = JaxSession(jeng, JaxStreamingConfig(**kw)), StreamingSession(eng, StreamingConfig(**kw))
    for i in range(2):
        chunk = audio[i * Q // 2 : (i + 1) * Q // 2]
        _same(s.feed(chunk), js.feed(chunk))
    final = s.finish()
    _same(final, js.finish())
    assert final.transcript == final.final_transcript


def test_finalization_flips_match_jax(params, jax_engine):
    audios = [_wave(2 * Q, seed=s) for s in (3, 4)]
    kw = dict(right_context_grid=(0.05, 0.2, 10.0), hop_seconds=0.2, chunk_seconds=0.2)
    rows = measure_finalization_flips(_engine(params), audios, **kw)
    assert rows == jax_flips(jax_engine(), audios, **kw)
    assert rows[0]["finalized_frames"] > 0 and rows[-1]["finalized_frames"] == 0


def _post(url, path, payload=None, body=None, headers=None):
    data = body if body is not None else json.dumps(payload or {}).encode()
    req = urllib.request.Request(url + path, data=data, method="POST",
                                 headers=headers or {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def _serving(eng, **kw):
    srv = make_server(eng, host="127.0.0.1", port=0, **kw)
    th = threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.02},
                          daemon=True)
    th.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


@pytest.mark.parametrize("use_hub", [True, False], ids=["hub", "no_hub"])
def test_http_stream_routes(params, use_hub):
    """Three concurrent streams over /stream/*: with the hub, two are
    members and the third falls back to a standalone session; each result
    equals a standalone session fed alike; a finished or unknown session
    answers 404, also when its body is large and unread by the route."""
    eng = _engine(params, **SMALL)
    scfg = StreamingConfig(right_context_seconds=0.1, min_hop_seconds=0.0)
    audios = [_wave(2 * H, seed=40 + k) for k in range(3)]
    with _serving(eng, stream_cfg=scfg, use_hub=use_hub) as (srv, url):
        sids = [_post(url, "/stream/start")["session"] for _ in audios]
        got = {}
        for i in range(2):
            for k, sid in enumerate(sids):
                chunk = audios[k][i * H : (i + 1) * H]
                body = chunk.astype("<f4").tobytes() if k % 2 else None
                got[k, i] = _post(url, f"/stream/{sid}", {"audio": chunk.tolist()},
                                  body=body, headers={"Content-Type": "application/octet-stream"}
                                  if body else None)
        finals = [_post(url, f"/stream/{sid}/finish") for sid in sids]
        # a 4 MB body on a route that ignores it is read, not left to reset
        # the socket before the reply arrives
        for path, body in ((f"/stream/{sids[0]}", None), ("/stream/nope", b"\0" * (1 << 22)),
                           ("/nope", b"\0" * (1 << 22))):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, path, {"audio": [0.1] * 10}, body=body)
            assert ei.value.code == 404
    for k, audio in enumerate(audios):
        s = StreamingSession(eng, scfg)
        for i in range(2):
            want = s.feed(audio[i * H : (i + 1) * H])
            assert got[k, i]["transcript"] == want.transcript
            assert got[k, i]["final_frames"] == want.final_frames
        want = s.finish()
        assert finals[k]["is_final"] and finals[k]["transcript"] == want.transcript
        assert finals[k]["total_frames"] == want.total_frames


def test_http_reaper_spares_in_flight(params):
    """Idle sessions are reaped when a session starts; one whose request
    holds its lock is not."""
    eng = _engine(params, **SMALL)
    with _serving(eng, session_idle_ttl_s=0.05, use_hub=False) as (srv, url):
        idle, busy = (_post(url, "/stream/start")["session"] for _ in range(2))
        table = srv.stream_sessions
        table[busy].lock.acquire()          # a request in flight
        try:
            time.sleep(0.1)
            _post(url, "/stream/start")     # the reap runs here
            assert idle not in table and busy in table
        finally:
            table[busy].lock.release()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, f"/stream/{idle}", {"audio": _wave(H).tolist()})
        assert ei.value.code == 404
        assert _post(url, f"/stream/{busy}", {"audio": _wave(H).tolist()})["total_frames"] > 0


def test_cli_stream_client_and_report(params, tmp_path, monkeypatch, capsys):
    """`cli stream-client` against a served port engine equals a standalone
    session; `cli stream-report` (the tiny model's seeded random init)
    prints measure_finalization_flips' rows of the test CSV's audio."""
    eng = _engine(params, **SMALL)
    wave = _wave(Q, seed=60)
    (tmp_path / "clips").mkdir()
    wavfile.write(tmp_path / "clips" / "S001_PAR_0_0_250.wav", 16000,
                  (np.clip(wave, -1, 1) * 32767).astype(np.int16))
    (tmp_path / "test.csv").write_text("path,sentence\nS001_PAR_0_0_250.wav,ok go\n")
    np.save(tmp_path / "spk2label.npy", {"S001": 1})
    with _serving(eng) as (_, url):
        port = url.rsplit(":", 1)[1]
        final = cli.main(["stream-client", "--port", port, "--audio",
                          str(tmp_path / "clips" / "S001_PAR_0_0_250.wav"),
                          "--chunk_seconds", "0.1"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and json.loads(out[-1]) == final
    s = StreamingSession(eng)
    from privacy_preserve_federated_asr_tpu_torch.data.audio import load_audio

    audio = load_audio(str(tmp_path / "clips" / "S001_PAR_0_0_250.wav"), normalize=False)
    for i in range(0, len(audio), H):
        s.feed(audio[i : i + H])
    assert final["transcript"] == s.finish().transcript

    monkeypatch.chdir(tmp_path)
    rows = cli.main(["stream-report", "--model_type", "tiny", "--device", "cpu", "-st", "0",
                     "--compute_dtype", "float32", "--eval_batch_size", "2",
                     "--max_seconds", "0.2", "--audio_dir", "clips", "--test_csv", "test.csv",
                     "--spk2label", "spk2label.npy", "--dataset_cache", str(tmp_path / "cache"),
                     "--right_context_grid", "0.05", "10", "--hop_seconds", "0.1"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == rows and [r["right_context_seconds"] for r in rows] == [0.05, 10.0]
    from privacy_preserve_federated_asr_tpu_torch.data.dataset import csv_to_examples

    exs = csv_to_examples("clips", "test.csv", {"S001": 1}, cache_dir=str(tmp_path / "cache"))
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=0)
    ref = InferenceEngine(cfg, cli.load_weights(cfg, None, 0), TOK, ServingConfig(
        batch_size=2, max_seconds=0.2, compute_dtype="float32"), device="cpu")
    assert rows == measure_finalization_flips(ref, [e.array for e in exs],
                                              right_context_grid=(0.05, 10.0),
                                              hop_seconds=0.1)
