"""The port's tools around the chain on the CPU, against the JAX package's:
the native audio and beam-search shims (utils/native.py,
data/native_audio.py, ops/beam.py) and the corpus loader on top of them,
``model.safetensors`` in ``cli.load_weights``, models/export.py and
``cli export-hf``, ``cli transcribe`` greedy and with beam search and a
shallow-fusion LM, utils/profiling.py, utils/experiments.py and
``cli sweep asr``. Heavy JAX-package modules are imported inside the tests
that use them."""

import contextlib
import io
import json
import struct

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.data import AsrExample, CTCCharTokenizer
from privacy_preserve_federated_asr_tpu_torch.data import native_audio
from privacy_preserve_federated_asr_tpu_torch.data.dataset import csv_to_examples
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    DACSModel,
    init_dacs_state_dict,
    state_dict_from_flax,
    state_dict_from_hf,
)
from privacy_preserve_federated_asr_tpu_torch.models.export import export_for_ctc_state_dict
from privacy_preserve_federated_asr_tpu_torch.models.port import read_safetensors
from privacy_preserve_federated_asr_tpu_torch.ops import beam
from privacy_preserve_federated_asr_tpu_torch.utils import StepProfiler, trace_profile
from privacy_preserve_federated_asr_tpu_torch.utils import experiments
from test_torch_backbone import TINY, one_torch_thread, random_flax_params  # noqa: F401

TOK = CTCCharTokenizer()
TEXTS = ["THE BOY IS ON A STOOL", "WATER IS OVERFLOWING", "THE JAR", "MOTHER BY THE SINK"]


def _out(main, args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(args)
    return buf.getvalue()


@pytest.fixture
def native_libs(monkeypatch):
    """Both packages' native shims with the libraries loadable. A negative
    verdict cached while another test worker was still running ``make`` on
    the same file (the JAX test modules probe the libraries at collection)
    is dropped, so this process probes the finished file."""
    from privacy_preserve_federated_asr_tpu.utils import native as jax_boot
    from privacy_preserve_federated_asr_tpu_torch.utils import native as port_boot

    for boot in (jax_boot, port_boot):
        for so in ("libdacsaudio.so", "libdacsbeam.so"):
            if so in boot._CACHE and boot._CACHE[so] is None:
                monkeypatch.delitem(boot._CACHE, so)


# ---------------------------------------------------------------------------
# the native audio shim and the corpus loader
# ---------------------------------------------------------------------------

def _wav24(path, sr, x):
    """A 24-bit PCM WAV (scipy writes no 24-bit files)."""
    s = np.clip(np.round(x * (2 ** 23 - 1)), -2 ** 23, 2 ** 23 - 1).astype("<i4")
    data = s.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sr, sr * 3, 3, 24)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack(
        "<I", len(data)) + data
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


FORMATS = {
    "pcm8": (16000, lambda x: (x * 127 + 128).astype(np.uint8)),
    "pcm16": (16000, lambda x: (x * 32767).astype(np.int16)),
    "pcm24": (16000, None),
    "pcm32": (16000, lambda x: (x * (2 ** 31 - 1)).astype(np.int32)),
    "float32": (16000, lambda x: x.astype(np.float32)),
    "stereo": (16000, lambda x: (np.stack([x, x[::-1]], 1) * 32767).astype(np.int16)),
    "8k_to_16k": (8000, lambda x: (x * 32767).astype(np.int16)),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_native_audio_matches_jax(fmt, tmp_path, native_libs):
    """``load_audio_native`` and ``load_many_native`` bit-equal to the JAX
    binding's on each WAV layout the library parses."""
    from privacy_preserve_federated_asr_tpu.data import native_audio as jax_native

    assert native_audio.available() and jax_native.available()
    sr, enc = FORMATS[fmt]
    rng = np.random.default_rng(len(fmt))
    paths = []
    for i, n in enumerate((sr // 2, sr // 3)):
        x = np.clip(rng.normal(0, 0.2, n), -1, 1)
        p = tmp_path / f"{fmt}_{i}.wav"
        _wav24(p, sr, x) if enc is None else wavfile.write(p, sr, enc(x))
        paths.append(str(p))
    for p in paths:
        np.testing.assert_array_equal(native_audio.load_audio_native(p),
                                      jax_native.load_audio_native(p))
    for a, b in zip(native_audio.load_many_native(paths, n_threads=2),
                    jax_native.load_many_native(paths, n_threads=2)):
        assert a is not None
        np.testing.assert_array_equal(a, b)


def _corpus(root, names):
    (root / "clips").mkdir(parents=True)
    rng = np.random.default_rng(1)
    for name in names:
        wav = (rng.normal(0, 0.1, 4000) * 32767).astype(np.int16)
        wavfile.write(root / "clips" / name, 16000, wav)
    (root / "train.csv").write_text("path,sentence\n" + "".join(
        f"{n},{TEXTS[i % 4].lower()}\n" for i, n in enumerate(names)))
    return {f"S{i:03d}": i % 2 for i in range(4)}


def test_truncated_wav_skipped_as_jax(tmp_path, capsys, native_libs):
    """A WAV cut to 30 bytes is reported (``Err file = ...``) and skipped,
    and the rest of the corpus loads as the JAX package's native path loads
    it; the port used to abort the corpus build with ``struct.error``."""
    from privacy_preserve_federated_asr_tpu.data.dataset import (
        csv_to_examples as jax_csv_to_examples)

    names = [f"S{i:03d}_PAR_{i}.wav" for i in range(4)]
    spk2label = _corpus(tmp_path, names)
    assert native_audio.available()  # the reference's native path, as JAX runs it
    bad = tmp_path / "clips" / names[1]
    bad.write_bytes(bad.read_bytes()[:30])
    args = (str(tmp_path / "clips"), str(tmp_path / "train.csv"), spk2label)
    got = csv_to_examples(*args)
    ours = capsys.readouterr().out
    want = jax_csv_to_examples(*args)
    theirs = capsys.readouterr().out
    assert [e.path for e in got] == [e.path for e in want] == [names[i] for i in (0, 2, 3)]
    for a, b in zip(got, want):
        assert (a.text, a.dementia_label) == (b.text, b.dementia_label)
        np.testing.assert_array_equal(a.array, b.array)
    err = [line for line in ours.splitlines() if line.startswith("Err file")]
    assert len(err) == 1 and str(bad) in err[0]
    assert err == [line for line in theirs.splitlines() if line.startswith("Err file")]


def test_directory_path_skipped(tmp_path, capsys, native_libs):
    """A corpus path that is a directory is reported and skipped before the
    native library sees it (the library aborts the process on one)."""
    names = ["S000_PAR_0.wav", "S001_PAR_1.wav"]
    spk2label = _corpus(tmp_path, names)
    (tmp_path / "clips" / "S002_PAR_2.wav").mkdir()
    with open(tmp_path / "train.csv", "a") as f:
        f.write("S002_PAR_2.wav,the jar\n")
    assert native_audio.load_many_native([str(tmp_path / "clips" / "S002_PAR_2.wav")]) == [None]
    with pytest.raises(RuntimeError, match="not a regular file"):
        native_audio.load_audio_native(str(tmp_path / "clips"))
    exs = csv_to_examples(str(tmp_path / "clips"), str(tmp_path / "train.csv"), spk2label)
    assert [e.path for e in exs] == names
    err = [line for line in capsys.readouterr().out.splitlines() if line.startswith("Err file")]
    assert len(err) == 1 and "S002_PAR_2.wav" in err[0]


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_lm", [False, True], ids=["no_lm", "bigram_lm"])
def test_beam_matches_jax(with_lm, native_libs):
    """The Python decoder, the native one and ``beam_search_batch`` against
    the JAX package's on seeded log-posteriors: ids equal, scores 1e-6."""
    from privacy_preserve_federated_asr_tpu.ops import beam as jbeam

    assert beam.native_available() and jbeam.native_available()
    rng = np.random.default_rng(3)
    seqs = [TOK.encode(t) for t in TEXTS]
    lm = beam.CharBigramLM(32, smoothing=0.5).fit(seqs) if with_lm else None
    jlm = jbeam.CharBigramLM(32, smoothing=0.5).fit(seqs) if with_lm else None
    if with_lm:
        np.testing.assert_array_equal(lm._log_probs, jlm._log_probs)
    lp = rng.normal(0, 2.0, (3, 40, 32))
    lp = (lp - np.log(np.exp(lp).sum(-1, keepdims=True))).astype(np.float32)
    lengths = [40, 23, 9]
    kw = dict(beam_size=8, lm_alpha=0.5, lm_beta=0.1)
    for b, n in enumerate(lengths):
        got = beam.ctc_prefix_beam_search(lp[b, :n], lm_fn=lm, **kw)
        want = jbeam.ctc_prefix_beam_search(lp[b, :n], lm_fn=jlm, **kw)
        assert [h.ids for h in got] == [h.ids for h in want]
        np.testing.assert_allclose([h.score for h in got], [h.score for h in want],
                                   rtol=1e-6, atol=1e-6)
        nat = beam.ctc_prefix_beam_search_native(lp[b, :n], lm=lm, **kw)
        jnat = jbeam.ctc_prefix_beam_search_native(lp[b, :n], lm=jlm, **kw)
        assert nat.ids == jnat.ids == got[0].ids
        np.testing.assert_allclose(nat.log_prob, jnat.log_prob, rtol=1e-6, atol=1e-6)
    for backend in ("python", "native", "auto"):
        got = beam.beam_search_batch(lp, lengths, lm_fn=lm, backend=backend, **kw)
        want = jbeam.beam_search_batch(lp, lengths, lm_fn=jlm, backend=backend, **kw)
        assert [[h.ids for h in bs] for bs in got] == [[h.ids for h in bs] for bs in want]
        np.testing.assert_allclose([bs[0].score for bs in got], [bs[0].score for bs in want],
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# model.safetensors, export-hf and transcribe
# ---------------------------------------------------------------------------

def _hf_state_dict(stage=1, seed=3):
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=stage)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(seed))
    return cfg, {k: torch.from_numpy(v) for k, v in export_for_ctc_state_dict(
        sd, cfg.backbone).items()}


@pytest.fixture
def jax_init_by_shapes(monkeypatch):
    """JAX ``init_dacs_params`` from shapes (``eval_shape``) instead of an
    eager flax init: every value it gives is replaced by the checkpoint that
    the JAX ``load_params`` then reads (the tests hold the result to the
    port's, which takes every value from that file)."""
    from privacy_preserve_federated_asr_tpu.models import DACSModel as JaxDACSModel
    from privacy_preserve_federated_asr_tpu.train import train_state

    monkeypatch.setattr(train_state, "init_dacs_params", lambda cfg, rng, n=3200: (
        random_flax_params(JaxDACSModel(cfg), (np.zeros((1, n), np.float32),), seed=0,
                           rng_names=("params", "gumbel", "dropout"))))


def test_load_weights_reads_model_safetensors(tmp_path, jax_init_by_shapes):
    """An HF directory holding ``model.safetensors`` (and no
    ``pytorch_model.bin``) loads bit-equal to the same state dict as
    ``pytorch_model.bin``, and to JAX ``load_params`` on that directory
    carried across; the reader matches the safetensors package on F32, F16,
    BF16, I64 and I32."""
    from safetensors.torch import load_file, save_file

    from privacy_preserve_federated_asr_tpu.cli import load_params
    from privacy_preserve_federated_asr_tpu.models import (
        BackboneConfig as JaxBackboneConfig, DACSConfig as JaxDACSConfig)

    cfg, hf = _hf_state_dict()
    (tmp_path / "bin").mkdir()
    (tmp_path / "st").mkdir()
    torch.save(hf, tmp_path / "bin/pytorch_model.bin")
    save_file(hf, str(tmp_path / "st/model.safetensors"))
    from_bin = cli.load_weights(cfg, str(tmp_path / "bin"), seed=7)
    from_st = cli.load_weights(cfg, str(tmp_path / "st"), seed=7)
    assert from_bin.keys() == from_st.keys()
    for k, v in from_bin.items():
        assert torch.equal(v, from_st[k]), k
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(), stage=1)
    jax_sd = state_dict_from_flax(load_params(jcfg, str(tmp_path / "st"), 7), cfg)
    for k, v in from_st.items():
        assert torch.equal(v, jax_sd[k]), k

    g = torch.Generator().manual_seed(0)
    mixed = {"f32": torch.randn(3, 4, generator=g), "f16": torch.randn(5, generator=g).half(),
             "bf16": torch.randn(2, 3, generator=g).bfloat16(),
             "i64": torch.arange(-3, 4, dtype=torch.int64),
             "i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
             "empty": torch.zeros(0, 2)}
    save_file(mixed, str(tmp_path / "mixed.safetensors"), metadata={"format": "pt"})
    got, want = read_safetensors(str(tmp_path / "mixed.safetensors")), load_file(
        str(tmp_path / "mixed.safetensors"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("style", ["parametrizations", "legacy"])
def test_export_matches_jax_and_reloads(style, tmp_path):
    """``export_for_ctc_state_dict`` bit-equal to the JAX package's under the
    same weights, for the stacked (data2vec) and the weight-normed single
    (wav2vec2) positional conv; the file loads through JAX
    ``port_hf_state_dict`` to the JAX params and back into the port's
    DACSModel with ``strict=True``."""
    from privacy_preserve_federated_asr_tpu.models import (
        BackboneConfig as JaxBackboneConfig, DACSConfig as JaxDACSConfig,
        DACSModel as JaxDACSModel)
    from privacy_preserve_federated_asr_tpu.models.export import (
        export_for_ctc_state_dict as jax_export)
    from privacy_preserve_federated_asr_tpu.models.port import port_hf_state_dict

    for kw in ({}, dict(model_type="wav2vec2", pos_conv_type="single",
                        num_conv_pos_embeddings=16)):
        jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**TINY, **kw))
        cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(**kw))
        params = random_flax_params(JaxDACSModel(jcfg), (np.zeros((1, 3200), np.float32),),
                                    seed=11, rng_names=("params", "gumbel", "dropout"))
        sd = state_dict_from_flax(params, cfg)
        got = export_for_ctc_state_dict(sd, cfg.backbone, weight_norm_style=style)
        want = jax_export(params, jcfg.backbone, weight_norm_style=style)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        torch.save({k: torch.from_numpy(v.copy()) for k, v in got.items()},
                   tmp_path / "pytorch_model.bin")
        loaded = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
        back = port_hf_state_dict(loaded, jcfg.backbone)
        flat = state_dict_from_flax({**params, "backbone": back}, cfg)
        model = DACSModel(cfg)
        model.load_state_dict(state_dict_from_hf(loaded, cfg), strict=True)
        for k, v in model.state_dict().items():
            # weight norm recomputes W = g v / |v|: equal within rounding
            tol = dict(rtol=1e-6, atol=1e-7) if "pos_conv" in k and kw else dict(rtol=0, atol=0)
            torch.testing.assert_close(v, sd[k], **tol, msg=k)
            torch.testing.assert_close(flat[k], sd[k], **tol, msg=k)


def _wavs(root, n=3):
    root.mkdir()
    rng = np.random.default_rng(5)
    for i in range(n):
        wav = (rng.normal(0, 0.1, 3200 + 1600 * i) * 32767).astype(np.int16)
        wavfile.write(root / f"S{i:03d}_PAR_{i}.wav", 16000, wav)


def test_cli_transcribe_matches_jax(tmp_path, monkeypatch, jax_init_by_shapes, native_libs):
    """``cli export-hf`` of a seeded stage-1 model, then ``cli transcribe``
    of a directory of WAVs from that file: greedy against the JAX ``cli
    transcribe`` (rows equal, ``ad_prob`` 1e-4), and with ``--beam_size 4``
    and a bigram LM fitted on a transcripts CSV against the JAX
    InferenceEngine in beam mode with the LM the JAX CLI fits (transcripts
    equal); ``--out`` writes the rows as CSV."""
    import csv
    from types import SimpleNamespace

    from privacy_preserve_federated_asr_tpu import cli as jax_cli
    from privacy_preserve_federated_asr_tpu.data.audio import load_audio as jax_load_audio
    from privacy_preserve_federated_asr_tpu.data.tokenizer import CTCCharTokenizer as JaxTok
    from privacy_preserve_federated_asr_tpu.models import (
        BackboneConfig as JaxBackboneConfig, DACSConfig as JaxDACSConfig)
    from privacy_preserve_federated_asr_tpu.serving import (
        InferenceEngine as JaxEngine, ServingConfig as JaxServingConfig)

    monkeypatch.chdir(tmp_path)
    _wavs(tmp_path / "wavs")
    (tmp_path / "lm.csv").write_text("path,sentence\n" + "".join(
        f"x{i}.wav,{t.lower()}\n" for i, t in enumerate(TEXTS)))
    model = ["--model_type", "tiny", "-st", "1", "--seed", "3"]
    out = json.loads(_out(cli.main, ["export-hf", *model, "--device", "cpu",
                                     "--out", "exp/pytorch_model.bin"]).splitlines()[-1])
    assert out["keys"] == len(torch.load("exp/pytorch_model.bin", weights_only=True))
    args = ["transcribe", *model, "-model_in", "exp", "--audio", "wavs",
            "--compute_dtype", "float32", "--eval_batch_size", "4", "--max_seconds", "0.5"]
    rows = cli.main(args + ["--device", "cpu", "--out", "port.csv"])
    jax_rows = [json.loads(line) for line in _out(jax_cli.main, args).splitlines()
                if line.startswith("{")]
    assert [r["path"] for r in rows] == [r["path"] for r in jax_rows] == [
        f"wavs/S{i:03d}_PAR_{i}.wav" for i in range(3)]
    for a, b in zip(rows, jax_rows):
        assert (a["transcript"], a["ad_pred"]) == (b["transcript"], b["ad_pred"])
        np.testing.assert_allclose(a["ad_prob"], b["ad_prob"], rtol=0, atol=1e-4)
    with open("port.csv", newline="") as f:
        assert [r["transcript"] for r in csv.DictReader(f)] == [r["transcript"] for r in rows]

    beam_rows = cli.main(args + ["--device", "cpu", "--beam_size", "4",
                                 "--lm_train_csv", "lm.csv", "--lm_alpha", "0.5"])
    pa = SimpleNamespace(beam_size=4, lm_train_csv="lm.csv")  # JAX transcribe takes no LM
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(), stage=1)
    jtok = JaxTok()
    jeng = JaxEngine(jcfg, jax_cli.load_params(jcfg, "exp", 3), jtok,
                     JaxServingConfig(batch_size=4, max_seconds=0.5, compute_dtype="float32",
                                      beam_size=4, lm_alpha=0.5),
                     lm_fn=jax_cli._fit_shallow_fusion_lm(pa, jtok, jcfg))
    want = jeng.infer_batch([jax_load_audio(r["path"]) for r in rows])
    assert [r["transcript"] for r in beam_rows] == [w.transcript for w in want]
    assert [r["ad_pred"] for r in beam_rows] == [w.ad_pred for w in want]


# ---------------------------------------------------------------------------
# utils/profiling.py, utils/experiments.py, cli sweep asr
# ---------------------------------------------------------------------------

def test_step_profiler_and_trace_profile(tmp_path):
    """``StepProfiler.summary`` equals the JAX one on injected step times;
    ``trace_profile`` writes a Chrome trace of the body on the CPU."""
    from privacy_preserve_federated_asr_tpu.utils.profiling import StepProfiler as JaxProfiler

    ours, theirs = StepProfiler(), JaxProfiler()
    assert ours.summary() == theirs.summary() == {}
    with ours:
        pass
    ours.times = theirs.times = [0.012, 0.010, 0.031, 0.011, 0.0105]
    assert ours.summary() == theirs.summary()
    with trace_profile(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof/trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_exp_details_matches_jax(capsys):
    from privacy_preserve_federated_asr_tpu.models import (
        BackboneConfig as JaxBackboneConfig, DACSConfig as JaxDACSConfig)
    from privacy_preserve_federated_asr_tpu.utils.experiments import (
        exp_details as jax_exp_details)

    kw = dict(stage=2, ad_loss="recall", gs_tau=0.5, lambda_grl=0.3, w_loss=(0.2, 0.8))
    extra = {"lr": 1e-4, "num_users": 2}
    ours = experiments.exp_details(DACSConfig(backbone=BackboneConfig.tiny_for_tests(), **kw),
                                   extra)
    theirs = jax_exp_details(JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(), **kw),
                             extra)
    assert ours == theirs
    assert capsys.readouterr().out == ours + "\n" + theirs + "\n"


class _StubTrainer:
    """Records each combo's configs; its evaluation is a function of them."""

    runs: list = []

    def __init__(self, cfg, params, train, evl, tok, tcfg, **kw):
        self.cfg, self.tcfg = cfg, tcfg
        _StubTrainer.runs.append((cfg.gs_tau, tcfg.learning_rate, tcfg.batch_size, len(train)))

    def train(self):
        return self

    def evaluate(self):
        return {"eval_wer": round(abs(self.cfg.gs_tau - 0.7) + self.tcfg.learning_rate
                                  * 100 + self.tcfg.batch_size / 100, 6),
                "eval_loss": self.cfg.gs_tau}


def test_grid_search_and_sweep_helpers_match_jax(monkeypatch, tmp_path):
    """``grid_search`` with a stub Trainer patched into each package: the
    same combos, overrides routed to DACSConfig or TrainerConfig, the same
    rows and best row, ``ValueError`` on an unknown field; ``train_50_50``
    on the ADReSS halves; ``parse_grid``, ``_combos``, the presets and
    ``append_results_csv`` as the JAX sweep module's."""
    from privacy_preserve_federated_asr_tpu import sweep as jax_sweep
    from privacy_preserve_federated_asr_tpu.models import (
        BackboneConfig as JaxBackboneConfig, DACSConfig as JaxDACSConfig)
    from privacy_preserve_federated_asr_tpu.train.trainer import TrainerConfig as JaxTcfg
    from privacy_preserve_federated_asr_tpu.utils import experiments as jax_experiments
    from privacy_preserve_federated_asr_tpu_torch import sweep
    from privacy_preserve_federated_asr_tpu_torch.data.splits import CLIENT_SPLITS_ADRESS
    from privacy_preserve_federated_asr_tpu_torch.train.trainer import TrainerConfig

    grid = sweep.parse_grid(["gs_tau=0.5,1.0", "learning_rate=1e-5,1e-4", "batch_size=8"])
    assert grid == jax_sweep.parse_grid(["gs_tau=0.5,1.0", "learning_rate=1e-5,1e-4",
                                         "batch_size=8"])
    assert grid == {"gs_tau": [0.5, 1.0], "learning_rate": [1e-5, 1e-4], "batch_size": [8]}
    assert sweep._combos(grid) == jax_sweep._combos(grid)
    for name in ("ASR_PRESETS", "SVM_PRESETS", "TEXT_PRESETS"):
        ours, theirs = getattr(sweep, name), getattr(jax_sweep, name)
        assert {k: f() for k, f in ours.items()} == {k: f() for k, f in theirs.items()}
    with pytest.raises(ValueError, match="not key=v1"):
        sweep.parse_grid(["gs_tau"])

    monkeypatch.setattr(experiments, "Trainer", _StubTrainer)
    monkeypatch.setattr(jax_experiments, "Trainer", _StubTrainer)
    exs = [AsrExample(path=f"{s}_PAR_0.wav", array=np.zeros(1), text="A", dementia_label=0)
           for s in ("S086", "S058", "S021", "S030", "S999")]
    results = []
    for mod, cfg, tcfg, state in (
            (experiments, DACSConfig(backbone=BackboneConfig.tiny_for_tests()),
             TrainerConfig(), {"w": torch.zeros(2)}),
            (jax_experiments, JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests()),
             JaxTcfg(), {"w": np.zeros(2)})):
        _StubTrainer.runs = []
        best, rows = mod.grid_search(cfg, tcfg, grid, state, exs, exs, TOK)
        results.append((best, rows, list(_StubTrainer.runs)))
        with pytest.raises(ValueError, match="unknown grid fields"):
            mod.grid_search(cfg, tcfg, {"no_such_field": [1]}, state, exs, exs, TOK)
    assert results[0] == results[1]
    assert [r[:3] for r in results[0][2]] == [(g, lr, 8) for g in (0.5, 1.0)
                                             for lr in (1e-5, 1e-4)]
    assert results[0][0] == {"gs_tau": 0.5, "learning_rate": 1e-5, "batch_size": 8,
                             "eval_wer": 0.281, "eval_loss": 0.5}

    _StubTrainer.runs = []
    monkeypatch.setattr(_StubTrainer, "train", lambda self: type(
        "S", (), {"model": torch.nn.Linear(1, 1)})(), raising=False)
    experiments.train_50_50(DACSConfig(backbone=BackboneConfig.tiny_for_tests()),
                            TrainerConfig(), {"w": torch.zeros(2)}, exs, exs, TOK)
    halves = [sum(e.path[:4] in CLIENT_SPLITS_ADRESS[h] for e in exs)
              for h in ("public", "public2")]
    assert [r[3] for r in _StubTrainer.runs] == halves == [2, 2]

    row = {"gs_tau": 0.5, "grid": [1, 2], "eval_wer": 0.25}
    for mod, name in ((sweep, "port.csv"), (jax_sweep, "jax.csv")):
        mod.append_results_csv(str(tmp_path / "r" / name), row)
        mod.append_results_csv(str(tmp_path / "r" / name), {**row, "eval_wer": 0.5})
    assert (tmp_path / "r/port.csv").read_bytes() == (tmp_path / "r/jax.csv").read_bytes()


def test_cli_sweep_asr_on_cpu(tmp_path, monkeypatch):
    """``cli sweep asr`` on the CPU: two real stage-1 combos of the tiny
    model, each from its own copy of the same initial weights (the first
    combo's training leaves them unchanged for the second), two rows in the
    results CSV."""
    import csv

    from privacy_preserve_federated_asr_tpu_torch.train import trainer as trainer_mod

    monkeypatch.chdir(tmp_path)
    names = [f"S{i:03d}_PAR_{i}.wav" for i in range(3)]
    np.save("spk2label.npy", _corpus(tmp_path / "data", names))
    starts = []
    real_init = trainer_mod.Trainer.__init__

    def init(self, cfg, state_dict, *a, **kw):
        starts.append({k: v.clone() for k, v in state_dict.items()})
        real_init(self, cfg, state_dict, *a, **kw)

    monkeypatch.setattr(experiments.Trainer, "__init__", init)
    rows = cli.main(["sweep", "asr", "--model_type", "tiny", "-st", "1", "--device", "cpu",
                     "--audio_dir", "data/clips", "--train_csv", "data/train.csv",
                     "--test_csv", "data/train.csv", "--spk2label", "spk2label.npy",
                     "--dataset_cache", "cache", "--compute_dtype", "float32",
                     "--train_batch_size", "2", "--eval_batch_size", "2", "--epochs", "1",
                     "--grid", "learning_rate=1e-3,1e-2", "--results_csv", "res.csv"])
    assert [r["learning_rate"] for r in rows] == [1e-3, 1e-2]
    assert all(np.isfinite(r["eval_loss"]) for r in rows)
    assert len(starts) == 2 and all(torch.equal(v, starts[1][k]) for k, v in starts[0].items())
    with open("res.csv", newline="") as f:
        assert [float(r["learning_rate"]) for r in csv.DictReader(f)] == [1e-3, 1e-2]
