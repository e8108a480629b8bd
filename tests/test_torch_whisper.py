"""The port's Whisper teacher (privacy_preserve_federated_asr_tpu_torch/
models/whisper.py, data/teacher.py, data/whisper_tokens.py and ``cli teacher
--whisper_hf``) against the JAX package's on the CPU, on a tiny config
with whisper's token layout (HF_CFG), one seeded set of HF-named weights
loaded by both (the JAX package's ``port_hf_whisper`` and the port's;
``state_dict_from_flax_whisper`` carries the flax tree back unchanged):
log-mel and the filterbank, the encoder,
the decoder logits with and without the KV cache and a conditioning prompt,
``decode_with_stats`` at temperature 0 (ids equal, avg_logprob within
1e-5), ``timestamp_seek``, the fallback loops through one fake ``decode``,
``WhisperTeacher`` on long-form clips, the detokenizer against
``transformers.WhisperTokenizer`` and the CLI against the JAX CLI."""

import contextlib
import csv
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from privacy_preserve_federated_asr_tpu.models import whisper as J
from privacy_preserve_federated_asr_tpu_torch.data import AsrExample
from privacy_preserve_federated_asr_tpu_torch.data import teacher as pt
from privacy_preserve_federated_asr_tpu_torch.data.whisper_tokens import (
    WhisperDetokenizer, bytes_to_unicode)
from privacy_preserve_federated_asr_tpu_torch.models import whisper as P
from test_torch_backbone import one_torch_thread  # noqa: F401

EOT = 100   # the test vocab: 100 byte-level tokens, then whisper's layout
# a tiny HF WhisperConfig with whisper's token layout from EOT on (the CLI
# test writes it as config.json): ids 207-239 are timestamps
HF_CFG = dict(vocab_size=240, num_mel_bins=8, d_model=32, encoder_layers=2, decoder_layers=2,
              encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
              decoder_ffn_dim=64, max_source_positions=64, max_target_positions=24,
              eos_token_id=EOT, decoder_start_token_id=EOT + 1)
CFG = J.WhisperConfigT.from_hf_config(HF_CFG)
PCFG = P.WhisperConfigT.from_hf_config(HF_CFG)
ATOL = 1e-5   # fp32 log-mel and avg_logprob
REL = 1e-4    # fp32 states and logits under unit-variance weights: x their largest magnitude


def _mel(seed: int, b: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (b, 2 * CFG.max_source_positions, CFG.num_mel_bins)).astype(
        np.float32)


def _weights(cfg: P.WhisperConfigT, seed: int = 0) -> dict[str, torch.Tensor]:
    """The port's seeded HF-named init with the matrices at std 1 (at the
    init's 0.02 the random decoder repeats one token): the weights both
    packages load."""
    sd = P.init_whisper_state_dict(cfg, torch.Generator().manual_seed(seed))
    return {k: v * 50.0 if v.ndim == 2 and "embed" not in k else v for k, v in sd.items()}


@pytest.fixture(scope="module")
def pair():
    """The JAX package's params (its ``port_hf_whisper`` of the weights)
    and the port's module under the same weights."""
    sd = _weights(PCFG)
    params = J.port_hf_whisper({k: v.numpy() for k, v in sd.items()}, CFG)
    back = P.state_dict_from_flax_whisper(params)   # and the bridge back
    assert back.keys() == sd.keys() and all(torch.equal(back[k], v) for k, v in sd.items())
    return J.WhisperModel(CFG), params, P.port_hf_whisper(sd, PCFG, device="cpu")


@pytest.fixture(scope="module")
def teachers(pair):
    """A JAX and a port ``WhisperTeacher`` per timestamps setting, greedy
    only (temperature > 0 samples from each package's own generator), with
    a detokenizer that spells the ids: the decode tests and the long-form
    tests share the JAX teachers' compiled programs."""
    from privacy_preserve_federated_asr_tpu.data.teacher import WhisperTeacher as JaxTeacher

    _, params, m = pair
    detok = lambda ids: "-".join(map(str, ids))  # noqa: E731
    return {ts: (JaxTeacher(CFG, params, detok, temperatures=(0.0,), timestamps=ts),
                 pt.WhisperTeacher(PCFG, m, detok, temperatures=(0.0,), timestamps=ts,
                                   device="cpu"))
            for ts in (False, True)}


def test_log_mel_and_filterbank():
    """The filterbank equal; log-mel at 80 and 8 bins within 1e-5."""
    np.testing.assert_array_equal(P.slaney_mel_filters(80), J.slaney_mel_filters(80))
    audio = J.pad_or_trim(np.random.default_rng(1).normal(0, 0.1, (1, 24000)).astype(
        np.float32))
    for n_mel in (80, 8):
        want = np.asarray(jax.jit(J.log_mel_spectrogram, static_argnums=1)(
            jnp.asarray(audio), n_mel))
        got = P.log_mel_spectrogram(torch.from_numpy(audio), n_mel).numpy()
        assert got.shape == want.shape == (1, 3000, n_mel)
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert P.chunk_samples(PCFG) == J.chunk_samples(CFG)


def test_encoder_and_decoder_logits(pair):
    """Encoder states and teacher-forced logits against JAX (within 1e-4 of
    their largest magnitude); then the decoder through the KV cache (a
    conditioning prompt left-padded per row: a prefill of 5 slots and two
    single steps) against the uncached forward of each row's own tokens."""
    model, params, m = pair
    mel = _mel(2)
    toks = np.random.default_rng(3).integers(0, CFG.vocab_size, (3, 7))
    enc, want = jax.jit(lambda p, x, t: (
        model.apply({"params": p}, x, method=J.WhisperModel.encode),
        model.apply({"params": p}, x, t)))(params, jnp.asarray(mel), jnp.asarray(toks))
    with torch.no_grad():
        got_enc = m.encode(torch.from_numpy(mel)).numpy()
        got = m(torch.from_numpy(mel), torch.from_numpy(toks)).numpy()
    for a, b in ((got_enc, enc), (got, want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=REL * np.abs(b).max())

    start = np.array([0, 2, 4])   # rows' first real cache slot
    dec = m.model.decoder
    kv = P.KVCache(PCFG, 3, torch.float32, "cpu")
    slots = torch.arange(7)
    st = torch.from_numpy(start)
    key_bias = torch.where(slots[None, :] >= st[:, None], 0.0, P.NEG_BIAS)[:, None, None, :]
    pos = (slots[None, :] - st[:, None]).clamp_min(0)
    with torch.no_grad():
        cross = dec.cross_kv(m.encode(torch.from_numpy(mel)))
        causal = torch.where(slots[:5, None] >= slots[None, :5], 0.0, P.NEG_BIAS)
        cached = [dec(torch.from_numpy(toks[:, :5]), pos[:, :5], cross,
                      lambda i, a: kv.writer(i, a, 0), causal + key_bias[..., :5])]
        for j in (5, 6):
            cached.append(dec(torch.from_numpy(toks[:, j:j + 1]), pos[:, j:j + 1], cross,
                              lambda i, a, j=j: kv.writer(i, a, j), key_bias[..., :j + 1]))
        cached = torch.cat(cached, dim=1).numpy()
        for r, s0 in enumerate(start):
            ref = m(torch.from_numpy(mel[r:r + 1]), torch.from_numpy(toks[r:r + 1, s0:]))
            np.testing.assert_allclose(cached[r, s0:], ref[0].numpy(),
                                       atol=REL * np.abs(ref.numpy()).max())


@pytest.mark.parametrize("timestamps", [False, True])
def test_decode_with_stats(pair, teachers, timestamps):
    """Greedy decodes of two windows (each teacher's ``_decode_windows``:
    log-mel, then ``decode_with_stats``), plain and with right-aligned
    conditioning prompts of 0 and 5 tokens: the ids equal, avg_logprob
    within 1e-5, the rows different. Port only: a budget cut by
    ``max_new_tokens`` is the full decode's head, EOT-padded, and a prompt
    leaving no budget raises."""
    _, _, m = pair
    jt, tt = teachers[timestamps]
    rng = np.random.default_rng(4)
    windows = rng.normal(0, 0.3, (2, P.chunk_samples(PCFG))).astype(np.float32)
    prompts, plens = tt._build_prompts([0, 1], [None, (list(rng.integers(0, EOT, 9)), 0.0)])
    assert list(plens) == [0, 10]
    for extra in ((), (prompts, plens)):
        _, want_lps, want = jt._decode_windows(windows, [0, 1], 0.0, 0, *extra)
        _, got_lps, got = tt._decode_windows(windows, [0, 1], 0.0, 0, *extra)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got_lps, want_lps, atol=ATOL)
        assert not np.array_equal(got[0], got[1])
    mel = P.log_mel_spectrogram(torch.from_numpy(windows), PCFG.num_mel_bins)
    full = P.decode_with_stats(PCFG, m, mel, timestamps=timestamps)[0]
    cut = P.decode_with_stats(PCFG, m, mel, timestamps=timestamps, max_new_tokens=5)[0]
    assert torch.equal(cut[:, :5], full[:, :5]) and bool((cut[:, 5:] == CFG.eot_token).all())
    with pytest.raises(ValueError, match="no token budget"):
        P.decode_with_stats(PCFG, m, mel, prompt_ids=torch.zeros((2, 21), dtype=torch.long),
                            prompt_lens=torch.zeros(2, dtype=torch.long))


def test_timestamp_seek_and_text_ids():
    tb, eot = CFG.timestamp_begin, CFG.eot_token
    rows = [[tb, 10, 11, eot], [tb, 10, 11, tb + 5, tb + 5, 12, tb + 9, eot, eot],
            [tb, tb, 13, eot], [tb, 7, CFG.prev_token, tb + 3, tb + 3, 2, tb + 4], [eot], []]
    for row in rows:
        assert P.timestamp_seek(PCFG, row) == J.timestamp_seek(CFG, row)
        assert P.timestamp_text_ids(PCFG, row) == J.timestamp_text_ids(CFG, row)
    for text in ("", "a b c", "the the the the the the the the the the the"):
        assert P.compression_ratio(text) == J.compression_ratio(text)


@pytest.mark.parametrize("full", [False, True])
def test_fallback_loops_share_a_fake_decode(full):
    """``fallback_transcribe(_full)`` of both packages given one fake
    decode: the same calls (windows, temperature, seed) and results."""
    from privacy_preserve_federated_asr_tpu.data import teacher as jt

    def fake(calls):
        def decode(idx, t, seed):
            calls.append((list(idx), t, seed))
            texts = ["ab" * 40 if (i + int(t * 10)) % 3 == 0 else f"w{i} t{t}" for i in idx]
            lps = [-2.0 if i == 1 and t < 0.5 else -0.5 for i in idx]
            ids = [np.full(4, i * 10 + int(t * 10)) for i in idx]
            return (texts, lps, ids) if full else (texts, lps)
        return decode

    fn = "fallback_transcribe_full" if full else "fallback_transcribe"
    out, calls = [], []
    for mod in (jt, pt):
        calls.append([])
        out.append(getattr(mod, fn)(fake(calls[-1]), 5, seed=3))
    assert calls[0] == calls[1] and len(calls[0]) > 2
    if full:
        assert out[0][0] == out[1][0] and out[0][2] == out[1][2]
        assert all(np.array_equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    else:
        assert out[0] == out[1]


@pytest.mark.parametrize("timestamps", [False, True])
def test_teacher_long_form(teachers, timestamps):
    """``WhisperTeacher.transcribe`` of two clips of 1.5 windows, greedy,
    conditioned on the previous text (the frontier loop, or the timestamp
    seek): the same transcripts as the JAX teacher, none empty."""
    chunk = J.chunk_samples(CFG)
    rng = np.random.default_rng(6)
    exs = [AsrExample(path=f"S00{i}_PAR_{i}.wav",
                      array=rng.normal(0, 0.3, int(chunk * 1.5)).astype(np.float32), text="",
                      dementia_label=0) for i in range(2)]
    jt, tt = teachers[timestamps]
    want = jt.transcribe(exs, batch_size=2)
    assert tt.transcribe(exs, batch_size=2) == want and all(want.values())


# ---------------------------------------------------------------------------
# the detokenizer and the CLI


def _write_tokenizer(d, n_ts: int = 33) -> None:
    """vocab.json (ids 0-99: single bytes, words, and the two bytes of 'é'
    and three of '€' as separate tokens; 100 <|endoftext|>),
    added_tokens.json (<|startoftranscript|> 101, languages 102-200, the
    task and prompt tokens 201-206, timestamps from 207), the specials in
    special_tokens_map.json, and the merges.txt header HF wants."""
    b2u = bytes_to_unicode()
    toks = [b2u[b] for b in b"abcdefghijklmnopqrstuvwxyz .,'"]
    toks += ["".join(b2u[b] for b in w.encode()) for w in (" the", " boy", "ing", " cookie")]
    toks += [b2u[b] for b in "é€".encode()]
    toks += [f"x{i}" for i in range(EOT - len(toks))]
    vocab = {t: i for i, t in enumerate(toks)}
    vocab["<|endoftext|>"] = EOT
    specials = (["<|startoftranscript|>"] + [f"<|l{i}|>" for i in range(99)]
                + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                   "<|nocaptions|>", "<|notimestamps|>"])
    added = {t: EOT + 1 + i for i, t in enumerate(specials)}
    added.update({f"<|{i * 0.02:.2f}|>": 207 + i for i in range(n_ts)})
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "added_tokens.json").write_text(json.dumps(added))
    (d / "merges.txt").write_text("#version: 0.2\n")
    (d / "special_tokens_map.json").write_text(json.dumps({
        "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
        "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
        "additional_special_tokens": ["<|endoftext|>"] + specials}))


def test_detokenizer_matches_hf(tmp_path):
    """``WhisperDetokenizer`` equals ``WhisperTokenizer.decode(ids,
    skip_special_tokens=True)`` byte for byte: multi-byte UTF-8 split across
    tokens (whole, and cut by a timestamp or at the end), specials skipped,
    a ``<|startofprev|>`` prompt stripped, timestamps removed."""
    transformers = pytest.importorskip("transformers")
    _write_tokenizer(tmp_path)
    hf = transformers.WhisperTokenizer.from_pretrained(str(tmp_path))
    ours = WhisperDetokenizer.from_pretrained(tmp_path)
    e1, e2, eu1, eu2, eu3 = 34, 35, 36, 37, 38   # the bytes of é and €
    cases = [[7, 4, 11, 11, 14], [30, 31, e1, e2, 26, eu1, eu2, eu3],
             [e1, 207, e2, 220, 32, 33], [101, 102, 202, 7, 8, EOT, 9],
             [204, 1, 2, 101, 202, 3, 4, 206], [204, 5, 6], [eu1, eu2], [30, 99, 239],
             [206, 207, 26, 0, 208, EOT, EOT], []]
    for ids in cases:
        assert ours(ids) == hf.decode(ids, skip_special_tokens=True), ids


def _json_out(main, args) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(args)
    return json.loads(out.getvalue())


def test_cli_teacher_whisper_matches_jax(tmp_path, monkeypatch):
    """``cli teacher --whisper_hf <dir>`` (HF_CFG as config.json, the
    weights above as pytorch_model.bin, the tokenizer files above) on 2
    WAVs of 0.5 and 1.5 windows, with the CLI's defaults (timestamps and the
    seek, the six-temperature fallback, which the random model never
    passes, conditioning): the JAX CLI (transformers' tokenizer) writes the
    same JSON and CSV. Temperatures above 0 sample in each package from its
    own generator, so the run holds the fallback at temperature 0."""
    pytest.importorskip("transformers")
    from privacy_preserve_federated_asr_tpu import cli as jax_cli
    from privacy_preserve_federated_asr_tpu.data import teacher as jt
    from privacy_preserve_federated_asr_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    d = tmp_path / "whisper"
    d.mkdir()
    _write_tokenizer(d)
    (d / "config.json").write_text(json.dumps(HF_CFG))
    torch.save(_weights(PCFG), d / "pytorch_model.bin")
    rng = np.random.default_rng(7)
    (tmp_path / "clips").mkdir()
    names = []
    for i, f in enumerate((0.5, 1.5)):
        names.append(f"S00{i}_PAR_{i}.wav")
        wav = (rng.normal(0, 0.2, int(P.chunk_samples(PCFG) * f)) * 32767).astype(np.int16)
        wavfile.write(tmp_path / "clips" / names[-1], 16000, wav)
    (tmp_path / "u.csv").write_text("path\n" + "\n".join(names) + "\n")
    np.save(tmp_path / "spk.npy", {f"S00{i}": i % 2 for i in range(2)})
    zero = (0.0,) * 6
    for mod in (jt, pt):   # the CLI's defaults, every temperature at 0
        monkeypatch.setattr(mod.WhisperTeacher.__init__, "__defaults__", tuple(
            zero if isinstance(v, tuple) else v for v in mod.WhisperTeacher.__init__.__defaults__))
    args = ["teacher", "--model_type", "tiny", "--audio_dir", "clips", "--train_csv", "u.csv",
            "--spk2label", "spk.npy", "--dataset_cache", "cache", "--eval_batch_size", "2",
            "--whisper_hf", str(d)]
    got = _json_out(cli.main, args + ["--out", "port/p.csv", "--device", "cpu"])
    want = _json_out(jax_cli.main, args + ["--out", "jax/p.csv"])
    assert got["transcribed"] == want["transcribed"] == 2 and got["kept"] == want["kept"]
    assert (tmp_path / "port/p.json").read_bytes() == (tmp_path / "jax/p.json").read_bytes()
    assert (tmp_path / "port/p.csv").read_bytes() == (tmp_path / "jax/p.csv").read_bytes()
    trs = json.loads((tmp_path / "port/p.json").read_text())
    kept = list(csv.DictReader(open(tmp_path / "port/p.csv")))
    assert [r["path"] for r in kept] == [p for p in sorted(trs) if trs[p].strip()]
