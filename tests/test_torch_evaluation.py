"""The port's evaluation chain (privacy_preserve_federated_asr_tpu_torch/
evaluation and the cli's extract, svm, detail-wer, feat-scoring, pkl2csv
and dp-budget) against the JAX package's on the CPU: extraction rows under
the same weights and injected Gumbel noise, the forced-toggle masks, the
analysis functions, the SVM against scikit-learn, the pickles and CSVs each
package writes read by the other, and the port's CLI chain with pandas and
scikit-learn blocked."""

import contextlib
import io
import json
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from privacy_preserve_federated_asr_tpu import cli as jax_cli
from privacy_preserve_federated_asr_tpu.data.collate import LengthBucketBatcher as JaxBatcher
from privacy_preserve_federated_asr_tpu.models import (
    BackboneConfig as JaxBackboneConfig,
    DACSConfig as JaxDACSConfig,
    DACSModel as JaxDACSModel,
)
from privacy_preserve_federated_asr_tpu.models.recipes import get_recipe as jax_recipe
from privacy_preserve_federated_asr_tpu.ops.decode import ad_vote as jax_ad_vote
from privacy_preserve_federated_asr_tpu.ops.decode import greedy_ids as jax_greedy_ids
from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch import evaluation as ev
from privacy_preserve_federated_asr_tpu_torch.data import AsrExample, CTCCharTokenizer
from privacy_preserve_federated_asr_tpu_torch.evaluation.forced_toggle import (
    forced_toggle_extract, reference_mask_off_n_groups)
from privacy_preserve_federated_asr_tpu_torch.evaluation.svm_ad import RbfSVC, standard_scale
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    feat_extract_output_lengths,
    init_dacs_state_dict,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.train.checkpoint import save_params
from test_torch_backbone import TINY, one_torch_thread, random_flax_params  # noqa: F401
from test_torch_tools import native_libs  # noqa: F401

TOK = CTCCharTokenizer()
SAMPLES, BS = 3200, 2   # one 3200-sample bucket, batches of 2 (the last one padded)
TEXTS = ["THE BOY IS ON A STOOL", 'SHE SAID "HI", THEN LEFT', "WATER IS OVERFLOWING",
         "THE JAR", "MOTHER IS STANDING BY THE SINK"]
COLUMNS = {"path", "text", "dementia_labels", "hidden_states", "pred_str", "pred_AD",
           "dementia_logits", "lm_mask", "dementia_mask"}


def _examples():
    """Five utterances of 2400-3200 samples: speakers S000-S002 (labels 0, 1,
    0), one INV row."""
    rng = np.random.default_rng(0)
    out = []
    for i, text in enumerate(TEXTS):
        arr = rng.normal(0, 1, SAMPLES - 400 * (i % 3)).astype(np.float32)
        out.append(AsrExample(
            path=f"S{i % 3:03d}_{'INV' if i == 4 else 'PAR'}_{i}.wav", array=arr, text=text,
            dementia_label=(i % 3) % 2, input_values=arr,
            labels=np.asarray(TOK.encode("HI"), np.int32)))
    return out


def _noise(shape):
    """The (lm, AD) Gumbel draws for a batch's [B, T, D, 2] mask scores: a
    function of the shape, as the JAX extraction's one key per batch."""
    rng = np.random.default_rng(list(shape))
    return tuple(rng.gumbel(size=shape).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def jev():
    """The JAX package's evaluation modules, imported at first use: they
    pull in its trainer and orbax (~6 s), which collection would otherwise
    pay in every test worker."""
    from privacy_preserve_federated_asr_tpu import evaluation

    return evaluation


@pytest.fixture(scope="module")
def jax_model():
    """The tiny JAX DACS config at stage 2 and its seeded numpy params."""
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**TINY), stage=2)
    return jcfg, random_flax_params(JaxDACSModel(jcfg), (np.zeros((1, SAMPLES), np.float32),),
                                    seed=5, rng_names=("params", "gumbel", "dropout"))


@pytest.fixture(scope="module")
def extracted(jax_model, jev):
    """method -> (port config, port state dict, JAX rows, port rows at fp32)
    of the five utterances under one set of weights at stage 2. The JAX
    model runs once per batch (jitted once); each method's rows take its
    recipe's streams of those outputs, as the JAX extraction does."""
    jcfg, params = jax_model
    exs = _examples()
    forward = jax.jit(lambda p, x, il, noise: JaxDACSModel(jcfg).apply(
        {"params": p}, x, il, deterministic=True, gumbel_noise=noise))
    batches = []
    for b in JaxBatcher(exs, BS, time_multiple=SAMPLES).epoch(epoch_seed=0):
        shape = (BS, feat_extract_output_lengths(BackboneConfig.tiny_for_tests(),
                                                 b.input_values.shape[1]),
                 jcfg.hidden_size, 2)
        batches.append((b.paths, forward(params, b.input_values, b.input_lengths,
                                         _noise(shape))))
    cache = {}

    def get(method: str):
        if method not in cache:
            cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=2, method=method)
            sd = state_dict_from_flax(params, cfg)
            got = ev.extract_embeddings(cfg, sd, exs, TOK, batch_size=BS,
                                        time_multiple=SAMPLES, device="cpu",
                                        gumbel_noise=_noise)
            cache[method] = cfg, sd, _jax_rows(jev, jcfg.replace(method=method), batches,
                                               exs), got
        return cache[method]

    get.batches = batches  # (paths, JAX model outputs) per batch
    return get


def _jax_rows(jev, jcfg, batches, exs):
    """The JAX extraction's rows (evaluation/extract.py: the recipe's
    streams, greedy ids, AD vote, un-padding) of the batches' outputs."""
    recipe = jax_recipe(jcfg.method)
    by_path = {e.path: e for e in exs}
    rows = []
    for paths, out in batches:
        ctc, dlog, lm, ad = recipe.extract_streams(out, jcfg)
        pred = jax_greedy_ids(ctc, out.frame_mask, jcfg.backbone.pad_token_id)
        h, lm, ad, dlog, pred, ad_pred, flen = jax.device_get(
            (out.hidden_states, lm, ad, dlog, pred, jax_ad_vote(dlog, out.frame_mask),
             out.frame_lengths))
        for i, path in enumerate(paths):
            t, ex = int(flen[i]), by_path[path]
            rows.append(jev.ExtractionRow(
                path=path, text=ex.text, dementia_labels=ex.dementia_label,
                hidden_states=np.asarray(h[i, :t], np.float32),
                lm_mask=None if lm is None else np.asarray(lm[i, :t], np.float32),
                dementia_mask=None if ad is None else np.asarray(ad[i, :t], np.float32),
                pred_str=TOK.decode(pred[i]), pred_AD=int(ad_pred[i]),
                dementia_logits=np.asarray(dlog[i, :t], np.float32)))
    return rows


@pytest.mark.parametrize("method", ["dacs", "grl"])
def test_extract_rows_match_jax(extracted, method):
    cfg, _, want, got = extracted(method)
    assert [r.path for r in got] == [r.path for r in want] and len(got) == len(TEXTS)
    for a, b in zip(got, want):
        assert (a.text, a.dementia_labels, a.pred_str, a.pred_AD) == (
            b.text, b.dementia_labels, b.pred_str, b.pred_AD), a.path
        for name in ("hidden_states", "dementia_logits", "lm_mask", "dementia_mask"):
            x, y = getattr(a, name), getattr(b, name)
            if y is None:  # grl rows carry no masks
                assert x is None and cfg.method == "grl", name
                continue
            assert x.dtype == np.float32 and x.shape == y.shape, name
            if name.endswith("mask"):
                np.testing.assert_array_equal(x, y, err_msg=name)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=name)
    if cfg.method == "dacs":
        masks = np.concatenate([r.lm_mask for r in got])
        assert set(np.unique(masks)) == {0.0, 1.0}
    assert len({r.hidden_states.shape[0] for r in got}) == 3  # un-padded by length


def test_extract_bf16_close_to_fp32(extracted):
    """bf16 extraction dumps fp32 rows that agree with the fp32 ones by the
    JAX package's rule (tests/test_evaluation.py)."""
    cfg, sd, _, r32 = extracted("dacs")
    r16 = ev.extract_embeddings(cfg, sd, _examples(), TOK, batch_size=BS,
                                time_multiple=SAMPLES, compute_dtype="bfloat16",
                                device="cpu", gumbel_noise=_noise)
    for a, b in zip(r32, r16):
        assert b.hidden_states.dtype == np.float32 and a.path == b.path
        np.testing.assert_allclose(a.hidden_states, b.hidden_states, atol=0.15, rtol=0.1)
        assert a.pred_AD == b.pred_AD


def test_forced_toggle_matches_jax(extracted, jax_model, jev):
    rng = np.random.default_rng(3)
    scores = rng.normal(size=(2, 6, 12)).astype(np.float32)
    mask = (rng.random((2, 6, 12)) > 0.5).astype(np.float32)
    got = ev.mask_off_n_groups(torch.from_numpy(scores), 4, 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jev.mask_off_n_groups(scores, 4, 2)))
    np.testing.assert_array_equal(got, reference_mask_off_n_groups(scores, 4, 2))
    for ratio in (0.0, 0.3, 0.5, 1.0):
        for aggressive in (True, False):
            np.testing.assert_array_equal(
                ev.aggressive_passive_masking(scores, mask, ratio, aggressive).numpy(),
                np.asarray(jev.aggressive_passive_masking(scores, mask, ratio, aggressive)))
    cfg, sd = extracted("dacs")[:2]
    d = cfg.hidden_size
    kw = dict(batch_size=BS, time_multiple=SAMPLES)
    half = dict(mode="off_groups", num_per_group=d // 4, num_off=2)
    for extra, rate in ((dict(mode="off_groups", num_per_group=d // 4, num_off=4), 0.0),
                        (half, 0.5), (dict(mode="passive", ratio=1.0), 1.0)):
        out, w = forced_toggle_extract(cfg, sd, _examples(), TOK, device="cpu", **kw, **extra)
        assert [r["forced_on_rate"] for r in out] == [rate] * len(TEXTS), extra
        assert w is not None and np.isfinite(w)
        if extra is half:
            got = out, w
    # off_groups re-decodes through the forced lm mask (mask_override) and
    # depends on the scores alone, not on the noise: the JAX rows and WER
    from privacy_preserve_federated_asr_tpu.evaluation.forced_toggle import (
        forced_toggle_extract as jax_forced_toggle_extract)

    assert got == jax_forced_toggle_extract(*jax_model, _examples(), TOK, **kw, **half)


def test_detail_wer_and_mask_stats_match_jax(extracted, jev, tmp_path):
    path = str(tmp_path / "x.pkl")
    ev.rows_to_pickle(extracted("dacs")[3], path)
    recs = ev.read_records(path)
    id2mmse = {"S000": 28, "S001": 15, "S002": 22}
    for level in (1, 2, 3):
        assert (ev.detailed_wer_report(recs, level, id2mmse)
                == jev.detailed_wer_report(recs, level, id2mmse)), level
    for fn in ("mask_node_statistics", "per_utt_on_rates"):
        got, want = getattr(ev, fn)(recs), getattr(jev, fn)(recs)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_speaker_vote_metrics_match_sklearn(jev):
    rng = np.random.default_rng(1)
    for case in range(24):
        n_spk = int(rng.integers(2, 12))
        spk2label = {f"S{s:03d}": int(v) for s, v in enumerate(rng.integers(0, 2, n_spk))}
        if case % 10 == 0:  # one class only, in truth or in the votes
            spk2label = {k: case % 20 // 10 for k in spk2label}
        paths, preds = [], []
        for s in spk2label:
            for u in range(int(rng.integers(1, 5))):
                paths.append(f"{s}_{'PAR' if u or case % 3 else 'INV'}_{u}.wav")
                preds.append(int(rng.integers(0, 2)) if case % 7 else 1)
        got = ev.speaker_vote_metrics(paths, preds, spk2label)
        want = jev.speaker_vote_metrics(paths, preds, spk2label)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(float(want[k]), abs=1e-12), (case, k)


def _svm_rows(x, labels, spk_of):
    return [{"path": f"S{spk_of[i]:03d}_PAR_{i}.wav", "dementia_labels": int(labels[i]),
             "hidden_states": x[i][None, None].repeat(3, axis=1)} for i in range(len(x))]


def test_svc_matches_sklearn(jev):
    """The port's SVC against ``sklearn.svm.SVC()``: decision values within
    1e-3 and equal labels where |f| > 1e-2 on overlapping classes; equal
    metrics through both ``predict_ad_svm`` on separable ones."""
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import SVC

    rng = np.random.default_rng(4)
    y = rng.integers(0, 2, 60)
    x = (rng.normal(size=(60, 32)) + 0.5 * y[:, None]).astype(np.float32)
    xt = (rng.normal(size=(40, 32)) + 0.25).astype(np.float32)
    sc = StandardScaler().fit(x)
    svc = SVC().fit(sc.transform(x), y)
    want = svc.decision_function(sc.transform(xt))
    a, b = standard_scale(torch.from_numpy(x).double(), torch.from_numpy(xt).double())
    ours = RbfSVC().fit(a, torch.from_numpy(y))
    got = ours.decision_function(b).numpy()
    assert np.abs(got - want).max() <= 1e-3
    clear = np.abs(want) > 1e-2
    assert clear.sum() > 30
    np.testing.assert_array_equal(ours.predict(b).numpy()[clear], svc.predict(sc.transform(xt))[clear])

    labels = np.repeat([0, 1], 12)
    xs = (rng.normal(size=(24, 16)) + 3.0 * labels[:, None]).astype(np.float32)
    spk = np.arange(24) // 3  # 8 speakers of 3 utterances
    spk2label = {f"S{s:03d}": int(labels[3 * s]) for s in range(8)}
    train, test = _svm_rows(xs[::2], labels[::2], spk[::2]), _svm_rows(xs[1::2], labels[1::2], spk[1::2])
    for pooling in ("mean", "min"):
        got = ev.predict_ad_svm(train, test, spk2label, pooling=pooling, device="cpu")
        assert got == pytest.approx(jev.predict_ad_svm(train, test, spk2label, pooling=pooling))
        assert got["ACC"] == 1.0


def test_extract_beam_pred_str_matches_jax(extracted, jax_model, native_libs):
    """``beam_size > 0`` with a bigram LM: ``pred_str`` as the JAX extraction
    decodes it (its ``beam_search_batch`` over the fp32 ``log_softmax`` of
    the recipe's CTC stream, ids decoded without grouping) under the same
    injected noise; every other field as in the greedy run."""
    from privacy_preserve_federated_asr_tpu.data.tokenizer import CTCCharTokenizer as JaxTok
    from privacy_preserve_federated_asr_tpu.ops import beam as jax_beam
    from privacy_preserve_federated_asr_tpu_torch.ops.beam import CharBigramLM

    cfg, sd, _, greedy = extracted("dacs")
    jcfg = jax_model[0]
    seqs = [TOK.encode(t) for t in TEXTS]
    got = ev.extract_embeddings(cfg, sd, _examples(), TOK, batch_size=BS,
                                time_multiple=SAMPLES, device="cpu", gumbel_noise=_noise,
                                beam_size=4, lm_fn=CharBigramLM(32).fit(seqs), lm_alpha=0.5)
    jlm, jtok, want = jax_beam.CharBigramLM(32).fit(seqs), JaxTok(), []
    for paths, out in extracted.batches:
        ctc = jax_recipe(jcfg.method).extract_streams(out, jcfg)[0]
        lp, flen = jax.device_get((jax.nn.log_softmax(ctc.astype(np.float32), axis=-1),
                                   out.frame_lengths))
        beams = jax_beam.beam_search_batch(lp[:len(paths)], flen[:len(paths)], beam_size=4,
                                           blank_id=0, lm_fn=jlm, lm_alpha=0.5)
        want += [jtok.decode(b[0].ids, group_tokens=False) for b in beams]
    assert [r.pred_str for r in got] == want
    assert any(a.pred_str != b.pred_str for a, b in zip(got, greedy))
    for a, b in zip(got, greedy):
        assert (a.path, a.pred_AD) == (b.path, b.pred_AD)
        np.testing.assert_array_equal(a.hidden_states, b.hidden_states)


def test_sweep_svm_matches_jax(jev, tmp_path):
    """``sweep_svm`` over the ``dementia-svm`` preset (four poolings) on
    separable rows: the JAX sweep's rows (scikit-learn's SVC) with the
    metrics equal as ``predict_ad_svm``'s, one results-CSV row per combo."""
    from privacy_preserve_federated_asr_tpu import sweep as jax_sweep
    from privacy_preserve_federated_asr_tpu_torch import sweep

    rng = np.random.default_rng(6)
    labels = np.repeat([0, 1], 12)
    xs = (rng.normal(size=(24, 16)) + 3.0 * labels[:, None]).astype(np.float32)
    spk = np.arange(24) // 3
    spk2label = {f"S{s:03d}": int(labels[3 * s]) for s in range(8)}
    train = _svm_rows(xs[::2], labels[::2], spk[::2])
    test = _svm_rows(xs[1::2], labels[1::2], spk[1::2])
    grid = sweep.SVM_PRESETS["dementia-svm"]()
    got = sweep.sweep_svm(grid, train, test, spk2label, results_csv=str(tmp_path / "r.csv"),
                          device="cpu")
    want = jax_sweep.sweep_svm(grid, train, test, spk2label)
    assert [r["pooling"] for r in got] == [r["pooling"] for r in want] == [
        "min", "max", "mean", "median"]
    for a, b in zip(got, want):
        assert a == pytest.approx(b)
    assert len((tmp_path / "r.csv").read_text().splitlines()) == 1 + len(got)


def _block(monkeypatch, *roots):
    """Make any import of the ``roots`` packages raise ImportError."""
    for name in list(sys.modules):
        if name.split(".")[0] in roots:
            monkeypatch.setitem(sys.modules, name, None)
    for root in roots:
        monkeypatch.setitem(sys.modules, root, None)


def test_pickle_and_result_csv_as_jax_writes_them(extracted, jev, tmp_path, monkeypatch):
    """The port's pickle loads in pandas as the DataFrame the JAX package
    writes from the same rows, and its Result.csv has the same bytes; the
    port's reader takes a pandas-written pickle only with pandas."""
    import pandas as pd

    got = extracted("dacs")[3]
    ours, theirs = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    ev.rows_to_pickle(got, ours)
    jev.rows_to_pickle(got, theirs)
    a, b = pd.read_pickle(ours), pd.read_pickle(theirs)
    assert list(a.columns) == list(b.columns) and set(a.columns) == COLUMNS
    assert a.dtypes.to_dict() == b.dtypes.to_dict()
    for col in a.columns:
        for x, y in zip(a[col], b[col]):
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape and x.shape[0] == 1
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y
    from_jax = ev.read_records(theirs)
    ev.write_results_csv(got, str(tmp_path / "port"))
    jev.write_results_csv(got, str(tmp_path / "jax"))
    assert ((tmp_path / "port/Result.csv").read_bytes()
            == (tmp_path / "jax/Result.csv").read_bytes())

    _block(monkeypatch, "pandas", "sklearn")
    recs = ev.read_records(ours)
    assert [r["path"] for r in recs] == [r["path"] for r in from_jax] == [r.path for r in got]
    for x, y in zip(recs, from_jax):
        assert x.keys() == y.keys()
        np.testing.assert_array_equal(x["hidden_states"], y["hidden_states"])
    with pytest.raises(ImportError, match="written by pandas itself"):
        ev.read_records(theirs)


def _write_corpus(root, n_train=4, n_test=2):
    rng = np.random.default_rng(0)
    (root / "clips").mkdir(parents=True)
    rows = {"train": [], "test": []}
    for i in range(n_train + n_test):
        name = f"S{i % 4:03d}_PAR_{i}_0_250.wav"
        wav = (rng.normal(0, 0.1, int(rng.integers(2400, 4000))) * 32767).astype(np.int16)
        wavfile.write(root / "clips" / name, 16000, wav)
        rows["train" if i < n_train else "test"].append(f"{name},{TEXTS[i % 5].lower()}")
    for split, r in rows.items():
        (root / f"{split}.csv").write_text("path,sentence\n" + "\n".join(r) + "\n")
    np.save(root / "spk2label.npy", {f"S{s:03d}": s % 2 for s in range(4)})


def _json_out(main, args) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(args)
    return json.loads(out.getvalue())


def test_cli_chain_on_cpu(tmp_path, monkeypatch):
    """``extract -> svm -> detail-wer -> feat-scoring -> pkl2csv`` of the
    port through ``cli.main`` with pandas and scikit-learn blocked, then the
    JAX CLI on the port's files printing the same JSON and CSV; ``dp-budget``
    as the JAX one."""
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path / "data")
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=2)
    save_params("model", init_dacs_state_dict(cfg, torch.Generator().manual_seed(0)))
    data = ["--audio_dir", "data/clips", "--train_csv", "data/train.csv",
            "--test_csv", "data/test.csv", "--spk2label", "data/spk2label.npy"]
    extract = ["extract", "--model_type", "tiny", "-st", "2", "-model_in", "model", *data,
               "--dataset_cache", "cache", "--eval_batch_size", "2", "--csv_out_dir", "res"]
    svm = ["svm", "--train_pkl", "res/extract_train.pkl", "--test_pkl", "res/extract.pkl",
           "--spk2label", "data/spk2label.npy", "-sq", "mean", "--results_csv", "svm.csv"]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        for args in (extract, svm):  # the default device is cuda
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(args)
    with monkeypatch.context() as m:
        _block(m, "pandas", "sklearn")
        cli.main(extract + ["--device", "cpu"])
        port = {"svm": _json_out(cli.main, svm + ["--device", "cpu"]),
                "wer": _json_out(cli.main, ["detail-wer", "--pkl", "res/extract.pkl", "-t", "2"]),
                "fsm": _json_out(cli.main, ["feat-scoring", "--pkl", "res/extract.pkl",
                                            "--out_dir", "fsm_port"])}
        cli.main(["pkl2csv", "--pkl", "res/extract.pkl", "--out", "port.csv"])
        recs = ev.read_records("res/extract.pkl")
    train = ev.read_records("res/extract_train.pkl")
    assert len(recs) == 2 and len(train) == 4
    assert all(set(r) == COLUMNS for r in recs + train)
    for r in recs:
        t = r["hidden_states"].shape[1]
        assert r["hidden_states"].shape == (1, t, cfg.hidden_size)
        assert r["lm_mask"].shape == r["dementia_mask"].shape == (1, t, cfg.hidden_size)
        assert set(np.unique(r["lm_mask"])) <= {0.0, 1.0}
    assert all(0.0 <= v <= 1.0 for v in port["svm"].values())
    overall = port["wer"]["overall"]
    assert overall["hits"] + overall["substitutions"] + overall["deletions"] == sum(
        len(r["text"].split()) for r in recs)
    assert all(0.0 <= port["fsm"][k] <= 1.0 for k in ("lm_on_rate", "ad_on_rate", "rate_11"))
    assert (tmp_path / "res/Result.csv").exists()

    jax = {"svm": _json_out(jax_cli.main, svm),
           "wer": _json_out(jax_cli.main, ["detail-wer", "--pkl", "res/extract.pkl", "-t", "2"]),
           "fsm": _json_out(jax_cli.main, ["feat-scoring", "--pkl", "res/extract.pkl",
                                           "--out_dir", "fsm_jax"])}
    assert port["wer"] == jax["wer"] and port["fsm"] == jax["fsm"]
    assert port["svm"] == pytest.approx(jax["svm"])
    for name in ("node_stats.npz", "utt_on_rates.npz"):
        a, b = np.load(f"fsm_port/{name}"), np.load(f"fsm_jax/{name}")
        assert all(np.array_equal(a[k], b[k]) for k in b.files)
    jax_cli.main(["pkl2csv", "--pkl", "res/extract.pkl", "--out", "jax.csv"])
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    for args in (["--rounds", "30", "--num_users", "4", "--frac", "0.5",
                  "--noise_multiplier", "1.1", "--report_every", "10"],
                 ["--rounds", "30", "--target_epsilon", "8.0"]):
        assert (_json_out(cli.main, ["dp-budget", *args])
                == _json_out(jax_cli.main, ["dp-budget", *args]))


TINY_CPU = ["--model_type", "tiny", "--device", "cpu"]


@pytest.mark.parametrize("call", [
    dict(mesh=object()), ["teacher", "--whisper_hf", "w", "--out", "t.csv", *TINY_CPU],
    dict(mode="text"),
    ["extract", "--dp", "2", *TINY_CPU],
    ["svm", "--text_train_pkl", "t.pkl", "--train_pkl", "a.pkl", "--test_pkl", "b.pkl",
     "--device", "cpu"],
    dict(tp=2), ["federated", "--client_mesh", "2", *TINY_CPU],
    ["sweep", "text", "--train_pkl", "a.pkl", "--test_pkl", "b.pkl", "--preset", "bert"]])
def test_options_not_ported_raise(call):
    """Options of later port slices raise by name, before any data is read:
    the Whisper teacher, data-parallel extraction, the text branch, tensor
    parallelism in the Trainer and the federated meshes."""
    from privacy_preserve_federated_asr_tpu_torch.train import Trainer, TrainerConfig

    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=2)
    with pytest.raises(NotImplementedError, match="not ported"):
        if isinstance(call, list):
            cli.main(call)
        elif "mode" in call:
            ev.predict_ad_svm([], [], {}, device="cpu", **call)
        elif "tp" in call:
            Trainer(cfg, {}, [], None, TOK, TrainerConfig(**call), device="cpu")
        else:
            ev.extract_embeddings(cfg, {}, [], TOK, device="cpu", **call)
