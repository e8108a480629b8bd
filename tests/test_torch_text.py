"""The port's text branch (privacy_preserve_federated_asr_tpu_torch/text,
``cli text``, ``svm --mode text|fusion`` and ``sweep text``) against the JAX
package's on the CPU, at tiny sizes with the port's seeded inits carried to
JAX (the JAX package's ``port_hf_bert``, flax Dense trees; the bridges
``state_dict_from_flax_bert``, ``dense_state_dict_from_flax`` and
``finetune_state_dict_from_flax`` carry params and gradients back) and
dropout 0 (each package draws its own dropout masks): BertEncoder and its pooled output, WordPiece ids, each
fusion of TextClassifier, a TextTrainer fit and a FinetuneTextTrainer step
with every gradient, registry experiments with a text and an audio input,
the CLI against the JAX CLI in one process (Python's ``hash()`` fallback is
salted per process, so both run in this one), and both CLIs' parsers."""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu.text import bert as jbert
from privacy_preserve_federated_asr_tpu.text import classifier as jcls
from privacy_preserve_federated_asr_tpu.text import experiments as jexp
from privacy_preserve_federated_asr_tpu.text import finetune as jft
from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.evaluation import columns_to_pickle
from privacy_preserve_federated_asr_tpu_torch.text import bert as pbert
from privacy_preserve_federated_asr_tpu_torch.text import classifier as pcls
from privacy_preserve_federated_asr_tpu_torch.text import experiments as pexp
from privacy_preserve_federated_asr_tpu_torch.text import finetune as pft
from test_torch_backbone import one_torch_thread  # noqa: F401

ATOL = 1e-5   # fp32 activations, losses and gradients at these sizes
WORDS = ["the", "boy", "is", "on", "a", "stool", "cookie", "jar", "water", "sink", "mother",
         "dish", "window", "open", "falling", "girl", "wash", "##ing", "##s", "over", "flow"]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + WORDS + [".", ","]
TEXTS = ["The boy is falling off the stool.", "Mother is washing dishes, water overflows",
         "a girl", "the cookie jar is open", "uh the the window", ""]


def _bert_cfg(**kw):
    return jbert.BertConfigT.tiny_for_tests().replace(
        vocab_size=len(VOCAB), hidden_dropout=0.0, attention_dropout=0.0, **kw)


def _pcfg(jcfg, cls):
    """The port's config of the same fields."""
    d = dataclasses.asdict(jcfg)
    if "bert" in d:
        d["bert"] = pbert.BertConfigT(**d["bert"])
    return cls(**d)


def test_bert_encoder_and_wordpiece():
    """WordPiece ids and masks equal (## pieces, [UNK], truncation,
    padding); the encoder's sequence output and pooled tanh output within
    1e-5 on a padded batch; ``port_hf_bert`` reads an HF ``BertModel``
    state dict under a prefix and ignores what the encoder lacks."""
    jtok, ptok = jbert.WordPieceTokenizer(VOCAB), pbert.WordPieceTokenizer(VOCAB)
    for t in TEXTS + ["stools flowing xyz"]:
        for kw in ({}, {"max_length": 5, "pad_to": 5}, {"pad_to": 16}):
            assert ptok.encode(t, **kw) == jtok.encode(t, **kw)
    enc = [jtok.encode(t, max_length=16, pad_to=16) for t in TEXTS]
    ids = np.asarray([e[0] for e in enc])
    mask = np.asarray([e[1] for e in enc])
    cfg = _bert_cfg()
    init = pbert.seeded_init_(pbert.BertEncoder(_pcfg(cfg, pbert.BertConfigT)),
                              torch.Generator().manual_seed(0)).state_dict()
    params = jbert.port_hf_bert(init, cfg)   # the JAX package's own HF loader
    sd = pbert.state_dict_from_flax_bert(params)
    assert all(torch.equal(sd[k], v) for k, v in init.items())
    seq, pooled = jax.jit(jbert.BertEncoder(cfg).apply)({"params": params}, jnp.asarray(ids),
                                                         jnp.asarray(mask))
    hf = {**{f"bert.{k}": v for k, v in sd.items()}, "bert.embeddings.position_ids":
          torch.arange(64)[None], "cls.predictions.bias": torch.zeros(3)}
    port = pbert.BertEncoder(_pcfg(cfg, pbert.BertConfigT))
    port.load_state_dict(pbert.port_hf_bert(hf, port.cfg, prefix="bert."), strict=True)
    with torch.no_grad():
        got_seq, got_pooled = port(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got_seq.numpy(), np.asarray(seq), atol=ATOL)
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), atol=ATOL)


def _to_flax(sd) -> dict:
    """A state dict of Linears -> flax Dense params (``kernel`` = weight.T)."""
    tree = {}
    for k, v in sd.items():
        name, leaf = k.rsplit(".", 1)
        tree.setdefault(name, {})["kernel" if leaf == "weight" else "bias"] = (
            v.numpy().T if leaf == "weight" else v.numpy())
    return tree


def _classifier_init(pcfg, x, seed):
    """The port TextTrainer's seeded init of a TextClassifier for inputs
    like ``x``: (flax params, state dict)."""
    sd = pcls.TextTrainer(pcfg, pcls.TextTrainerConfig(seed=seed), device="cpu").init_params(x[:1])
    return _to_flax(sd), sd


FUSIONS = {"single": dict(embed_dim=6),
           "concat": dict(embed_dim=6, num_inputs=3, fusion="concat"),
           "attention": dict(embed_dim=6, num_inputs=3, fusion="attention"),
           "cross_attention": dict(embed_dim=6, num_inputs=2, fusion="cross_attention",
                                   input_dims=(6, 4), align_dim=8)}


@pytest.mark.parametrize("fusion", sorted(FUSIONS))
def test_text_classifier_fusions(fusion):
    """Each fusion's logits within 1e-5 under the same weights (inputs
    [B, E], [B, n, E] or the flat heterogeneous pack): the port's module has
    exactly the flax module's parameters."""
    jcfg = jcls.TextClassifierConfig(hidden_dim=10, dropout=0.0, **FUSIONS[fusion])
    rng = np.random.default_rng(0)
    shape = ((5, 10) if jcfg.input_dims else (5, 6) if jcfg.num_inputs == 1
             else (5, jcfg.num_inputs, 6))
    x = rng.normal(size=shape).astype(np.float32)
    pcfg = _pcfg(jcfg, pcls.TextClassifierConfig)
    port = pcls.TextClassifier(pcfg, pcls.part_dims(pcfg, x))
    pbert.seeded_init_(port, torch.Generator().manual_seed(0))
    want = jax.jit(jcls.TextClassifier(jcfg).apply)({"params": _to_flax(port.state_dict())},
                                                    jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), np.asarray(want),
                                   atol=ATOL)


def test_schedules_match_optax():
    import optax

    for kind, kw, ref in (
            ("exp", {}, optax.exponential_decay(1e-3, 4, 0.9)),
            ("exp", dict(exp_rate=0.5, staircase=True),
             optax.exponential_decay(1e-3, 4, 0.5, staircase=True)),
            ("cos", {}, optax.cosine_decay_schedule(1e-3, 20)),
            ("lin", {}, optax.linear_schedule(1e-3, 0.0, 20))):
        ours = pcls.make_schedule(kind, 1e-3, 4, 20, **kw)
        for n in (0, 1, 3, 4, 9, 20, 25):
            assert ours(n) == pytest.approx(float(ref(n)), rel=1e-6, abs=1e-12), (kind, n)


@pytest.fixture
def inject_inits(monkeypatch):
    """The JAX trainers start from the port trainers' inits (each package
    draws its own), so whole fits compare: the classifier's flax ``init``
    returns the port's seeded init for the key's seed, and the fine-tune
    trainer's ``init_params`` the port's (its towers through the JAX
    package's ``port_hf_bert``), pretrained towers grafted as JAX does."""
    def text_init(self, rngs, x, *args, **kwargs):
        seed = int(np.asarray(jax.random.key_data(rngs["params"]))[-1])
        return {"params": _classifier_init(_pcfg(self.cfg, pcls.TextClassifierConfig),
                                           np.asarray(x), seed)[0]}

    def ft_init(self, rng=None, encoder_params=None):
        d = dataclasses.asdict(self.cfg)
        pt = pft.FinetuneTextTrainer(
            pft.FinetuneConfig(**{**d, "bert": pbert.BertConfigT(**d["bert"])}), self.tok,
            pft.FinetuneTrainerConfig(**dataclasses.asdict(self.tcfg)), device="cpu")
        sd = pt.init_params().state_dict()
        names = pt.cfg.encoder_names
        self.params = {**_to_flax({k: v for k, v in sd.items()
                                   if k.split(".")[0] not in names}),
                       **{e: jbert.port_hf_bert(sd, self.cfg.bert, prefix=f"{e}.")
                          for e in names}}
        for e in names if encoder_params is not None else ():
            self.params[e] = jax.tree_util.tree_map(jnp.asarray, encoder_params)
        return self.params

    monkeypatch.setattr(jcls.TextClassifier, "init", text_init)
    monkeypatch.setattr(jft.FinetuneTextTrainer, "init_params", ft_init)


def test_text_trainer_fit_and_gradients(inject_inits):
    """TextTrainer on a 2-input cross-attention classifier at dropout 0:
    every gradient of the first batch (the unused q/k projections' zeros
    included) within 1e-5 of ``jax.grad``'s, then a fit with early
    stopping (cosine schedule, 5 epochs of 4 steps) against the JAX fit:
    the history and the predictions equal, the parameters within 1e-5."""
    jcfg = jcls.TextClassifierConfig(hidden_dim=10, dropout=0.0, num_inputs=2, embed_dim=6,
                                     fusion="cross_attention", input_dims=(6, 4), align_dim=8)
    tcfg = dict(learning_rate=1e-2, lr_schedule="cos", num_epochs=5, batch_size=4,
                early_stopping_patience=2, seed=3)
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(18, 10)).astype(np.float32), rng.integers(0, 2, 18)
    xv, yv = rng.normal(size=(6, 10)).astype(np.float32), rng.integers(0, 2, 6)
    pcfg = _pcfg(jcfg, pcls.TextClassifierConfig)
    params, sd = _classifier_init(pcfg, x, 3)

    def loss(p, xb, yb):
        logits = jcls.TextClassifier(jcfg).apply({"params": p}, xb)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), yb[:, None], 1))

    grads = pcls.dense_state_dict_from_flax(jax.jit(jax.grad(loss))(
        params, jnp.asarray(x[:4]), jnp.asarray(y[:4], jnp.int32)), list(params))
    port = pcls.TextClassifier(pcfg, (6, 4))
    port.load_state_dict(sd)
    pcls.classification_loss(port(torch.from_numpy(x[:4])), torch.from_numpy(y[:4]),
                             False).backward()
    for k, p in port.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), grads[k].numpy(), atol=ATOL, err_msg=k)
    assert all(not g.any() for k, g in grads.items() if "_q." in k or "_k." in k)

    jt = jcls.TextTrainer(jcfg, jcls.TextTrainerConfig(**tcfg))
    want = jt.fit(x, y, xv, yv)
    pt = pcls.TextTrainer(pcfg, pcls.TextTrainerConfig(**tcfg), device="cpu")
    got = pt.fit(x, y, xv, yv)
    assert [r["epoch"] for r in got["history"]] == [r["epoch"] for r in want["history"]]
    for a, b in zip(got["history"], want["history"]):
        assert a == pytest.approx(b, abs=ATOL)
    assert got["best_val_metric"] == want["best_val_metric"]
    np.testing.assert_array_equal(pt.predict(xv), jt.predict(xv))
    final = pcls.dense_state_dict_from_flax(jt.params, list(jt.params))
    for k, v in pt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=ATOL, err_msg=k)


def test_finetune_step_and_gradients():
    """FinetuneTextTrainer with two text towers, cross-attention fusion and
    3 frozen extra features at dropout 0, the port's init carried to JAX
    (its ``port_hf_bert`` for the towers): ``loss_and_grads``, the loss and
    every gradient within 1e-5 (the fit's AdamW and schedule are held by
    the TextTrainer test and ``cli text --finetune``); ``dp=2`` refused by
    name."""
    cfg = jft.FinetuneConfig(bert=_bert_cfg(), num_text_inputs=2, extra_dim=3,
                             fusion="cross_attention", align_dim=8)
    tcfg = dict(max_length=12, seed=1)
    texts = [TEXTS[:4], TEXTS[2:6]]
    y = np.array([0, 1, 1, 0])
    extra = np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)
    pt = pft.FinetuneTextTrainer(_pcfg(cfg, pft.FinetuneConfig), pbert.WordPieceTokenizer(VOCAB),
                                 pft.FinetuneTrainerConfig(**tcfg), device="cpu")
    sd = pt.init_params().state_dict()
    jt = jft.FinetuneTextTrainer(cfg, jbert.WordPieceTokenizer(VOCAB),
                                 jft.FinetuneTrainerConfig(**tcfg))
    jt.params = {**_to_flax({k: v for k, v in sd.items() if not k.startswith("encoder")}),
                 **{e: jbert.port_hf_bert(sd, cfg.bert, prefix=f"{e}.")
                    for e in ("encoder_0", "encoder_1")}}
    want_loss, want_grads = jt.loss_and_grads(texts, y, extra)
    got_loss, got_grads = pt.loss_and_grads(texts, y, extra)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    want_grads = pft.finetune_state_dict_from_flax(want_grads)
    assert set(got_grads) == set(want_grads) == set(sd)
    for k, g in got_grads.items():
        np.testing.assert_allclose(g, want_grads[k].numpy(), atol=ATOL, err_msg=k)
    assert pt.encoder_param_norm_delta(sd) == 0.0
    with pytest.raises(NotImplementedError, match="not ported yet"):
        pft.FinetuneTextTrainer(pt.cfg, pt.tok, pft.FinetuneTrainerConfig(dp=2), device="cpu")


def _rows(n_sessions: int, seed: int) -> list[dict]:
    """Extraction-style rows: 2-3 utterances per session, labels by
    session, ASR-ish pred_str, audio paths."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(n_sessions):
        for u in range(2 + s % 2):
            words = rng.choice(WORDS[:17], size=int(rng.integers(2, 6)))
            rows.append({"path": f"S{seed}{s:02d}_{'INV' if u == 2 else 'PAR'}_{u}_{u * 100}"
                                 f"_{u * 100 + 90}.wav",
                         "text": " ".join(words), "pred_str": " ".join(words[::-1]),
                         "dementia_labels": s % 2})
    return rows


@pytest.fixture(autouse=True)
def no_dropout(monkeypatch):
    """Dropout 0 in both packages' default configs (the registry's
    classifier, cli text's classifier and BERT)."""
    for bert, cls, exp in ((jbert, jcls, jexp), (pbert, pcls, pexp)):
        base_b, base_c = bert.BertConfigT, cls.TextClassifierConfig
        monkeypatch.setattr(bert, "BertConfigT", dataclasses.make_dataclass(
            "BertConfigT", [("hidden_dropout", float, 0.0), ("attention_dropout", float, 0.0)],
            bases=(base_b,), frozen=True))
        monkeypatch.setattr(cls, "TextClassifierConfig", dataclasses.make_dataclass(
            "TextClassifierConfig", [("dropout", float, 0.0)], bases=(base_c,), frozen=True))
        f = exp.ExperimentSpec.classifier_config
        monkeypatch.setattr(f, "__defaults__", (None, 0.0, None))


def _ssl_backends(tmp_path, rows):
    """One tiny SSL conv frontend (a torch init, carried to flax by
    ``flax_from_state_dict``) as the 'multi' audio backend of both
    packages, over WAVs written for the rows' paths."""
    from scipy.io import wavfile

    from privacy_preserve_federated_asr_tpu.models import BackboneConfig as JaxBackboneConfig
    from privacy_preserve_federated_asr_tpu.text import audio_backend as jab
    from privacy_preserve_federated_asr_tpu_torch.models import BackboneConfig, SSLBackbone
    from privacy_preserve_federated_asr_tpu_torch.models.port import flax_from_state_dict
    from privacy_preserve_federated_asr_tpu_torch.text import audio_backend as pab

    rng = np.random.default_rng(3)
    for r in rows:
        wav = (rng.normal(0, 0.1, int(rng.integers(2000, 7000))) * 32767).astype(np.int16)
        wavfile.write(tmp_path / r["path"], 16000, wav)
    jcfg = JaxBackboneConfig.tiny_for_tests()
    torch.manual_seed(4)
    sd = SSLBackbone(BackboneConfig.tiny_for_tests()).state_dict()
    params = flax_from_state_dict(sd)
    kw = dict(audio_root=str(tmp_path), batch_size=4, time_multiple=3200)
    jb = jab.audio_backends_for(["multi"], params_by_backend={"multi": params}, cfg=jcfg, **kw)
    pb = pab.audio_backends_for(["multi"], params_by_backend={"multi": sd},
                                cfg=BackboneConfig.tiny_for_tests(), device="cpu", **kw)
    return jb, pb


@pytest.mark.parametrize("name", ["session_text_n_summary", "sentence_multi"])
def test_run_experiment(tmp_path, inject_inits, name):
    """A registry experiment of two text inputs (hashed bag of words) and
    one of a text and an audio input (a tiny SSL conv frontend): the audio
    embeddings within 1e-5 and the experiment's test metrics equal."""
    train, test = _rows(8, 1), _rows(4, 2)
    backends = ({}, {})
    if name == "sentence_multi":
        backends = _ssl_backends(tmp_path, train + test)
        paths = [r["path"] for r in test]
        np.testing.assert_allclose(backends[1]["multi"](paths), backends[0]["multi"](paths),
                                   atol=ATOL)
    kw = dict(seeds=(0,))
    want = jexp.run_experiment(name, train, test, backends=backends[0],
                               tcfg=jcls.TextTrainerConfig(num_epochs=3, batch_size=4,
                                                           learning_rate=1e-2), **kw)
    got = pexp.run_experiment(name, train, test, backends=backends[1],
                              tcfg=pcls.TextTrainerConfig(num_epochs=3, batch_size=4,
                                                          learning_rate=1e-2),
                              device="cpu", **kw)
    assert got == want


def _json_out(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(args)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture
def text_corpus(tmp_path, monkeypatch):
    """Extraction pickles of 8 and 4 sessions (written without pandas, read
    by the JAX CLI with pandas) and an HF-named BERT checkpoint with its
    vocab.txt and config.json."""
    monkeypatch.chdir(tmp_path)
    for split, rows in (("train", _rows(8, 1)), ("test", _rows(4, 2))):
        columns_to_pickle({k: [r[k] for r in rows] for k in rows[0]}, f"{split}.pkl")
    (tmp_path / "bert").mkdir()
    enc = pbert.seeded_init_(pbert.BertEncoder(pbert.BertConfigT(
        vocab_size=len(VOCAB), hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=64)), torch.Generator().manual_seed(0))
    torch.save(enc.state_dict(), "bert/pytorch_model.bin")
    (tmp_path / "bert/vocab.txt").write_text("\n".join(VOCAB) + "\n")
    (tmp_path / "bert/config.json").write_text(json.dumps({"num_attention_heads": 2}))
    return tmp_path


@pytest.fixture
def jit_jax_bert(monkeypatch):
    """The JAX CLI's frozen embedder applies its BertEncoder eagerly, op by
    op; jitted here (the same function, one program per batch width)."""
    real, progs = jbert.BertEncoder.apply, {}

    def apply(self, variables, *args, **kwargs):
        if kwargs:
            return real(self, variables, *args, **kwargs)
        if self.cfg not in progs:
            progs[self.cfg] = jax.jit(lambda v, *a: real(self, v, *a))
        return progs[self.cfg](variables, *args)

    monkeypatch.setattr(jbert.BertEncoder, "apply", apply)


@pytest.mark.parametrize("mode", ["plain", "finetune", "experiment"])
def test_cli_text_matches_jax(text_corpus, inject_inits, jit_jax_bert, mode):
    """``cli text`` of the port (``--device cpu``) and of the JAX package
    print the same metrics: the hashed bag of words, ``--finetune`` into the
    BERT checkpoint (max_length 24), and a registry experiment with the
    checkpoint frozen serving both its text inputs."""
    from privacy_preserve_federated_asr_tpu import cli as jax_cli

    args = ["text", "--train_pkl", "train.pkl", "--test_pkl", "test.pkl", "--epochs", "3",
            "--train_batch_size", "2", "--hidden_dim", "12", "-lr", "1e-2"]
    bert = ["--bert_checkpoint", "bert/pytorch_model.bin", "--vocab", "bert/vocab.txt"]
    args += {"plain": ["--use_text", "pred_str"],
             "finetune": [*bert, "--finetune", "--max_length", "24"],
             "experiment": [*bert, "--experiment", "session_text_n_summary"]}[mode]
    want = _json_out(jax_cli.main, args)
    got = _json_out(cli.main, args + ["--device", "cpu"])
    assert got == pytest.approx(want) and got


def test_svm_text_modes_and_sweep_text(text_corpus, inject_inits):
    """``svm --mode text`` and ``--mode fusion`` with ``--text_train_pkl``
    session tables (written by the port, read by both), and ``sweep text``
    of one experiment: the port's rows and results CSV equal the JAX CLI's."""
    from privacy_preserve_federated_asr_tpu import cli as jax_cli

    rng = np.random.default_rng(5)
    for split, n in (("train", 8), ("test", 4)):
        rows = _rows(n, 1 if split == "train" else 2)
        for r in rows:
            r["hidden_states"] = rng.normal(size=(1, int(rng.integers(3, 7)), 4)).astype(
                np.float32)
        columns_to_pickle({k: [r[k] for r in rows] for k in rows[0]}, f"x_{split}.pkl")
        sessions = sorted({r["path"].split("_")[0] for r in rows})
        columns_to_pickle({"session": sessions, "Embedding": [
            rng.normal(size=5).astype(np.float32) for _ in sessions]}, f"t_{split}.pkl")
    np.save("spk.npy", {r["path"].split("_")[0]: r["dementia_labels"]
                        for n, s in ((8, 1), (4, 2)) for r in _rows(n, s)})
    for mode in ("text", "fusion"):
        args = ["svm", "--train_pkl", "x_train.pkl", "--test_pkl", "x_test.pkl",
                "--spk2label", "spk.npy", "--mode", mode, "--text_train_pkl", "t_train.pkl",
                "--text_test_pkl", "t_test.pkl", "-sq", "mean", "--results_csv", f"{mode}.csv"]
        assert _json_out(cli.main, args + ["--device", "cpu"]) == pytest.approx(
            _json_out(jax_cli.main, args))
    args = ["sweep", "text", "--train_pkl", "train.pkl", "--test_pkl", "test.pkl", "--grid",
            "experiment=sentence_text", "num_epochs=2", "batch_size=4",
            "learning_rate=1e-2"]
    got = [json.loads(line) for line in io.StringIO(_capture(cli.main, args + [
        "--device", "cpu", "--results_csv", "port.csv"]))]
    want = [json.loads(line) for line in io.StringIO(_capture(jax_cli.main, args + [
        "--results_csv", "jax.csv"]))]
    assert len(got) == 1 and got == want
    assert (text_corpus / "port.csv").read_bytes() == (text_corpus / "jax.csv").read_bytes()


def _capture(main, args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(args)
    return out.getvalue()


def _options(parser) -> dict:
    """subcommand -> {option strings: (default, choices)}, sweep's targets
    as ``sweep <target>``."""
    out = {}
    subs = next(a for a in parser._actions if a.choices and isinstance(a.choices, dict))
    for name, p in subs.choices.items():
        nested = [a for a in p._actions if isinstance(a.choices, dict)]
        targets = nested[0].choices.items() if nested else [(None, p)]
        for target, sp in targets:
            out[f"{name} {target}" if target else name] = {
                tuple(a.option_strings): (sp.get_default(a.dest), a.choices)
                for a in sp._actions if a.option_strings and a.dest != "help"}
    return out


def test_parsers_match_jax(tmp_path):
    """Every subcommand of the port's parser has the JAX parser's options
    with the same defaults and choices; only ``--device`` is the port's own
    (with ``transcribe``'s shallow-fusion LM flags, which it shares with
    ``serve`` and ``extract``) and ``--no_fast_rng`` (the TPU's RNG switch)
    JAX's own. ``--num_lms``
    and ``serve --int8`` take JAX's effect: the method's model gets the
    N-best heads (and ``export-hf`` writes them), and W8A8 Dense layers."""
    from privacy_preserve_federated_asr_tpu import cli as jax_cli

    ours, theirs = _options(cli.build_parser()), _options(jax_cli.build_parser())
    assert sorted(ours) == sorted(theirs)
    port_only = {("--device",)} | {(f,) for f in ("--lm_train_csv", "--lm_alpha", "--lm_beta")}
    for sub in theirs:
        a = {k: v for k, v in ours[sub].items()
             if k not in (port_only if sub == "transcribe" else {("--device",)})}
        b = {k: v for k, v in theirs[sub].items() if k != ("--no_fast_rng",)}
        assert a == b, (sub, set(a) ^ set(b))
    parse = cli.build_parser().parse_args
    assert cli._dacs_cfg(parse(["serve", "--int8"])).backbone.dense_impl == "int8_train"
    for sub in ("train", "extract", "transcribe", "teacher", "export-hf", "stream-report",
                "serve", "sweep"):
        argv = [sub, "--num_lms", "2"] + (["--out", "x"] if sub == "teacher" else
                                          ["--audio", "x"] if sub == "transcribe" else [])
        if sub == "sweep":
            argv = ["sweep", "asr", "--num_lms", "2"]
        assert cli._dacs_cfg(parse(argv)).num_lms == 2, sub
    out = tmp_path / "e.bin"
    cli.main(["export-hf", "--model_type", "tiny", "--num_lms", "2", "--device", "cpu",
              "--out", str(out)])
    keys = torch.load(out, weights_only=True)
    assert {"lm_heads.0.weight", "lm_heads.1.bias", "lm_head.weight"} <= set(keys)
