"""Registry of the reference's 0207_DM_* text-branch experiments (the
port's ``text/experiments.py``).

One named entry per reference driver script (centralized/0207_DM_*.py),
mapping it to (level, input columns, embedding backends, fusion, task,
special handling). ``run_experiment`` turns an entry into a runnable
train/eval with pluggable embedding backends, reachable from the CLI as
``cli text --experiment <name>``.

Embedding-backend name -> width follows the reference's
Model_settings_dict (Dementia_challenge_models.py:93-133):
text backends mbert=768, xlm=1280; audio backends en/gr/multi/wv=512
(XLSR-english/-greek/-multilingual, wav2vec); summary backend anomia=768;
similarity embeddings Semb per 0207_DM_SessionLvlSimilarityEmb.py.

The registry and the data assembly are the JAX package's, copied; the
trainers are the port's, on ``device`` (``cuda`` unless the caller asks for
the CPU). :func:`hash_embed_backend` keeps Python's ``hash()`` as the JAX
package does: it is salted per process unless ``PYTHONHASHSEED`` is set,
so the offline embedding is deterministic only within one process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import numpy as np

from .classifier import TextClassifierConfig, TextTrainer, TextTrainerConfig

# backend name -> embedding width (reference Model_settings_dict)
BACKEND_DIMS = {
    "mbert": 768, "xlm": 1280, "bert": 768,          # text
    "en": 512, "gr": 512, "multi": 512, "wv": 512,   # audio
    "anomia": 768,                                   # summary text
    "semb": 768,                                     # similarity embedding
}


@dataclass(frozen=True)
class InputSpec:
    column: str      # dataframe column holding the raw input
    backend: str     # BACKEND_DIMS key

    @property
    def dim(self) -> int:
        return BACKEND_DIMS[self.backend]


@dataclass(frozen=True)
class ExperimentSpec:
    name: str
    ref: str                       # reference script (file parity anchor)
    level: str                     # "sentence" | "session"
    inputs: tuple[InputSpec, ...]
    fusion: str = "concat"         # concat | attention | cross_attention
    task: str = "classification"   # classification | regression
    special: str | None = None     # rag_summary | similarity_emb | augment |
                                   # consistency | param_tuning | extract_aug

    def classifier_config(self, hidden_dim: int | None = None,
                          dropout: float = 0.1,
                          dims: tuple[int, ...] | None = None) -> TextClassifierConfig:
        # ``dims`` overrides the reference encoder widths when custom
        # embedding backends of a different width are plugged in
        dims = tuple(dims) if dims is not None else tuple(i.dim for i in self.inputs)
        return TextClassifierConfig(
            embed_dim=dims[0],
            # reference heads size clf1 by the fused width (sum of inputs
            # for concat, 2*align for the attention fuse)
            hidden_dim=hidden_dim if hidden_dim is not None else sum(dims),
            regression=self.task == "regression",
            num_inputs=len(dims),
            fusion=self.fusion,
            input_dims=dims if len(dims) > 1 else None,
            dropout=dropout,
        )


def _e(name, ref, level, inputs, **kw):
    return ExperimentSpec(name=name, ref=ref, level=level,
                          inputs=tuple(InputSpec(*i) for i in inputs), **kw)


_SENT = "sentence"
_SESS = "session"

EXPERIMENTS: dict[str, ExperimentSpec] = {e.name: e for e in [
    # --- sentence level -------------------------------------------------
    _e("sentence_1input", "0207_DM_SentenceLvl1input.py", _SENT,
       [("text", "mbert")]),
    _e("sentence_1input_regression", "0207_DM_SentenceLvl1input.py", _SENT,
       [("text", "mbert")], task="regression"),
    _e("sentence_1input_param_tuning",
       "0207_DM_SentenceLvl1input_ParamTuning.py", _SENT,
       [("text", "mbert")], special="param_tuning"),
    _e("sentence_2input_homogeneous",
       "0207_DM_SentenceLvl2inputHomogeneous.py", _SENT,
       [("text", "mbert"), ("text", "xlm")]),
    _e("sentence_2input_heterogeneous",
       "0207_DM_SentenceLvl2inputHeterogeneous.py", _SENT,
       [("text", "mbert"), ("summary", "anomia")]),
    _e("sentence_2input_heterogeneous_attention_fuse",
       "0207_DM_SentenceLvl2inputHeterogeneous_attentionFuse.py", _SENT,
       [("text", "mbert"), ("summary", "anomia")], fusion="cross_attention"),
    _e("sentence_3input_heterogeneous",
       "0207_DM_SentenceLvl3inputHeterogeneous.py", _SENT,
       [("text", "mbert"), ("summary", "anomia"), ("path", "en")]),
    _e("sentence_multi", "0207_DM_SentenceLvlmulti.py", _SENT,
       [("text", "mbert"), ("path", "multi")]),
    _e("sentence_text", "0207_DM_SentenceLvltext.py", _SENT,
       [("text", "mbert")]),
    _e("sentence_rag_summary", "0207_DM_SentenceLvlRAGSummary.py", _SENT,
       [("rag_summary", "anomia")], special="rag_summary"),
    # --- session level --------------------------------------------------
    _e("session_1input", "0207_DM_SessionLvl1input.py", _SESS,
       [("text", "mbert")]),
    _e("session_1input_consistency_test",
       "0207_DM_SessionLvl1input_consistencyTest.py", _SESS,
       [("text", "mbert")], special="consistency"),
    _e("session_2input_homogeneous",
       "0207_DM_SessionLvl2inputHomogeneous.py", _SESS,
       [("text", "mbert"), ("text", "xlm")]),
    _e("session_text", "0207_DM_SessionLvltext.py", _SESS,
       [("text", "mbert")]),
    _e("session_text_aug", "0207_DM_SessionLvltext_aug.py", _SESS,
       [("text", "mbert")], special="augment"),
    _e("session_summary", "0207_DM_SessionLvlSummary.py", _SESS,
       [("summary", "anomia")]),
    _e("session_text_n_summary", "0207_DM_SessionLvltextnSummary.py", _SESS,
       [("text", "mbert"), ("summary", "anomia")]),
    _e("session_similarity_emb", "0207_DM_SessionLvlSimilarityEmb.py", _SESS,
       [("text", "mbert"), ("text", "mbert"), ("semb", "semb")],
       special="similarity_emb"),
    _e("extract_data_augmentation", "0207_DM_Extact_dataAugmentation.py",
       _SESS, [("text", "mbert")], special="extract_aug"),
]}


def hash_embed_backend(dim: int) -> Callable[[Sequence[str]], np.ndarray]:
    """Offline embedding (hashing bag-of-words, L2-normed): the standalone
    fallback used when no pretrained encoder is configured. Python's
    ``hash()`` is salted per process (unless ``PYTHONHASHSEED`` is set), so
    it is deterministic within one process only, as in the JAX package."""

    def embed(texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), dim), dtype=np.float32)
        for i, t in enumerate(texts):
            for w in str(t).lower().split():
                out[i, hash(w) % dim] += 1.0
            n = np.linalg.norm(out[i])
            if n > 0:
                out[i] /= n
        return out

    return embed


@dataclass
class ExperimentData:
    """Rows ready for an experiment: per-example input texts (one list per
    InputSpec, aligned) and integer labels (or MMSE floats)."""

    inputs: list[list[str]]
    labels: np.ndarray


def rows_to_experiment_data(
    spec: ExperimentSpec,
    rows: Sequence[Mapping],
    label_key: str = "dementia_labels",
    summaries: Mapping[str, str] | None = None,
) -> ExperimentData:
    """Assemble an experiment's inputs from extraction rows.

    ``sentence`` level keeps one example per utterance row; ``session``
    level concatenates each speaker's utterances into one document
    (reference sentence vs session scripts). ``summaries`` supplies the
    LLM/anomia summary column keyed by session id where a spec asks for it.
    """
    from .session import assemble_sessions

    if spec.level == "session":
        docs = assemble_sessions(rows, text_key="text")
        sids = sorted(docs)
        label_map = {r["path"].split("_")[0]: r[label_key] for r in rows}
        base_texts = {"text": [docs[s] for s in sids],
                      "pred_str": [docs[s] for s in sids]}
        labels = np.asarray([label_map[s] for s in sids])
        keys = sids
    else:
        keys = [r["path"] for r in rows]
        base_texts = {
            "text": [str(r.get("text", "")) for r in rows],
            "pred_str": [str(r.get("pred_str", r.get("text", ""))) for r in rows],
            "path": [str(r["path"]) for r in rows],
        }
        labels = np.asarray([r[label_key] for r in rows])

    inputs = []
    for ispec in spec.inputs:
        col = ispec.column
        if col in ("summary", "rag_summary", "semb"):
            src = summaries or {}
            inputs.append([str(src.get(k, base)) for k, base in
                           zip(keys, base_texts.get("text", [""] * len(keys)))])
        elif col in base_texts:
            inputs.append(base_texts[col])
        else:
            inputs.append([str(r.get(col, "")) for r in rows])
    return ExperimentData(inputs=inputs, labels=labels)


# registry backends that embed TEXT (servable by a ported BERT checkpoint);
# en/gr/multi/wv are the reference's wav2vec-xlsr AUDIO encoders
TEXT_BACKENDS = frozenset({"mbert", "xlm", "bert", "anomia", "semb"})


def embed_experiment_parts(
    spec: ExperimentSpec,
    data: ExperimentData,
    backends: Mapping[str, Callable[[Sequence[str]], np.ndarray]] | None = None,
) -> list[np.ndarray]:
    """Embed every input with its backend. A custom backend may return any
    width (the classifier sizes itself from the actual embeddings); the
    offline fallback must match the reference encoder width. Hashing is a
    TEXT fallback — an AUDIO input (en/gr/multi/wv) hashed from its path
    string is semantically void, so it warns loudly; wire the real conv-
    frontend backend via ``run_experiment(audio_root=...)`` or a custom
    ``backends`` entry (text/audio_backend.py)."""
    import warnings

    parts = []
    for ispec, texts in zip(spec.inputs, data.inputs):
        custom = (backends or {}).get(ispec.backend)
        if custom is None and ispec.backend not in TEXT_BACKENDS:
            warnings.warn(
                f"audio backend '{ispec.backend}' has no SSL backend wired "
                "(no audio_root / backends entry): falling back to hashing "
                "the path STRING, which carries no audio information",
                stacklevel=2)
        fn = custom or hash_embed_backend(ispec.dim)
        emb = np.asarray(fn(texts), dtype=np.float32)
        assert emb.ndim == 2 and emb.shape[0] == len(texts), (
            f"backend {ispec.backend} returned {emb.shape} for {len(texts)} texts")
        if custom is None:
            assert emb.shape[1] == ispec.dim, (
                f"fallback for {ispec.backend} returned width {emb.shape[1]}, "
                f"want {ispec.dim}")
        parts.append(emb)
    return parts


def embed_experiment(
    spec: ExperimentSpec,
    data: ExperimentData,
    backends: Mapping[str, Callable[[Sequence[str]], np.ndarray]] | None = None,
) -> np.ndarray:
    """Flat-concat of :func:`embed_experiment_parts` into the classifier's
    packed [B, sum(dims)] layout."""
    parts = embed_experiment_parts(spec, data, backends)
    return np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]


def run_experiment(
    name: str,
    train_rows: Sequence[Mapping],
    test_rows: Sequence[Mapping],
    backends: Mapping[str, Callable] | None = None,
    summaries: Mapping[str, str] | None = None,
    tcfg: TextTrainerConfig | None = None,
    hidden_dim: int | None = None,
    seeds: Sequence[int] = (0,),
    audio_root: str | None = None,
    finetune: bool = False,
    bert_cfg=None,
    tokenizer=None,
    encoder_params: Mapping | None = None,
    ftcfg=None,
    device="cuda",
) -> dict:
    """Run one registry experiment end to end; returns test metrics.

    ``special`` handling: ``augment`` expands training sessions with
    SessionAugmenter; ``consistency`` repeats over ``seeds`` and reports
    the accuracy spread; ``param_tuning`` grids lr x hidden (lr only under
    fine-tuning); ``extract_aug`` only materializes the augmented dataset.

    ``audio_root``: resolve audio InputSpecs (en/gr/multi/wv) against this
    directory and embed the actual WAVEFORMS through the frozen SSL conv
    frontend (text/audio_backend.py) instead of the hash fallback.

    ``finetune=True``: train the encoder INSIDE the graph — the
    reference's real ``SingleForwardModel`` setup (AdamW over all params,
    Dementia_challenge_models.py:312-313) via
    :class:`~.finetune.FinetuneTextTrainer`. Text inputs back-prop into
    (per-input) BERT towers; audio inputs enter as frozen features at the
    head. ``tokenizer`` defaults to a corpus-built WordPiece vocab;
    ``bert_cfg`` defaults to a tiny config unless ``encoder_params`` for a
    ported checkpoint (a ``BertEncoder`` state dict) are supplied with a
    matching config. Trainers and the audio backends run on ``device``.
    """
    spec = EXPERIMENTS[name]
    tcfg = tcfg or TextTrainerConfig(num_epochs=5, batch_size=4)

    if audio_root is not None:
        from .audio_backend import audio_backends_for

        auto = audio_backends_for([i.backend for i in spec.inputs], audio_root,
                                  device=device)
        backends = {**auto, **(backends or {})}

    if spec.special == "augment":
        from .augment import SessionAugmenter

        aug = SessionAugmenter(seed=tcfg.seed)
        docs = {str(r["path"]): str(r.get("text", "")) for r in train_rows}
        labels = {str(r["path"]): r["dementia_labels"] for r in train_rows}
        aug_docs, aug_labels, _ = aug.augment_sessions(docs, labels, k=1)
        extra = [{"path": f"AUG{name}", "text": text, "pred_str": text,
                  "dementia_labels": aug_labels[name]}
                 for name, text in aug_docs.items()]
        train_rows = list(train_rows) + extra

    train = rows_to_experiment_data(spec, train_rows, summaries=summaries)
    test = rows_to_experiment_data(spec, test_rows, summaries=summaries)
    if spec.special == "extract_aug":
        return {"n_train": len(train.labels), "n_test": len(test.labels)}

    if finetune:
        return _run_finetune(spec, train, test, backends, tcfg, seeds,
                             bert_cfg, tokenizer, encoder_params, ftcfg, device)

    train_parts = embed_experiment_parts(spec, train, backends)
    test_parts = embed_experiment_parts(spec, test, backends)
    dims = tuple(p.shape[1] for p in train_parts)
    x_train = (np.concatenate(train_parts, axis=1)
               if len(train_parts) > 1 else train_parts[0])
    x_test = (np.concatenate(test_parts, axis=1)
              if len(test_parts) > 1 else test_parts[0])

    if spec.special == "param_tuning":
        best = None
        for lr in (1e-3, 1e-4):
            for hd in (sum(dims), 256):
                m = _fit_once(spec, x_train, train.labels, x_test, test.labels,
                              tcfg, hd, tcfg.seed, lr=lr, dims=dims, device=device)
                if best is None or m["acc"] > best["acc"]:
                    best = {**m, "lr": lr, "hidden_dim": hd}
        return best

    accs, out = [], {}
    for seed in (seeds if spec.special == "consistency" else seeds[:1]):
        out = _fit_once(spec, x_train, train.labels, x_test, test.labels,
                        tcfg, hidden_dim, seed, dims=dims, device=device)
        accs.append(out.get("acc", 0.0))
    if spec.special == "consistency":
        out["acc_spread"] = float(np.max(accs) - np.min(accs))
        out["acc_mean"] = float(np.mean(accs))
    return out


def _run_finetune(spec, train, test, backends, tcfg, seeds, bert_cfg,
                  tokenizer, encoder_params, ftcfg, device) -> dict:
    """End-to-end mode of ``run_experiment``: text towers train in-graph
    (reference AdamW(self.parameters())); audio inputs become frozen
    ``extra`` features at the head."""
    import dataclasses

    from .bert import BertConfigT, WordPieceTokenizer
    from .finetune import (
        FinetuneConfig,
        FinetuneTextTrainer,
        FinetuneTrainerConfig,
    )

    text_ix = [i for i, s in enumerate(spec.inputs) if s.backend in TEXT_BACKENDS]
    audio_ix = [i for i, s in enumerate(spec.inputs)
                if s.backend not in TEXT_BACKENDS]
    assert text_ix, f"{spec.name}: finetune needs at least one text input"
    tr_texts = [train.inputs[i] for i in text_ix]
    te_texts = [test.inputs[i] for i in text_ix]

    def audio_extra(data):
        if not audio_ix:
            return None
        sub = dataclasses.replace(
            spec, inputs=tuple(spec.inputs[i] for i in audio_ix))
        d = ExperimentData(inputs=[data.inputs[i] for i in audio_ix],
                           labels=data.labels)
        parts = embed_experiment_parts(sub, d, backends)
        return np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]

    tr_extra, te_extra = audio_extra(train), audio_extra(test)
    if tokenizer is None:
        tokenizer = WordPieceTokenizer.from_corpus(
            [t for col in tr_texts for t in col])
    base_ft_len = (ftcfg.max_length if ftcfg is not None
                   else FinetuneTrainerConfig().max_length)
    if bert_cfg is None:
        assert encoder_params is None, (
            "encoder_params need the matching bert_cfg")
        # the position table must cover max_length
        bert_cfg = BertConfigT.tiny_for_tests().replace(
            vocab_size=max(len(tokenizer.vocab), 8),
            max_position_embeddings=max(64, base_ft_len))
    fusion = spec.fusion if len(text_ix) >= 2 else "concat"
    assert fusion in ("concat", "cross_attention"), fusion
    cfg = FinetuneConfig(
        bert=bert_cfg, num_text_inputs=len(text_ix),
        extra_dim=0 if tr_extra is None else int(tr_extra.shape[1]),
        regression=spec.task == "regression", fusion=fusion)
    base_ft = ftcfg or FinetuneTrainerConfig(
        num_epochs=tcfg.num_epochs, batch_size=tcfg.batch_size,
        learning_rate=tcfg.learning_rate, lr_schedule=tcfg.lr_schedule,
        seed=tcfg.seed)
    ydt = np.float32 if cfg.regression else np.int32
    y_tr, y_te = train.labels.astype(ydt), test.labels.astype(ydt)

    def fit_once(seed, lr=None) -> dict:
        t = dataclasses.replace(
            base_ft, seed=seed, **({"learning_rate": lr} if lr else {}))
        ftr = FinetuneTextTrainer(cfg, tokenizer, t, device=device)
        ftr.fit(tr_texts, y_tr, extra=tr_extra,
                val_texts_per_input=te_texts, val_labels=y_te,
                val_extra=te_extra, encoder_params=encoder_params)
        return ftr.evaluate(te_texts, y_te, te_extra)

    if spec.special == "param_tuning":
        best = None
        for lr in (2e-5, 1e-4):   # reference grids lr; hidden is the encoder's
            m = fit_once(base_ft.seed, lr=lr)
            if best is None or m["acc"] > best["acc"]:
                best = {**m, "lr": lr}
        return {**best, "mode": "finetune"}

    accs, out = [], {}
    for seed in (seeds if spec.special == "consistency" else seeds[:1]):
        out = fit_once(seed)
        accs.append(out.get("acc", 0.0))
    if spec.special == "consistency":
        out["acc_spread"] = float(np.max(accs) - np.min(accs))
        out["acc_mean"] = float(np.mean(accs))
    return {**out, "mode": "finetune"}


def _fit_once(spec, x_train, y_train, x_test, y_test, tcfg, hidden_dim,
              seed, lr=None, dims=None, device="cuda") -> dict:
    import dataclasses

    cfg = spec.classifier_config(hidden_dim=hidden_dim, dims=dims)
    t = dataclasses.replace(tcfg, seed=seed,
                            **({"learning_rate": lr} if lr else {}))
    tr = TextTrainer(cfg, t, device=device)
    y_tr = y_train.astype(np.float32 if cfg.regression else np.int32)
    y_te = y_test.astype(np.float32 if cfg.regression else np.int32)
    tr.fit(x_train, y_tr, x_test, y_te)
    return tr.evaluate(x_test, y_te)
