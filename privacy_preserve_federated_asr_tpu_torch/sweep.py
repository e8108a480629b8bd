"""Sweep drivers: one-command replays of the reference's ``run_*.sh`` grids
(the port's ``sweep.py``).

The reference ships 9 shell sweep scripts that loop ``python <driver>`` over
hand-written bash arrays. Here each grid is a named preset over typed config
fields, executed in-process (no process spawning) and appended to a
``results.csv`` in the reference's append-one-row-per-config shape
(centralized/pred_AD_svm.py:256-268).

Reference counterparts:
  * ``federated/src/run_HyperparameterTune.sh`` + ``HyparameterFinding{,_2}.py``
    -> :func:`sweep_asr` (grid over DACSConfig/TrainerConfig fields).
  * ``centralized/run_dementia_BERTparamsTuning.sh`` (lr x patience x
    scheduler x epochs over text models) -> :func:`sweep_text`
    preset ``bert-params-tuning``.
  * ``centralized/run_dementia_BERT.sh`` (embedding-backend sweep, epochs 5)
    -> preset ``bert``; ``run_dementia_BERT_regression.sh`` -> preset
    ``bert-regression``.
  * ``centralized/run_dementia_SVM.sh`` (SVM over text-embedding files /
    modes) -> :func:`sweep_svm` (pooling x mode grid).
  * ``centralized/run_Extract_feat.sh`` (extraction across model families)
    -> ``cli extract`` already covers single runs; :func:`sweep_asr` with a
    ``model_type`` axis covers the family loop.
"""

from __future__ import annotations

import csv
import itertools
import json
import os
from typing import Any, Callable, Mapping, Sequence

# ---------------------------------------------------------------------------
# presets


def _bert_params_tuning() -> dict[str, Sequence]:
    # run_dementia_BERTparamsTuning.sh stage-1 arrays (active, uncommented
    # values): lrs x patiences x lr_schedulers x epochs on mbert_sentence
    return {
        "experiment": ["sentence_1input"],
        "learning_rate": [1e-3, 1e-4, 2e-5, 1e-5, 1e-6, 5e-7, 1e-7],
        "early_stopping_patience": [3, 4, 5, 6, 7, 8, 9],
        "lr_schedule": ["exp"],
        "num_epochs": [5, 10, 20],
    }


TEXT_PRESETS: dict[str, Callable[[], dict[str, Sequence]]] = {
    "bert-params-tuning": _bert_params_tuning,
    # run_dementia_BERT.sh stage 2: backend sweep at epochs 5
    "bert": lambda: {
        "experiment": ["sentence_1input", "sentence_text", "session_1input",
                       "session_text"],
        "num_epochs": [5],
    },
    # run_dementia_BERT_regression.sh: same sweep, regression task
    "bert-regression": lambda: {
        "experiment": ["sentence_1input_regression"],
        "num_epochs": [5],
    },
}

ASR_PRESETS: dict[str, Callable[[], dict[str, Sequence]]] = {
    # run_HyperparameterTune.sh / HyparameterFinding{,_2}.py: local-training
    # knobs (the .sh drives -epo/-lr/--train_batch_size per invocation)
    "hyperparameter-tune": lambda: {
        "learning_rate": [1e-5, 1e-4],
        "num_epochs": [5, 10],
        "batch_size": [8, 16],
    },
}

SVM_PRESETS: dict[str, Callable[[], dict[str, Sequence]]] = {
    # run_dementia_SVM.sh: pred_AD_svm over modes; -sq pooling axis from
    # pred_AD_svm.py's CLI (min/max/mean/median)
    "dementia-svm": lambda: {
        "pooling": ["min", "max", "mean", "median"],
        "mode": ["audio"],
    },
}


def parse_grid(tokens: Sequence[str]) -> dict[str, list]:
    """Parse ``key=v1,v2,...`` CLI tokens with int/float/str inference."""

    def conv(s: str):
        for t in (int, float):
            try:
                return t(s)
            except ValueError:
                continue
        return s

    grid: dict[str, list] = {}
    for tok in tokens:
        if "=" not in tok:
            raise ValueError(f"grid token {tok!r} is not key=v1,v2,...")
        k, vs = tok.split("=", 1)
        grid[k] = [conv(v) for v in vs.split(",")]
    return grid


def _combos(grid: Mapping[str, Sequence]) -> list[dict[str, Any]]:
    keys = list(grid)
    return [dict(zip(keys, c)) for c in itertools.product(*(grid[k] for k in keys))]


def append_results_csv(path: str, row: Mapping[str, Any]) -> None:
    """Append one sweep row (reference results.csv shape: header once,
    one row per config, pred_AD_svm.py:256-268)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    exists = os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if not exists:
            w.writeheader()
        w.writerow({k: (json.dumps(v) if isinstance(v, (list, dict)) else v)
                    for k, v in row.items()})


# ---------------------------------------------------------------------------
# runners


def sweep_text(
    grid: Mapping[str, Sequence],
    train_rows: Sequence[Mapping],
    test_rows: Sequence[Mapping],
    results_csv: str | None = None,
    seed: int = 0,
    device="cuda",
) -> list[dict[str, Any]]:
    """Text-branch sweep: each combo = one registry experiment trained with
    the combo's TextTrainerConfig overrides (``finetune=true`` fine-tunes the
    encoder end to end, ``max_length`` riding along), on ``device``."""
    import dataclasses

    from .text.classifier import TextTrainerConfig
    from .text.experiments import run_experiment

    tcfg_fields = {f.name for f in dataclasses.fields(TextTrainerConfig)}
    rows = []
    for combo in _combos(grid):
        name = combo.get("experiment", "sentence_1input")
        overrides = {k: v for k, v in combo.items() if k in tcfg_fields}
        # finetune=true sweeps the END-TO-END mode (encoder in the graph,
        # the reference's actual training setup); max_length rides along
        special = {"experiment", "finetune", "max_length"}
        unknown = set(combo) - tcfg_fields - special
        if unknown:
            raise ValueError(f"unknown text sweep fields: {sorted(unknown)}")
        tcfg = TextTrainerConfig(seed=seed, **overrides)
        ft_kw = {}
        if str(combo.get("finetune", "")).lower() in ("true", "1", "yes"):
            from .text.finetune import FinetuneTrainerConfig

            # carry EVERY TextTrainerConfig override into the finetune
            # config (the two dataclasses share these field names) — a
            # dropped weight_decay/patience axis would silently sweep
            # nothing
            ft_kw = {"finetune": True, "ftcfg": FinetuneTrainerConfig(
                num_epochs=tcfg.num_epochs, batch_size=tcfg.batch_size,
                learning_rate=tcfg.learning_rate,
                lr_schedule=tcfg.lr_schedule, seed=seed,
                weight_decay=tcfg.weight_decay,
                early_stopping_patience=tcfg.early_stopping_patience,
                max_length=int(combo.get("max_length", 64)))}
        elif "max_length" in combo:
            raise ValueError(
                "max_length only applies with finetune=true (the frozen "
                "path embeds full documents, no token window)")
        metrics = run_experiment(name, train_rows, test_rows, tcfg=tcfg, device=device,
                                 **ft_kw)
        row = {**combo, **{k: v for k, v in metrics.items()
                           if isinstance(v, (int, float, str))}}
        rows.append(row)
        if results_csv:
            append_results_csv(results_csv, row)
        print(json.dumps(row), flush=True)
    return rows


def sweep_asr(
    grid: Mapping[str, Sequence],
    base_cfg,
    base_tcfg,
    state_dict,
    train_examples,
    eval_examples,
    tokenizer,
    results_csv: str | None = None,
    metric: str = "eval_wer",
    device="cuda",
) -> list[dict[str, Any]]:
    """ASR-side sweep over DACSConfig/TrainerConfig fields; delegates each
    combo to utils.experiments.grid_search's per-combo train+score."""
    from .utils.experiments import grid_search

    best, rows = grid_search(base_cfg, base_tcfg, dict(grid), state_dict,
                             train_examples, eval_examples, tokenizer,
                             metric=metric, device=device)
    if results_csv:
        for row in rows:
            append_results_csv(results_csv, row)
    print(json.dumps({"best": best}), flush=True)
    return rows


def sweep_svm(
    grid: Mapping[str, Sequence],
    train_rows: Sequence[Mapping],
    test_rows: Sequence[Mapping],
    spk2label: Mapping[str, int],
    results_csv: str | None = None,
    **svm_kwargs,
) -> list[dict[str, Any]]:
    """SVM sweep (pooling x mode x ...) over one extraction's pickles; the
    port's ``predict_ad_svm`` (``svm_kwargs`` may carry its ``device``)."""
    from .evaluation import predict_ad_svm

    rows = []
    for combo in _combos(grid):
        m = predict_ad_svm(
            train_rows, test_rows, spk2label,
            pooling=combo.get("pooling", "mean"),
            masked=bool(combo.get("masked", False)),
            mode=combo.get("mode", "audio"),
            results_csv=results_csv,
            title="_".join(f"{k}-{v}" for k, v in combo.items()),
            **svm_kwargs)
        row = {**combo, **m}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows
