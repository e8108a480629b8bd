"""Experiment harnesses: config printing, hyperparameter grid search,
50/50 curriculum training (the port's ``utils/experiments.py``, on the
port's ``Trainer``).

Reference counterparts:
  * ``exp_details`` — startup config dump (federated/src/utils.py:252-265),
  * ``HyparameterFinding{,_2}.py`` — grid over local-training configs
    (federated/src: ~1,560 LoC of copy-pasted trainer clones -> here a
    generic grid driver over TrainerConfig/DACSConfig fields),
  * ``stage1_training_5050`` / ``[EXP]Train50ANDTHEN50.py`` — train on the
    first 50% of speakers, then the other 50%
    (federated/src/federated_main.py:222-263).

Weights are the port's DACSModel state dicts (models/port.py); every run
starts from its own copy of them, so the caller's tensors are never
trained in place.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Mapping, Sequence

import torch

from ..data.splits import CLIENT_SPLITS_ADRESS, filter_by_speakers
from ..models.config import DACSConfig
from ..train.trainer import Trainer, TrainerConfig


def _fresh(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in state_dict.items()}


def exp_details(cfg: DACSConfig, extra: Mapping[str, Any] | None = None) -> str:
    """Pretty-print the experiment configuration at startup."""
    lines = [
        "Experimental details:",
        f"    Backbone        : {cfg.backbone.model_type} "
        f"(L{cfg.backbone.num_hidden_layers}, D{cfg.backbone.hidden_size})",
        f"    Current Stage   : {cfg.stage}",
        f"    Loss Type       : {cfg.ad_loss}",
        f"    GS tau          : {cfg.gs_tau}",
        f"    GRL lambda      : {cfg.lambda_grl}",
        f"    Toggle ratio    : {cfg.toggle_ratio}",
        f"    W_LOSS          : {list(cfg.w_loss)}",
    ]
    for k, v in (extra or {}).items():
        lines.append(f"    {k:<15} : {v}")
    text = "\n".join(lines)
    print(text)
    return text


def grid_search(
    base_cfg: DACSConfig,
    base_tcfg: TrainerConfig,
    grid: Mapping[str, Sequence[Any]],
    state_dict: Mapping[str, torch.Tensor],
    train_examples,
    eval_examples,
    tokenizer,
    metric: str = "eval_wer",
    minimize: bool = True,
    device: str | torch.device = "cuda",
) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """Grid search over DACSConfig / TrainerConfig fields.

    ``grid`` keys name fields of either config (e.g. ``gs_tau``,
    ``learning_rate``, ``batch_size``); any other key raises ``ValueError``.
    Each combo trains from its own copy of the SAME initial ``state_dict``
    and is scored on the eval set. Returns (best, all rows)."""
    dacs_fields = {f.name for f in dataclasses.fields(DACSConfig)}
    tcfg_fields = {f.name for f in dataclasses.fields(TrainerConfig)}
    rows = []
    keys = list(grid)
    for combo in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        unknown = set(overrides) - dacs_fields - tcfg_fields
        if unknown:
            raise ValueError(f"unknown grid fields: {unknown}")
        cfg = base_cfg.replace(
            **{k: v for k, v in overrides.items() if k in dacs_fields})
        tcfg = dataclasses.replace(
            base_tcfg, **{k: v for k, v in overrides.items() if k in tcfg_fields})
        tr = Trainer(cfg, _fresh(state_dict), train_examples, eval_examples,
                     tokenizer, tcfg, device=device)
        tr.train()
        row = {**overrides, **tr.evaluate()}
        rows.append(row)
        print(json.dumps(row))
    best = min(rows, key=lambda r: r[metric]) if minimize else \
        max(rows, key=lambda r: r[metric])
    return best, rows


def train_50_50(
    cfg: DACSConfig,
    tcfg: TrainerConfig,
    state_dict: Mapping[str, torch.Tensor],
    train_examples,
    eval_examples,
    tokenizer,
    first_speakers: Sequence[str] | None = None,
    second_speakers: Sequence[str] | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """50/50 curriculum: train on the first half of speakers, then continue
    on the other half (reference stage1_training_5050). Defaults to the
    ADReSS public / public2 speaker halves. Returns the trained state dict."""
    first = filter_by_speakers(
        train_examples,
        first_speakers if first_speakers is not None else CLIENT_SPLITS_ADRESS["public"])
    second = filter_by_speakers(
        train_examples,
        second_speakers if second_speakers is not None else CLIENT_SPLITS_ADRESS["public2"])
    tr1 = Trainer(cfg, _fresh(state_dict), first, eval_examples, tokenizer, tcfg,
                  device=device)
    state = tr1.train()
    tr2 = Trainer(cfg, _fresh(state.model.state_dict()), second, eval_examples,
                  tokenizer, tcfg, device=device)
    return _fresh(tr2.train().model.state_dict())
