"""Method-family recipes (the port's ``models/recipes.py``).

``dacs``, ``toggle_more`` and ``grl`` share :class:`DACSModel`; a
:class:`Recipe` bundles what stage- and method-routed training and serving
need: the loss, the per-stage trainable-parameter predicate, whether the
encoder trains, the streams greedy decode and the AD vote consume, and what
extraction dumps per utterance.
``single_toggle`` and ``fsm`` use their own models and wait for their
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .config import DACSConfig
from .dacs import DACSModel
from .objectives import dacs_loss, grl_multitask_loss


@dataclasses.dataclass(frozen=True)
class Recipe:
    """``loss(outputs, labels, label_lengths, dementia_labels, cfg, model,
    sample_mask, aux_metrics) -> (final_loss, metrics)``;
    ``trainable(stage)`` a predicate on a parameter's dotted-name path;
    ``uses_masks(stage)`` whether the stage's loss reads the Gumbel masks;
    ``eval_streams(outputs, cfg) -> (ctc_logits, ad_logits)``;
    ``extract_streams(outputs, cfg) -> (ctc_logits, ad_logits, lm_mask |
    None, ad_mask | None)``, what the method's reference eval script dumps
    (the ``evaluation/extract.py`` row schema)."""

    name: str
    stages: tuple[int, ...]
    make_model: Callable[..., Any]           # (cfg, dtype, param_dtype)
    loss: Callable[..., tuple[torch.Tensor, dict]]
    trainable: Callable[[int], Callable[[tuple[str, ...]], bool]]
    backbone_trains: Callable[[int], bool]
    uses_masks: Callable[[int], bool]
    eval_streams: Callable[[Any, DACSConfig], tuple[torch.Tensor, torch.Tensor]]
    extract_streams: Callable[[Any, DACSConfig], tuple]
    # frozen-forward caching (the trainer's cache_frontend) is wired for the
    # DACS model only
    supports_cache: bool = False


def stage_trainable_predicate(stage: int) -> Callable[[tuple[str, ...]], bool]:
    """Path -> trainable? for the DACS stages.

    stage 0 (ASR fine-tune): the encoder minus the conv feature extractor
      (always frozen: reference ``freeze_feature_encoder``) + lm_head;
    stage 1 (AD classifier): dementia_head;
    stage 2 (toggling network): arbitrator;
    stage 3 (toggle_more joint fine-tune): arbitrator + lm_head + dementia_head.
    """

    def pred(path: tuple[str, ...]) -> bool:
        if path[0] == "backbone":
            return stage == 0 and path[1] != "feature_extractor"
        head = path[0]
        if stage == 0:
            return head == "lm_head"
        if stage == 1:
            return head == "dementia_head"
        if stage == 2:
            return head == "arbitrator"
        if stage == 3:
            return head in ("arbitrator", "lm_head", "dementia_head")
        raise ValueError(f"unknown stage {stage}")

    return pred


def _dacs_loss(out, labels, label_lengths, dementia_labels, cfg, model,
               sample_mask, aux_metrics):
    return dacs_loss(out, labels, label_lengths, dementia_labels, cfg,
                     model.similar_fc.weight, sample_mask, aux_metrics=aux_metrics)


def _dacs_eval_streams(out, cfg):
    if cfg.stage == 2:
        return out.logits, out.dementia_logits_ad
    return out.logits_unmask, out.dementia_logits_unmask


def _dacs_extract_streams(out, cfg):
    """eval_toggle_GS.py / eval_toggle_more.py row: both masks and the
    AD-masked dementia logits."""
    return out.logits, out.dementia_logits_ad, out.lm_mask, out.ad_mask


def _toggle_more_eval_streams(out, cfg):
    if cfg.stage == 1:
        return out.logits_unmask, out.dementia_logits_unmask
    return out.logits, out.dementia_logits_ad


def _make_dacs(cfg: DACSConfig, dtype: torch.dtype = torch.float32,
               param_dtype: torch.dtype | None = None) -> DACSModel:
    return DACSModel(cfg, dtype, param_dtype)


def _grl_trainable(stage: int):
    """The reference GRL model trains everything but the conv feature
    extractor; the DACS-only heads (arbitrator, similar_fc) stay frozen."""

    def pred(path: tuple[str, ...]) -> bool:
        if path[0] == "backbone":
            return path[1] != "feature_extractor"
        return path[0] in ("lm_head", "dementia_head")

    return pred


def _grl_loss(out, labels, label_lengths, dementia_labels, cfg, model,
              sample_mask, aux_metrics):
    del model, aux_metrics
    return grl_multitask_loss(out, labels, label_lengths, dementia_labels, cfg,
                              reverse=cfg.grl_reverse, sample_mask=sample_mask)


DACS = Recipe(
    name="dacs", stages=(0, 1, 2), make_model=_make_dacs, loss=_dacs_loss,
    trainable=stage_trainable_predicate,
    backbone_trains=lambda stage: stage == 0,
    uses_masks=lambda stage: stage in (2, 3),
    eval_streams=_dacs_eval_streams, extract_streams=_dacs_extract_streams,
    supports_cache=True)
TOGGLE_MORE = Recipe(
    name="toggle_more", stages=(1, 2, 3), make_model=_make_dacs, loss=_dacs_loss,
    trainable=stage_trainable_predicate,
    backbone_trains=lambda stage: False,  # only heads train in toggle_more
    uses_masks=lambda stage: stage in (2, 3),
    eval_streams=_toggle_more_eval_streams, extract_streams=_dacs_extract_streams,
    supports_cache=True)
GRL = Recipe(
    name="grl", stages=(0, 1, 2), make_model=_make_dacs, loss=_grl_loss,
    trainable=_grl_trainable, backbone_trains=lambda stage: True,
    uses_masks=lambda stage: False,
    eval_streams=lambda out, cfg: (out.logits_unmask, out.dementia_logits_unmask),
    # eval.py / eval_finetune.py rows carry no mask columns
    extract_streams=lambda out, cfg: (out.logits_unmask, out.dementia_logits_unmask,
                                      None, None))

RECIPES: dict[str, Recipe] = {r.name: r for r in (DACS, TOGGLE_MORE, GRL)}
_LATER = ("single_toggle", "fsm")


def get_recipe(method: str) -> Recipe:
    if method in _LATER:
        raise NotImplementedError(f"method {method!r} is not ported yet")
    try:
        return RECIPES[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; known: {sorted(RECIPES)}") from None


def validate_stage(cfg: DACSConfig) -> None:
    r = get_recipe(cfg.method)
    if cfg.stage not in r.stages:
        raise ValueError(f"method {r.name!r} supports stages {r.stages}, got {cfg.stage}")
