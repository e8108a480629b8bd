"""Method-family recipes, serving part (the port's ``models/recipes.py``).

``dacs``, ``toggle_more`` and ``grl`` share :class:`DACSModel` and differ in
the streams that greedy decode and the AD vote consume. ``single_toggle``
and ``fsm`` use their own models and wait for their slice; losses and
trainable-parameter predicates come with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .config import DACSConfig
from .dacs import DACSModel


@dataclasses.dataclass(frozen=True)
class Recipe:
    """``eval_streams(outputs, cfg) -> (ctc_logits, ad_logits)``."""

    name: str
    make_model: Callable[..., Any]           # (cfg, dtype)
    eval_streams: Callable[[Any, DACSConfig], tuple[torch.Tensor, torch.Tensor]]


def _dacs_eval_streams(out, cfg):
    if cfg.stage == 2:
        return out.logits, out.dementia_logits_ad
    return out.logits_unmask, out.dementia_logits_unmask


def _toggle_more_eval_streams(out, cfg):
    if cfg.stage == 1:
        return out.logits_unmask, out.dementia_logits_unmask
    return out.logits, out.dementia_logits_ad


def _make_dacs(cfg: DACSConfig, dtype: torch.dtype = torch.float32) -> DACSModel:
    return DACSModel(cfg, dtype)


DACS = Recipe("dacs", _make_dacs, _dacs_eval_streams)
TOGGLE_MORE = Recipe("toggle_more", _make_dacs, _toggle_more_eval_streams)
GRL = Recipe("grl", _make_dacs,
             lambda out, cfg: (out.logits_unmask, out.dementia_logits_unmask))

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
