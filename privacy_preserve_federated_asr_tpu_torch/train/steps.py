"""Train and eval steps (the port's ``train/steps.py``).

Each ``make_*`` returns a step function over a :class:`DACSTrainState` (the
JAX steps are pure functions of (state, batch); here the state is updated in
place) that returns the JAX step's metrics dict, ``grad_norm`` included, as
device scalars: nothing in a step waits for the card.

Stage routing is the recipe's: the loss, the trainable parameters (set on
the model by ``make_optimizer``) and the modes, ``model.train()`` with the
backbone in ``eval()`` where the recipe freezes it (dropout off, the
reference's ``.eval()`` on frozen modules).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..data.collate import Batch
from ..models.backbone import feat_extract_output_lengths
from ..models.config import DACSConfig
from ..models.dacs import DACSModel
from ..models.recipes import Recipe, get_recipe
from ..ops.decode import ad_vote, greedy_ids
from .train_state import DACSTrainState


@dataclass
class DeviceBatch:
    """Tensor view of a host :class:`Batch` on the device."""

    input_values: torch.Tensor
    input_lengths: torch.Tensor
    labels: torch.Tensor
    label_lengths: torch.Tensor
    dementia_labels: torch.Tensor
    sample_mask: torch.Tensor

    @classmethod
    def from_host(cls, b: Batch, device) -> "DeviceBatch":
        def dev(x):
            return torch.from_numpy(x).to(device, non_blocking=True)

        return cls(dev(b.input_values), dev(b.input_lengths), dev(b.labels),
                   dev(b.label_lengths), dev(b.dementia_labels), dev(b.sample_mask))


@dataclass
class FeatureBatch:
    """A batch of CACHED conv-frontend outputs for stage-0 training."""

    features: torch.Tensor         # [B, T', C_conv] FeatureEncoder output
    frame_lengths: torch.Tensor    # [B]
    labels: torch.Tensor           # [B, L]
    label_lengths: torch.Tensor    # [B]
    dementia_labels: torch.Tensor  # [B]
    sample_mask: torch.Tensor      # [B]


def set_train_modes(model: DACSModel, recipe: Recipe, stage: int) -> None:
    model.train()
    if not recipe.backbone_trains(stage):
        model.backbone.eval()


def _apply_update(state: DACSTrainState, loss: torch.Tensor, metrics: dict) -> dict:
    loss.backward()
    grad_norm = state.tx.step()
    state.step += 1
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = grad_norm
    return metrics


def make_train_step(cfg: DACSConfig, aux_metrics: bool = False,
                    recipe: Recipe | None = None
                    ) -> Callable[[DACSTrainState, DeviceBatch], dict]:
    """The full-forward train step (waveforms in), for every recipe/stage."""
    recipe = recipe or get_recipe(cfg.method)
    need_masks = aux_metrics or recipe.uses_masks(cfg.stage)

    def train_step(state: DACSTrainState, batch: DeviceBatch) -> dict:
        model = state.model
        set_train_modes(model, recipe, cfg.stage)
        out = model(batch.input_values, batch.input_lengths, generator=state.gumbel,
                    seed_generator=state.seeds, need_masks=need_masks)
        loss, metrics = recipe.loss(out, batch.labels, batch.label_lengths,
                                    batch.dementia_labels, cfg, model,
                                    batch.sample_mask, aux_metrics)
        return _apply_update(state, loss, metrics)

    return train_step


def frontend_forward_fn(model: DACSModel):
    """Conv-frontend-only forward -> (features [B, T', C], frame_lengths):
    the stage-0 cache-building primitive."""
    bcfg = model.cfg.backbone

    @torch.no_grad()
    def fwd(input_values: torch.Tensor, input_lengths: torch.Tensor):
        fl = feat_extract_output_lengths(bcfg, input_lengths)
        return model.backbone.feature_extractor(input_values), fl

    return fwd


@dataclass
class HiddenBatch:
    """A batch of CACHED encoder outputs for the frozen-encoder stages (1/2):
    the head-only train step consumes these instead of waveforms."""

    hidden_states: torch.Tensor    # [B, T', D] backbone output (before the final dropout)
    frame_lengths: torch.Tensor    # [B]
    labels: torch.Tensor           # [B, L]
    label_lengths: torch.Tensor    # [B]
    dementia_labels: torch.Tensor  # [B]
    sample_mask: torch.Tensor      # [B]


def backbone_forward_fn(model: DACSModel):
    """Deterministic backbone-only forward -> (h [B, T', D], frame_lengths):
    the cache-building primitive of the Trainer's ``cache_encoder`` and the
    federated engine's head-only rounds. The backbone runs in eval mode
    (no dropout, no SpecAugment), its mode restored afterwards."""
    bcfg = model.cfg.backbone

    @torch.no_grad()
    def fwd(input_values: torch.Tensor, input_lengths: torch.Tensor):
        t = feat_extract_output_lengths(bcfg, input_values.shape[1])
        fl = feat_extract_output_lengths(bcfg, input_lengths)
        fm = (torch.arange(t, device=input_values.device)[None, :]
              < fl[:, None]).to(torch.int32)
        was_training = model.backbone.training
        model.backbone.eval()
        try:
            return model.backbone(input_values, fm), fl
        finally:
            model.backbone.train(was_training)

    return fwd


def gather_hidden(h, fl, labels, label_lengths, dementia_labels, idx: torch.Tensor,
                  row_mask: torch.Tensor | None = None) -> HiddenBatch:
    """Row-gather a HiddenBatch from cached encoder outputs; idx == -1 marks
    batch-padding rows (frame and label lengths 0, labels -100, sample mask
    0). ``row_mask`` carries the source rows' own sample mask where the
    cache itself holds padding rows (the federated engine's per-client
    data)."""
    safe = idx.clamp(0, h.shape[0] - 1)
    mask = idx >= 0
    sm = mask.float()
    if row_mask is not None:
        sm = sm * row_mask[safe]

    def keep(x, fill):
        g = x[safe]
        m = mask.view(-1, *([1] * (g.dim() - 1)))
        return torch.where(m, g, torch.full_like(g, fill))

    return HiddenBatch(hidden_states=h[safe], frame_lengths=keep(fl, 0),
                       labels=keep(labels, -100), label_lengths=keep(label_lengths, 0),
                       dementia_labels=keep(dementia_labels, 0), sample_mask=sm)


def gather_features(feats, fl, labels, label_lengths, dementia_labels,
                    idx: torch.Tensor) -> FeatureBatch:
    """Row-gather a FeatureBatch from cached conv-frontend outputs (the
    semantics of :func:`gather_hidden`)."""
    hb = gather_hidden(feats, fl, labels, label_lengths, dementia_labels, idx)
    return FeatureBatch(features=hb.hidden_states, frame_lengths=hb.frame_lengths,
                        labels=hb.labels, label_lengths=hb.label_lengths,
                        dementia_labels=hb.dementia_labels, sample_mask=hb.sample_mask)


def make_feature_train_step(cfg: DACSConfig, aux_metrics: bool = False,
                            recipe: Recipe | None = None
                            ) -> Callable[[DACSTrainState, FeatureBatch], dict]:
    """Stage-0 train step over cached conv-frontend outputs
    (``DACSModel.apply_from_features``). Everything stochastic (feat-proj
    dropout, SpecAugment, encoder dropouts, final dropout, Gumbel) sits
    after the cache point and stays live."""
    recipe = recipe or get_recipe(cfg.method)
    need_masks = aux_metrics or recipe.uses_masks(cfg.stage)

    def train_step(state: DACSTrainState, batch: FeatureBatch) -> dict:
        model = state.model
        set_train_modes(model, recipe, cfg.stage)
        frame_mask = _frame_mask(batch.frame_lengths, batch.features.shape[1])
        out = model.apply_from_features(batch.features, frame_mask, batch.frame_lengths,
                                        generator=state.gumbel,
                                        seed_generator=state.seeds,
                                        need_masks=need_masks)
        loss, metrics = recipe.loss(out, batch.labels, batch.label_lengths,
                                    batch.dementia_labels, cfg, model,
                                    batch.sample_mask, aux_metrics)
        return _apply_update(state, loss, metrics)

    return train_step


def _frame_mask(frame_lengths: torch.Tensor, t: int) -> torch.Tensor:
    return (torch.arange(t, device=frame_lengths.device)[None, :]
            < frame_lengths[:, None]).to(torch.int32)


def make_hidden_train_step(cfg: DACSConfig, aux_metrics: bool = False,
                           recipe: Recipe | None = None
                           ) -> Callable[[DACSTrainState, HiddenBatch], dict]:
    """Train step over cached encoder outputs (``DACSModel.apply_heads``).

    Valid exactly when the backbone is frozen AND deterministic (the DACS
    stage-1/2 semantics: the reference freezes the encoder and calls
    ``.eval()`` on it), so ``backbone(x)`` is a constant per utterance. The
    final dropout and the Gumbel noise stay live per step (they sit after
    the cache point)."""
    recipe = recipe or get_recipe(cfg.method)
    assert not recipe.backbone_trains(cfg.stage), \
        "cached-encoder training needs a frozen backbone"
    need_masks = aux_metrics or recipe.uses_masks(cfg.stage)

    def train_step(state: DACSTrainState, batch: HiddenBatch) -> dict:
        model = state.model
        set_train_modes(model, recipe, cfg.stage)
        fm = _frame_mask(batch.frame_lengths, batch.hidden_states.shape[1])
        out = model.apply_heads(batch.hidden_states, fm, batch.frame_lengths,
                                generator=state.gumbel, need_masks=need_masks)
        loss, metrics = recipe.loss(out, batch.labels, batch.label_lengths,
                                    batch.dementia_labels, cfg, model,
                                    batch.sample_mask, aux_metrics)
        return _apply_update(state, loss, metrics)

    return train_step


def make_multitask_train_step(cfg: DACSConfig, aux_metrics: bool = False
                              ) -> Callable[[DACSTrainState, DeviceBatch, torch.Tensor,
                                             torch.Tensor], dict]:
    """Train step of the N-best multitask model (``cfg.num_lms > 1``): head i
    trains on pseudo-transcript set i, the CTC losses averaged over the
    heads (``federated/multitask.py::multitask_loss``; reference
    Data2VecAudioForCTCMultitask, ASRLocalUpdate_Multitask.py). Takes the
    batch with ``labels_stack [N, B, L]`` and ``label_lengths_stack
    [N, B]``; the freezing is the DACS recipe's (lm_heads train at stage 0).
    ``aux_metrics`` as in :func:`make_train_step`."""
    from ..federated.multitask import multitask_loss

    recipe = get_recipe(cfg.method)
    need_masks = aux_metrics or recipe.uses_masks(cfg.stage)

    def train_step(state: DACSTrainState, batch: DeviceBatch,
                   labels_stack: torch.Tensor, label_lengths_stack: torch.Tensor) -> dict:
        model = state.model
        set_train_modes(model, recipe, cfg.stage)
        out = model(batch.input_values, batch.input_lengths, generator=state.gumbel,
                    seed_generator=state.seeds, need_masks=need_masks)
        loss, metrics = multitask_loss(out, labels_stack, label_lengths_stack,
                                       batch.dementia_labels, cfg, model.similar_fc.weight,
                                       batch.sample_mask, aux_metrics)
        return _apply_update(state, loss, metrics)

    return train_step


def _eval_from_outputs(out, model, batch, cfg: DACSConfig, recipe: Recipe | None = None):
    recipe = recipe or get_recipe(cfg.method)
    loss, _ = recipe.loss(out, batch.labels, batch.label_lengths, batch.dementia_labels,
                          cfg, model, batch.sample_mask, True)
    ctc_logits, ad_logits = recipe.eval_streams(out, cfg)
    pred_ids = greedy_ids(ctc_logits, out.frame_mask, cfg.backbone.pad_token_id)
    ad_pred = ad_vote(ad_logits, out.frame_mask)
    return loss, pred_ids, ad_pred


def make_eval_step(cfg: DACSConfig, recipe: Recipe | None = None):
    """Deterministic forward + full metrics: ``eval_step(model, batch) ->
    (loss, pred_ids, ad_pred)``; the Gumbel noise comes from a generator
    reseeded with 0 per batch, as the JAX step's fixed ``PRNGKey(0)``."""
    recipe = recipe or get_recipe(cfg.method)

    @torch.no_grad()
    def eval_step(model: DACSModel, batch: DeviceBatch):
        model.eval()
        gen = torch.Generator(batch.input_values.device).manual_seed(0)
        out = model(batch.input_values, batch.input_lengths, generator=gen)
        return _eval_from_outputs(out, model, batch, cfg, recipe)

    return eval_step


def make_hidden_eval_step(cfg: DACSConfig, recipe: Recipe | None = None):
    """:func:`make_eval_step` over cached encoder outputs (the validity
    condition of :func:`make_hidden_train_step`)."""
    recipe = recipe or get_recipe(cfg.method)

    @torch.no_grad()
    def eval_step(model: DACSModel, batch: HiddenBatch):
        model.eval()
        h = batch.hidden_states
        gen = torch.Generator(h.device).manual_seed(0)
        out = model.apply_heads(h, _frame_mask(batch.frame_lengths, h.shape[1]),
                                batch.frame_lengths, generator=gen)
        return _eval_from_outputs(out, model, batch, cfg, recipe)

    return eval_step
