"""DACS method-family variants: single-toggle and FSM models (the port's
``models/variants.py``).

Each is one ``nn.Module`` over the shared backbone (``make_backbone``: any
SSL family or SEW-D), with the call signature of :class:`DACSModel`, so the
train steps, the serving engine and extraction drive every method alike.

* :class:`SingleToggleModel` — the arbitrator is Linear(D -> 2D): only the
  lm mask exists (reference centralized/trainer_data2vec_toggle.py:53-334).
  Stage 1 trains the AD head on the unmasked stream, stages 2/3
  ctc(lm_masked) + the gradient-reversed AD CE of the lm stream. Its
  Gumbel noise is injected (``gumbel_noise=(lm,)``) or drawn from
  ``generator``.

* :class:`FSMModel` — two feature-scoring machines ``lm_fsm`` /
  ``dementia_fsm`` (Linear(D -> D)); masks = sigmoid(score) >= threshold
  (hard, reference centralized/trainer_data2vec_5st.py:242-250), and a GRL
  branch that re-masks the gradient-reversed embedding for the ``lm_grl`` /
  ``dementia_grl`` heads (:275-296). Six stage configurations (:372-391).
  Reproduced quirk: the reference's straight-through hack
  ``mask + 0 * lm_fsm(mask)`` contributes exactly zero gradient, so the
  masks are detached and the machines' weights get a zero gradient (they
  still take AdamW's weight decay where they train, as in the JAX package).
  ``similar_fc`` (the AM-softmax projection) has no use in the forward.

``gumbel_draws`` on each model class is how many Gumbel tensors of the
mask-score shape ``[B, T, D, 2]`` its forward takes (DACS 2, single-toggle
1, FSM 0), for the callers that draw or inject the noise themselves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ctc import ctc_loss
from ..ops.grl import gradient_reversal
from ..ops.gumbel import gumbel_softmax, sample_gumbel
from ..ops.losses import am_softmax_loss, fsm_attention_loss, recall_family_loss
from .backbone import Linear, feat_extract_output_lengths
from .config import DACSConfig
from .factory import make_backbone
from .objectives import masked_time_mean


def _encode(model: nn.Module, input_values: torch.Tensor,
            input_lengths: torch.Tensor | None,
            seed_generator: torch.Generator | None):
    """Frame mask and lengths, and the backbone output after the final
    dropout (the first half of every variant's forward)."""
    bb = model.cfg.backbone
    b, n = input_values.shape
    t_frames = feat_extract_output_lengths(bb, n)
    if input_lengths is None:
        input_lengths = torch.full((b,), n, dtype=torch.int32, device=input_values.device)
    frame_lengths = feat_extract_output_lengths(bb, input_lengths)
    frame_mask = (torch.arange(t_frames, device=input_values.device)[None, :]
                  < frame_lengths[:, None]).to(torch.int32)
    h = model.backbone(input_values, frame_mask, seed_generator=seed_generator)
    return model.dropout(h), frame_mask, frame_lengths


def _ctc(logits: torch.Tensor, out, labels, label_lengths, cfg: DACSConfig) -> torch.Tensor:
    bcfg = cfg.backbone
    return ctc_loss(F.log_softmax(logits.float(), dim=-1), labels, out.frame_lengths,
                    label_lengths, blank_id=bcfg.pad_token_id,
                    reduction=bcfg.ctc_loss_reduction, zero_infinity=bcfg.ctc_zero_infinity)


class _Variant(nn.Module):
    """Backbone, final dropout and the Linear factory of a variant model;
    ``dtype`` / ``param_dtype`` / ``remat`` as in :class:`DACSModel`."""

    def __init__(self, cfg: DACSConfig, dtype: torch.dtype, param_dtype: torch.dtype | None,
                 remat: bool):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self._param_dtype = dtype if param_dtype is None else param_dtype
        self.backbone = make_backbone(cfg.backbone, dtype, self._param_dtype)
        self.backbone.encoder.remat = remat
        self.dropout = nn.Dropout(cfg.backbone.final_dropout)

    def _linear(self, d_out: int, bias: bool = True) -> Linear:
        return Linear(self.cfg.hidden_size, d_out, bias=bias, dtype=self.dtype,
                      param_dtype=self._param_dtype)


# ---------------------------------------------------------------------------
# single-toggle
# ---------------------------------------------------------------------------

@dataclass
class SingleToggleOutputs:
    hidden_states: torch.Tensor           # [B, T, D]
    logits: torch.Tensor                  # lm_head(lm_mask * h)
    dementia_logits_unmask: torch.Tensor  # ad_head(h)
    dementia_logits_lm: torch.Tensor      # ad_head(lm_mask * h)
    lm_mask: torch.Tensor                 # [B, T, D] hard 0/1
    lm_score: torch.Tensor                # [B, T, D, 2] fp32
    frame_mask: torch.Tensor
    frame_lengths: torch.Tensor


class SingleToggleModel(_Variant):
    gumbel_draws = 1

    def __init__(self, cfg: DACSConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None, remat: bool = False):
        super().__init__(cfg, dtype, param_dtype, remat)
        self.arbitrator = self._linear(2 * cfg.hidden_size)
        self.lm_head = self._linear(cfg.backbone.vocab_size)
        self.dementia_head = self._linear(cfg.num_ad_classes)

    def forward(self, input_values: torch.Tensor,
                input_lengths: torch.Tensor | None = None,
                gumbel_noise: tuple[torch.Tensor] | None = None,
                generator: torch.Generator | None = None,
                seed_generator: torch.Generator | None = None,
                need_masks: bool = True) -> SingleToggleOutputs:
        """``gumbel_noise = (lm,)`` injects the noise, else ``generator``
        draws it; ``need_masks`` is accepted for the DACS signature (every
        single-toggle loss reads the mask)."""
        del need_masks
        c = self.cfg
        d = c.hidden_size
        h, frame_mask, frame_lengths = _encode(self, input_values, input_lengths,
                                               seed_generator)
        all_score = self.arbitrator(h).float()
        lm_score = torch.stack((all_score[..., :d], all_score[..., d:]), dim=-1)
        if gumbel_noise is not None:
            (noise,) = gumbel_noise
        elif generator is not None:
            noise = sample_gumbel(lm_score.shape, generator, h.device)
        else:
            raise ValueError("SingleToggleModel needs `gumbel_noise` or a `generator`")
        lm_mask = gumbel_softmax(lm_score, noise, c.gs_tau, hard=True)[..., 0].to(self.dtype)
        lm_masked = lm_mask * h
        return SingleToggleOutputs(
            hidden_states=h, logits=self.lm_head(lm_masked),
            dementia_logits_unmask=self.dementia_head(h),
            dementia_logits_lm=self.dementia_head(lm_masked),
            lm_mask=lm_mask, lm_score=lm_score, frame_mask=frame_mask,
            frame_lengths=frame_lengths)


def single_toggle_loss(out: SingleToggleOutputs, labels, label_lengths, dementia_labels,
                       cfg: DACSConfig, sample_mask=None) -> tuple[torch.Tensor, dict[str, Any]]:
    """Stages (reference trainer_data2vec_toggle.py:320-327): 1 = AD CE on
    the unmasked stream; 2/3 = ctc(lm_masked) + reversed AD loss of the lm
    stream. ``ad_loss="recall"`` takes W=[0.1, 0.9], the reference's."""
    loss_ctc = _ctc(out.logits, out, labels, label_lengths, cfg)
    pool = cfg.pool_valid_frames_only
    ad_unmask = masked_time_mean(out.dementia_logits_unmask.float(), out.frame_mask, pool)
    ad_lm = masked_time_mean(out.dementia_logits_lm.float(), out.frame_mask, pool)
    ad_lm_rev = gradient_reversal(ad_lm, cfg.lambda_grl)
    w = [0.1, 0.9] if cfg.ad_loss == "recall" else None
    ad_loss_unmask = recall_family_loss(ad_unmask, dementia_labels, cfg.ad_loss, w, sample_mask)
    ad_loss_rev = recall_family_loss(ad_lm_rev, dementia_labels, cfg.ad_loss, w, sample_mask)
    final = ad_loss_unmask if cfg.stage == 1 else loss_ctc + ad_loss_rev
    return final, {"loss": final, "ctc": loss_ctc, "ad_unmask": ad_loss_unmask,
                   "ad_reversed": ad_loss_rev}


def single_toggle_trainable(stage: int):
    """Reference freezing (trainer_data2vec_toggle.py:83-100): stage 1 ->
    dementia_head; stage 2 -> arbitrator; stage 3 -> heads + arbitrator."""
    heads = {1: ("dementia_head",), 2: ("arbitrator",),
             3: ("lm_head", "dementia_head", "arbitrator")}
    if stage not in heads:
        raise ValueError(stage)

    def pred(path: tuple[str, ...]) -> bool:
        return path[0] in heads[stage]

    return pred


# ---------------------------------------------------------------------------
# FSM (sigmoid-threshold feature-scoring machines)
# ---------------------------------------------------------------------------

@dataclass
class FSMOutputs:
    hidden_states: torch.Tensor
    logits: torch.Tensor            # lm_head(lm_mask * h)
    logits_r: torch.Tensor          # lm_grl(dementia_mask_r * GRL(h))
    dementia_logits: torch.Tensor   # dementia_head(dementia_mask * h)
    dementia_logits_r: torch.Tensor # dementia_grl(lm_mask_r * GRL(h))
    lm_mask: torch.Tensor
    dementia_mask: torch.Tensor
    lm_score: torch.Tensor          # [B, T, D] sigmoid scores (fp32)
    dementia_score: torch.Tensor
    frame_mask: torch.Tensor
    frame_lengths: torch.Tensor


class FSMModel(_Variant):
    gumbel_draws = 0

    def __init__(self, cfg: DACSConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None, remat: bool = False):
        super().__init__(cfg, dtype, param_dtype, remat)
        d, v, n_ad = cfg.hidden_size, cfg.backbone.vocab_size, cfg.num_ad_classes
        self.lm_fsm = self._linear(d)
        self.dementia_fsm = self._linear(d)
        self.lm_head = self._linear(v)
        self.lm_grl = self._linear(v)
        self.dementia_head = self._linear(n_ad)
        self.dementia_grl = self._linear(n_ad)
        self.similar_fc = self._linear(n_ad, bias=False)

    def _hard_mask(self, x: torch.Tensor, fsm: Linear, thres: float):
        score = torch.sigmoid(fsm(x).float())
        # the reference's "+ 0 * fsm(mask)" hack has zero gradient: detach
        return (score >= thres).to(self.dtype).detach(), score

    def forward(self, input_values: torch.Tensor,
                input_lengths: torch.Tensor | None = None,
                gumbel_noise: tuple = None, generator: torch.Generator | None = None,
                seed_generator: torch.Generator | None = None,
                need_masks: bool = True) -> FSMOutputs:
        """The FSM masks are thresholds, not samples: ``gumbel_noise`` and
        ``generator`` are accepted for the DACS signature and unused, as is
        ``need_masks``."""
        del gumbel_noise, generator, need_masks
        c = self.cfg
        h, frame_mask, frame_lengths = _encode(self, input_values, input_lengths,
                                               seed_generator)
        lm_mask, lm_score = self._hard_mask(h, self.lm_fsm, c.fsm_lm_thres)
        ad_mask, ad_score = self._hard_mask(h, self.dementia_fsm, c.fsm_ad_thres)
        # GRL branch: the reversed embedding, re-masked, into the crossed heads
        h_r = gradient_reversal(h, c.lambda_grl)
        lm_mask_r, _ = self._hard_mask(h_r, self.lm_fsm, c.fsm_lm_thres)
        ad_mask_r, _ = self._hard_mask(h_r, self.dementia_fsm, c.fsm_ad_thres)
        return FSMOutputs(
            hidden_states=h, logits=self.lm_head(lm_mask * h),
            logits_r=self.lm_grl(ad_mask_r * h_r),
            dementia_logits=self.dementia_head(ad_mask * h),
            dementia_logits_r=self.dementia_grl(lm_mask_r * h_r),
            lm_mask=lm_mask, dementia_mask=ad_mask, lm_score=lm_score,
            dementia_score=ad_score, frame_mask=frame_mask, frame_lengths=frame_lengths)


def fsm_loss(out: FSMOutputs, labels, label_lengths, dementia_labels, cfg: DACSConfig,
             similar_fc_weight: torch.Tensor,
             sample_mask=None) -> tuple[torch.Tensor, dict[str, Any]]:
    """Six stage configurations (reference trainer_data2vec_5st.py:372-391).
    ``similar_fc_weight`` is the AM-softmax projection ``[C, D]``."""
    loss = _ctc(out.logits, out, labels, label_lengths, cfg)
    loss_r = _ctc(out.logits_r, out, labels, label_lengths, cfg)
    pool = cfg.pool_valid_frames_only
    fm = out.frame_mask
    ad_mean = masked_time_mean(out.dementia_logits.float(), fm, pool)
    ad_mean_r = masked_time_mean(out.dementia_logits_r.float(), fm, pool)
    dementia_loss = recall_family_loss(ad_mean, dementia_labels, "cel", None, sample_mask)
    dementia_loss_rev = recall_family_loss(ad_mean_r, dementia_labels, "cel", None,
                                           sample_mask)
    att_loss = fsm_attention_loss(out.lm_mask, out.dementia_mask, fm if pool else None)

    h = out.hidden_states.float()
    lm_rows = (out.lm_mask.float() * h).reshape(-1, h.shape[-1])
    ad_rows = (out.dementia_mask.float() * h).reshape(-1, h.shape[-1])
    n = lm_rows.shape[0]
    am_labels = torch.cat([torch.zeros(n, dtype=torch.long, device=h.device),
                           torch.ones(n, dtype=torch.long, device=h.device)])
    row_w = None
    if pool:
        fw = fm.float().reshape(-1)
        row_w = torch.cat([fw, fw])
    score_loss, _ = am_softmax_loss(torch.cat([lm_rows, ad_rows]), am_labels,
                                    similar_fc_weight, loss_type=cfg.am_loss_type,
                                    sample_weight=row_w)

    stage = cfg.stage
    if stage in (1, 2, 6):
        final = loss + dementia_loss + score_loss + att_loss
    elif stage == 3:
        final = dementia_loss_rev
    elif stage == 4:
        final = loss_r
    elif stage == 5:
        final = loss + dementia_loss_rev
    else:
        raise ValueError(f"unknown FSM stage {stage}")
    return final, {"loss": final, "ctc": loss, "ctc_reversed": loss_r,
                   "ad": dementia_loss, "ad_reversed": dementia_loss_rev,
                   "att": att_loss, "am_softmax": score_loss}


_FSM_FROZEN = {
    1: {"lm_grl", "dementia_grl", "lm_head", "dementia_head"},
    2: {"lm_grl", "dementia_grl"},
    3: {"lm_fsm", "dementia_fsm", "lm_head", "dementia_head", "lm_grl"},
    4: {"lm_fsm", "dementia_fsm", "lm_head", "dementia_head", "dementia_grl"},
    5: {"dementia_fsm", "similar_fc", "lm_head", "dementia_head", "lm_grl", "dementia_grl"},
    6: {"lm_head", "dementia_head", "similar_fc", "lm_grl", "dementia_grl"},
}


def fsm_trainable(stage: int):
    """Reference freezing (trainer_data2vec_5st.py:108-148): the encoder
    (not its conv feature extractor) trains in stages 1/2."""
    frozen = _FSM_FROZEN[stage]

    def pred(path: tuple[str, ...]) -> bool:
        if path[0] == "backbone":
            return path[1] != "feature_extractor" and stage in (1, 2)
        return path[0] not in frozen

    return pred
