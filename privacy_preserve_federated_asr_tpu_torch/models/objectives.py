"""Stage-routed DACS training objective (the port's ``models/objectives.py``).

The reference loss graph (federated/src/models.py:480-624):

  stage 0:  ctc(logits_unmask)                                  # ASR fine-tune
  stage 1:  AD_loss(mean_t(dementia_logits_unmask))             # AD classifier
  stage 2:  ctc(lm_masked) + AD_loss(GRL(mean_t(ad_on_lm)))     # toggling net
          + ctc(GRL(log_probs(ad_masked))) + AD_loss(ad_on_ad)
          + am_softmax(stack(lm_masked, ad_masked))
  stage 3:  stage 2 without the AM-softmax term (toggle_more)

GRL sits on the *time-pooled AD logits* of the lm stream and on the
*log-softmax* of the AD stream's CTC logits, both with strength lambda.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..ops.ctc import ctc_loss
from ..ops.grl import gradient_reversal
from ..ops.losses import am_softmax_loss, recall_family_loss
from .config import DACSConfig
from .dacs import DACSOutputs


def _ad_weight(cfg: DACSConfig):
    """AD-loss kind -> class weights ("recall": w_loss, "prec": [0.1, 0.9],
    "cel": none, the rest [0.5, 0.5]; reference :535-582)."""
    if cfg.ad_loss == "recall":
        return list(cfg.w_loss)
    if cfg.ad_loss == "prec":
        return [0.1, 0.9]
    if cfg.ad_loss == "cel":
        return None
    return [0.5, 0.5]


def masked_time_mean(x: torch.Tensor, frame_mask: torch.Tensor, enabled: bool) -> torch.Tensor:
    """Mean over time. ``enabled=False`` reproduces the reference quirk of
    pooling over *all* frames including padding (harmless at batch size 1)."""
    if not enabled:
        return x.mean(1)
    fm = frame_mask.to(x.dtype)[:, :, None]
    return (x * fm).sum(1) / fm.sum(1).clamp_min(1.0)


def dacs_loss(outputs: DACSOutputs, labels: torch.Tensor, label_lengths: torch.Tensor,
              dementia_labels: torch.Tensor, cfg: DACSConfig,
              similar_fc_weight: torch.Tensor,
              sample_mask: torch.Tensor | None = None,
              aux_metrics: bool = True) -> tuple[torch.Tensor, dict[str, Any]]:
    """(stage-routed final loss, metrics dict). ``similar_fc_weight`` is
    the AM-softmax projection ``[C, D]`` (torch layout). ``aux_metrics=False``
    computes only the terms the stage's loss consumes; the skipped metric
    entries are 0, as in the JAX package."""
    bcfg = cfg.backbone
    lam = cfg.lambda_grl
    pool = cfg.pool_valid_frames_only
    stage = cfg.stage
    zero = torch.zeros((), device=outputs.hidden_states.device)

    def _ctc(logits, reverse=False):
        lp = F.log_softmax(logits.float(), dim=-1)
        if reverse:
            lp = gradient_reversal(lp, lam)  # ASR-GRL (reference :501-502)
        return ctc_loss(lp, labels, outputs.frame_lengths, label_lengths,
                        blank_id=bcfg.pad_token_id, reduction=bcfg.ctc_loss_reduction,
                        zero_infinity=bcfg.ctc_zero_infinity)

    fm = outputs.frame_mask
    w = _ad_weight(cfg)

    def _ad(logits, reverse=False):
        mean = masked_time_mean(logits.float(), fm, pool)
        if reverse:
            mean = gradient_reversal(mean, lam)  # AD-GRL (reference :471-472)
        return recall_family_loss(mean, dementia_labels, cfg.ad_loss, w, sample_mask)

    need_unmask = aux_metrics or stage == 0
    need_masked = aux_metrics or stage in (2, 3)
    need_ad_unmask = aux_metrics or stage == 1
    need_score = aux_metrics or stage == 2  # stage 3 drops the AM-softmax term

    loss_unmask = _ctc(outputs.logits_unmask) if need_unmask else zero
    loss_masked = _ctc(outputs.logits) if need_masked else zero
    loss_r = _ctc(outputs.logits_r, reverse=True) if need_masked else zero
    ad_loss_unmask = _ad(outputs.dementia_logits_unmask) if need_ad_unmask else zero
    ad_loss_rev = _ad(outputs.dementia_logits_lm, reverse=True) if need_masked else zero
    ad_loss = _ad(outputs.dementia_logits_ad) if need_masked else zero

    if need_score:
        # diversity (AM-softmax) over the stacked masked frame embeddings
        # (reference :592-607: rows = B*T frames of each stream, labels 0/1)
        h = outputs.hidden_states.float()
        lm_rows = (outputs.lm_mask.float() * h).reshape(-1, h.shape[-1])
        ad_rows = (outputs.ad_mask.float() * h).reshape(-1, h.shape[-1])
        rows = torch.cat([lm_rows, ad_rows])
        n = lm_rows.shape[0]
        am_labels = torch.cat([torch.zeros(n, dtype=torch.long, device=h.device),
                               torch.ones(n, dtype=torch.long, device=h.device)])
        row_w = None
        if pool:
            fw = fm.float().reshape(-1)
            row_w = torch.cat([fw, fw])
        score_loss, _ = am_softmax_loss(rows, am_labels, similar_fc_weight,
                                        loss_type=cfg.am_loss_type, sample_weight=row_w)
    else:
        score_loss = zero

    if stage == 0:
        final = loss_unmask
    elif stage == 1:
        final = ad_loss_unmask
    elif stage == 2:
        final = loss_masked + ad_loss_rev + loss_r + ad_loss + score_loss
    elif stage == 3:
        final = loss_masked + ad_loss_rev + loss_r + ad_loss
    else:
        raise ValueError(f"unknown stage {cfg.stage}")

    metrics = {
        "loss": final,
        "ctc_unmask": loss_unmask,
        "ctc_masked": loss_masked,
        "ctc_reversed": loss_r,
        "ad_unmask": ad_loss_unmask,
        "ad_reversed": ad_loss_rev,
        "ad_masked": ad_loss,
        "am_softmax": score_loss,
        "lm_mask_on_rate": masked_time_mean(outputs.lm_mask, fm, True).mean()
        if need_masked else zero,
        "ad_mask_on_rate": masked_time_mean(outputs.ad_mask, fm, True).mean()
        if need_masked else zero,
    }
    return final, metrics


def grl_multitask_loss(outputs: DACSOutputs, labels: torch.Tensor,
                       label_lengths: torch.Tensor, dementia_labels: torch.Tensor,
                       cfg: DACSConfig, reverse: bool = True,
                       sample_mask: torch.Tensor | None = None):
    """GRL/multi-task baseline (reference centralized/Models.py:298-425):
    CTC on the unmasked stream + (optionally gradient-reversed) AD CE."""
    bcfg = cfg.backbone
    lp = F.log_softmax(outputs.logits_unmask.float(), dim=-1)
    loss_ctc = ctc_loss(lp, labels, outputs.frame_lengths, label_lengths,
                        blank_id=bcfg.pad_token_id, reduction=bcfg.ctc_loss_reduction,
                        zero_infinity=bcfg.ctc_zero_infinity)
    ad_mean = masked_time_mean(outputs.dementia_logits_unmask.float(),
                               outputs.frame_mask, cfg.pool_valid_frames_only)
    if reverse:
        ad_mean = gradient_reversal(ad_mean, cfg.lambda_grl)
    ad = recall_family_loss(ad_mean, dementia_labels, "cel", None, sample_mask)
    final = loss_ctc + ad
    return final, {"loss": final, "ctc": loss_ctc, "ad": ad}
