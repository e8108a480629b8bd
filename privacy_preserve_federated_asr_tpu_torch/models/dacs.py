"""DACS model: SSL encoder + CTC head + AD head + toggling network (the
port's ``models/dacs.py``, inference only).

Mask machinery (reference forward federated/src/models.py:421-446):
  * ``arbitrator``: Linear(D -> 4D). Channels [0,D)+[D,2D) form per-node
    2-logit pairs for the **lm mask**; [2D,3D)+[3D,4D) for the **AD mask**.
  * optional TOGGLE_RATIO rescale ``y0' = (y1 - y0) * ratio + y0``,
  * straight-through Gumbel-softmax (tau = GS_TAU) -> hard mask = pair[...,0],
  * ``lm_masked = lm_mask * h``, ``ad_masked = ad_mask * h``.

The Gumbel noise is injected (``gumbel_noise``, as the JAX model takes it)
or drawn from an explicit ``torch.Generator``: lm noise first, then AD.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.gumbel import gumbel_softmax, sample_gumbel
from .backbone import feat_extract_output_lengths
from .config import DACSConfig
from .factory import make_backbone


@dataclass
class DACSOutputs:
    """Everything serving and evaluation need from one forward (the JAX
    ``DACSOutputs`` without the N-best ``extra_logits``)."""

    hidden_states: torch.Tensor          # [B, T, D] encoder output
    logits_unmask: torch.Tensor          # [B, T, V] lm_head(h)        (stage-0 ASR)
    logits: torch.Tensor                 # [B, T, V] lm_head(lm_mask*h)
    logits_r: torch.Tensor               # [B, T, V] lm_head(ad_mask*h)
    dementia_logits_unmask: torch.Tensor # [B, T, 2] ad_head(h)         (stage-1)
    dementia_logits_lm: torch.Tensor     # [B, T, 2] ad_head(lm_mask*h)
    dementia_logits_ad: torch.Tensor     # [B, T, 2] ad_head(ad_mask*h)
    lm_mask: torch.Tensor                # [B, T, D] hard 0/1
    ad_mask: torch.Tensor                # [B, T, D] hard 0/1
    lm_score: torch.Tensor               # [B, T, D, 2] pre-GS logits (fp32)
    ad_score: torch.Tensor               # [B, T, D, 2]
    frame_mask: torch.Tensor             # [B, T] int32 valid-frame indicator
    frame_lengths: torch.Tensor          # [B]


class DACSModel(nn.Module):
    def __init__(self, cfg: DACSConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.hidden_size
        self.backbone = make_backbone(cfg.backbone, dtype)
        self.arbitrator = nn.Linear(d, 4 * d, dtype=dtype)
        self.lm_head = nn.Linear(d, cfg.backbone.vocab_size, dtype=dtype)
        self.dementia_head = nn.Linear(d, cfg.num_ad_classes, dtype=dtype)
        # AM-softmax projection ("criterion_similar.fc" in the reference)
        self.similar_fc = nn.Linear(d, cfg.num_ad_classes, bias=False, dtype=dtype)

    def forward(self, input_values: torch.Tensor,
                input_lengths: torch.Tensor | None = None,
                gumbel_noise: tuple[torch.Tensor, torch.Tensor] | None = None,
                generator: torch.Generator | None = None) -> DACSOutputs:
        bb = self.cfg.backbone
        b, n = input_values.shape
        t_frames = feat_extract_output_lengths(bb, n)
        if input_lengths is None:
            input_lengths = torch.full((b,), n, dtype=torch.int32,
                                       device=input_values.device)
        frame_lengths = feat_extract_output_lengths(bb, input_lengths)
        frame_mask = (torch.arange(t_frames, device=input_values.device)[None, :]
                      < frame_lengths[:, None]).to(torch.int32)
        h = self.backbone(input_values, frame_mask)
        return self.apply_heads(h, frame_mask, frame_lengths, gumbel_noise, generator)

    def apply_heads(self, h: torch.Tensor, frame_mask: torch.Tensor,
                    frame_lengths: torch.Tensor,
                    gumbel_noise: tuple[torch.Tensor, torch.Tensor] | None = None,
                    generator: torch.Generator | None = None) -> DACSOutputs:
        c = self.cfg
        d = c.hidden_size
        all_score = self.arbitrator(h).float()  # [B, T, 4D]
        lm_score = torch.stack((all_score[..., :d], all_score[..., d:2 * d]), dim=-1)
        ad_score = torch.stack((all_score[..., 2 * d:3 * d], all_score[..., 3 * d:]), dim=-1)
        if c.toggle_ratio != 0.0:
            lm_score = _toggle_rescale(lm_score, c.toggle_ratio)
            ad_score = _toggle_rescale(ad_score, c.toggle_ratio)
        if gumbel_noise is not None:  # injected noise (parity tests)
            lm_noise, ad_noise = gumbel_noise
        else:
            if generator is None:
                raise ValueError("DACSModel needs `gumbel_noise` or a `generator`")
            lm_noise = sample_gumbel(lm_score.shape, generator, h.device)
            ad_noise = sample_gumbel(ad_score.shape, generator, h.device)
        lm_mask = gumbel_softmax(lm_score, lm_noise, c.gs_tau, hard=True)[..., 0]
        ad_mask = gumbel_softmax(ad_score, ad_noise, c.gs_tau, hard=True)[..., 0]
        lm_mask = lm_mask.to(self.dtype)
        ad_mask = ad_mask.to(self.dtype)
        lm_masked = lm_mask * h
        ad_masked = ad_mask * h
        return DACSOutputs(
            hidden_states=h,
            logits_unmask=self.lm_head(h),
            logits=self.lm_head(lm_masked),
            logits_r=self.lm_head(ad_masked),
            dementia_logits_unmask=self.dementia_head(h),
            dementia_logits_lm=self.dementia_head(lm_masked),
            dementia_logits_ad=self.dementia_head(ad_masked),
            lm_mask=lm_mask,
            ad_mask=ad_mask,
            lm_score=lm_score,
            ad_score=ad_score,
            frame_mask=frame_mask,
            frame_lengths=frame_lengths,
        )


def _toggle_rescale(score: torch.Tensor, ratio: float) -> torch.Tensor:
    """TOGGLE_RATIO knob: shift the mask-on logit toward the off logit
    (reference: federated/src/models.py:431-440)."""
    y0, y1 = score[..., 0], score[..., 1]
    return torch.stack(((y1 - y0) * ratio + y0, y1), dim=-1)
