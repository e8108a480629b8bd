"""DACS model: SSL encoder + CTC head + AD head + toggling network (the
port's ``models/dacs.py``).

Mask machinery (reference forward federated/src/models.py:421-446):
  * ``arbitrator``: Linear(D -> 4D). Channels [0,D)+[D,2D) form per-node
    2-logit pairs for the **lm mask**; [2D,3D)+[3D,4D) for the **AD mask**.
  * optional TOGGLE_RATIO rescale ``y0' = (y1 - y0) * ratio + y0``,
  * straight-through Gumbel-softmax (tau = GS_TAU) -> hard mask = pair[...,0],
  * ``lm_masked = lm_mask * h``, ``ad_masked = ad_mask * h``.

The Gumbel noise is injected (``gumbel_noise``, as the JAX model takes it)
or drawn from an explicit ``torch.Generator``: lm noise first, then AD.

Multitask N-best heads (``num_lms > 1``, ``lm_heads.{i}``) reproduce the
semi-supervised FL model (reference:
federated/src/Data2VecAudioForCTCMultitask_model.py:270-275); their streams
are ``extra_logits``.

Training modes follow the recipe's ``backbone_trains(stage)``: the JAX
model's ``deterministic`` / ``backbone_deterministic`` flags become
``model.train()`` with ``model.backbone.eval()`` for a frozen, deterministic
encoder under live head dropout (the reference's ``.eval()`` on frozen
modules).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.gumbel import gumbel_softmax, sample_gumbel
from .backbone import Linear, feat_extract_output_lengths
from .config import DACSConfig
from .factory import make_backbone


@dataclass
class DACSOutputs:
    """Everything serving, training and evaluation need from one forward
    (the JAX ``DACSOutputs``). A forward
    with ``need_masks=False`` leaves the mask fields and the masked streams
    None: the stage-0/1 losses read only the unmasked streams, and eager
    PyTorch cannot drop dead branches as XLA does."""

    hidden_states: torch.Tensor          # [B, T, D] encoder output
    logits_unmask: torch.Tensor          # [B, T, V] lm_head(h)        (stage-0 ASR)
    logits: torch.Tensor | None          # [B, T, V] lm_head(lm_mask*h)
    logits_r: torch.Tensor | None        # [B, T, V] lm_head(ad_mask*h)
    dementia_logits_unmask: torch.Tensor # [B, T, 2] ad_head(h)         (stage-1)
    dementia_logits_lm: torch.Tensor | None  # [B, T, 2] ad_head(lm_mask*h)
    dementia_logits_ad: torch.Tensor | None  # [B, T, 2] ad_head(ad_mask*h)
    lm_mask: torch.Tensor | None         # [B, T, D] hard 0/1
    ad_mask: torch.Tensor | None         # [B, T, D] hard 0/1
    lm_score: torch.Tensor | None        # [B, T, D, 2] pre-GS logits (fp32)
    ad_score: torch.Tensor | None        # [B, T, D, 2]
    frame_mask: torch.Tensor             # [B, T] int32 valid-frame indicator
    frame_lengths: torch.Tensor          # [B]
    # N-best lm_heads streams when num_lms > 1: a tuple of
    # (head(h), head(lm_masked), head(ad_masked)) triples
    extra_logits: tuple = ()


class DACSModel(nn.Module):
    """``dtype`` is the compute dtype; ``param_dtype`` (default: ``dtype``)
    the storage dtype of the matmul and conv weights (fp32 when training in
    bf16, as flax keeps fp32 params); ``remat`` recomputes each encoder
    layer in the backward pass (``torch.utils.checkpoint``). ``gumbel_draws``:
    the forward takes two Gumbel tensors of the mask-score shape, lm then AD
    (models/variants.py)."""

    gumbel_draws = 2

    def __init__(self, cfg: DACSConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None, remat: bool = False):
        super().__init__()
        param_dtype = dtype if param_dtype is None else param_dtype
        self.cfg, self.dtype = cfg, dtype
        d = cfg.hidden_size
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.backbone = make_backbone(cfg.backbone, dtype, param_dtype)
        self.backbone.encoder.remat = remat
        self.dropout = nn.Dropout(cfg.backbone.final_dropout)
        self.arbitrator = Linear(d, 4 * d, **kw)
        self.lm_head = Linear(d, cfg.backbone.vocab_size, **kw)
        self.dementia_head = Linear(d, cfg.num_ad_classes, **kw)
        # AM-softmax projection ("criterion_similar.fc" in the reference)
        self.similar_fc = Linear(d, cfg.num_ad_classes, bias=False, **kw)
        if cfg.num_lms > 1:
            self.lm_heads = nn.ModuleList(Linear(d, cfg.backbone.vocab_size, **kw)
                                          for _ in range(cfg.num_lms))

    def forward(self, input_values: torch.Tensor,
                input_lengths: torch.Tensor | None = None,
                gumbel_noise: tuple[torch.Tensor, torch.Tensor] | None = None,
                generator: torch.Generator | None = None,
                seed_generator: torch.Generator | None = None,
                need_masks: bool = True,
                mask_override: tuple[torch.Tensor | None, torch.Tensor | None] | None = None,
                ) -> DACSOutputs:
        """``generator`` draws the Gumbel noise (on the model's device) unless
        ``gumbel_noise`` is given; ``seed_generator`` (CPU) the
        attention-dropout seeds in training; ``mask_override`` as in
        :meth:`apply_heads`."""
        bb = self.cfg.backbone
        b, n = input_values.shape
        t_frames = feat_extract_output_lengths(bb, n)
        if input_lengths is None:
            input_lengths = torch.full((b,), n, dtype=torch.int32,
                                       device=input_values.device)
        frame_lengths = feat_extract_output_lengths(bb, input_lengths)
        frame_mask = (torch.arange(t_frames, device=input_values.device)[None, :]
                      < frame_lengths[:, None]).to(torch.int32)
        h = self.backbone(input_values, frame_mask, seed_generator=seed_generator)
        return self.apply_heads(h, frame_mask, frame_lengths, gumbel_noise, generator,
                                need_masks, mask_override)

    def apply_from_features(self, features: torch.Tensor, frame_mask: torch.Tensor,
                            frame_lengths: torch.Tensor,
                            gumbel_noise: tuple[torch.Tensor, torch.Tensor] | None = None,
                            generator: torch.Generator | None = None,
                            seed_generator: torch.Generator | None = None,
                            need_masks: bool = True) -> DACSOutputs:
        """Forward from CACHED conv-frontend outputs ``[B, T', C_conv]``
        (the stage-0 fast path). The feature extractor is frozen in every
        recipe and has no dropout, so its output is a training-invariant
        constant per utterance; everything trained or stochastic sits after
        this cache point."""
        h = self.backbone(None, frame_mask, precomputed_features=features,
                          seed_generator=seed_generator)
        return self.apply_heads(h, frame_mask, frame_lengths, gumbel_noise, generator,
                                need_masks)

    def apply_heads(self, h: torch.Tensor, frame_mask: torch.Tensor,
                    frame_lengths: torch.Tensor,
                    gumbel_noise: tuple[torch.Tensor, torch.Tensor] | None = None,
                    generator: torch.Generator | None = None,
                    need_masks: bool = True,
                    mask_override: tuple[torch.Tensor | None, torch.Tensor | None] | None = None,
                    ) -> DACSOutputs:
        """Everything after the backbone, the final dropout first.
        ``mask_override = (lm, ad)`` replaces the hard lm and/or AD mask
        (``None`` keeps the sampled one) after sampling and before the cast:
        the forced-toggle experiments (``evaluation/forced_toggle.py``)."""
        c = self.cfg
        d = c.hidden_size
        h = self.dropout(h)
        if not need_masks:
            return DACSOutputs(
                hidden_states=h, logits_unmask=self.lm_head(h), logits=None,
                logits_r=None, dementia_logits_unmask=self.dementia_head(h),
                dementia_logits_lm=None, dementia_logits_ad=None, lm_mask=None,
                ad_mask=None, lm_score=None, ad_score=None, frame_mask=frame_mask,
                frame_lengths=frame_lengths,
                extra_logits=tuple((head(h), None, None)
                                   for head in getattr(self, "lm_heads", ())))
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
        if mask_override is not None:
            lm_over, ad_over = mask_override
            lm_mask = lm_mask if lm_over is None else lm_over
            ad_mask = ad_mask if ad_over is None else ad_over
        lm_mask = lm_mask.to(self.dtype)
        ad_mask = ad_mask.to(self.dtype)
        lm_masked = lm_mask * h
        ad_masked = ad_mask * h
        extra = ()
        if c.num_lms > 1:
            extra = tuple((head(h), head(lm_masked), head(ad_masked))
                          for head in self.lm_heads)
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
            extra_logits=extra,
        )


def _toggle_rescale(score: torch.Tensor, ratio: float) -> torch.Tensor:
    """TOGGLE_RATIO knob: shift the mask-on logit toward the off logit
    (reference: federated/src/models.py:431-440)."""
    y0, y1 = score[..., 0], score[..., 1]
    return torch.stack(((y1 - y0) * ratio + y0, y1), dim=-1)
