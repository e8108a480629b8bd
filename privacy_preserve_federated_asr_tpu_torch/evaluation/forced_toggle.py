"""Forced-toggle experiments (the port's ``evaluation/forced_toggle.py``;
reference: centralized/eval_toggle_more.py:140-228), as rank/threshold ops
on the device instead of the reference's python triple loops.

Inputs are the pre-Gumbel propensity scores ``y0 - y1`` per node ([..., D]):
larger means "should stay on" (the reference sorts ascending and turns off
the smallest). Ranks come from a double stable ``argsort``, as in JAX.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ..data.collate import LengthBucketBatcher
from ..data.dataset import AsrExample
from ..data.tokenizer import CTCCharTokenizer
from ..models.config import DACSConfig
from ..models.dacs import DACSModel
from ..ops.decode import greedy_ids
from ..serving.engine import resolve_device
from ..train.metrics import wer as corpus_wer
from .extract import batch_inputs, load_model


def _ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each node within its frame (0 = first in ascending order)."""
    order = torch.argsort(scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def mask_off_n_groups(scores, num_per_group: int, num_off: int) -> torch.Tensor:
    """Turn off the ``num_off * num_per_group`` lowest-scoring nodes per
    frame; all other nodes forced on (reference ``MaskOffNGroups``)."""
    scores = torch.as_tensor(scores)
    n_off = min(int(num_off * num_per_group), scores.shape[-1])
    return (_ranks(scores) >= n_off).to(torch.float32)


def aggressive_passive_masking(scores, mask_ori, ratio: float,
                               aggressive: bool) -> torch.Tensor:
    """Re-mask at ratio r relative to the original Gumbel mask.

    aggressive: originally-off stay off; of the originally-on nodes, the
      fraction ``ratio`` with the *lowest* scores also turn off.
    passive: originally-on stay on; of the originally-off nodes, the
      fraction ``ratio`` with the *highest* scores also turn on.

    Per-frame counts N = floor(ratio * #on) (agg) / floor(ratio * #off)
    (pas) match the reference exactly, including the ratio == 1 shortcuts.
    """
    scores = torch.as_tensor(scores)
    mask_ori = torch.as_tensor(mask_ori)
    if ratio == 1.0:
        return torch.full_like(mask_ori, 0.0 if aggressive else 1.0)
    inf = torch.tensor(torch.inf, dtype=scores.dtype, device=scores.device)
    if aggressive:
        n = torch.floor(mask_ori.sum(-1, keepdim=True) * ratio)  # [..., 1]
        # among originally-on nodes, rank ascending by score; the n smallest off
        ranks = _ranks(torch.where(mask_ori == 1, scores, inf)).to(torch.float32)
        turn_off = (mask_ori == 1) & (ranks < n)
        return torch.where(turn_off, torch.zeros_like(mask_ori), mask_ori)
    n = torch.floor((mask_ori.shape[-1] - mask_ori.sum(-1, keepdim=True)) * ratio)
    # among originally-off nodes, rank descending by score; the n largest on
    ranks = _ranks(-torch.where(mask_ori == 0, scores, -inf)).to(torch.float32)
    turn_on = (mask_ori == 0) & (ranks < n)
    return torch.where(turn_on, torch.ones_like(mask_ori), mask_ori)


def forced_toggle_extract(
    cfg: DACSConfig,
    state_dict: Mapping[str, torch.Tensor],
    examples: Sequence[AsrExample],
    tokenizer: CTCCharTokenizer,
    mode: str,                      # "off_groups" | "aggressive" | "passive"
    batch_size: int = 16,
    time_multiple: int = 16000,
    num_per_group: int = 32,
    num_off: int = 0,
    ratio: float = 0.0,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """Run extraction with the lm mask replaced by a forced-toggle variant
    (reference: eval_toggle_more.py's experiments re-decoding with modified
    masks). Propensity scores y0 - y1 come from the arbitrator's lm pair; the
    heads run a second time on the same encoder output and noise with
    ``mask_override`` (the JAX function runs the whole model twice with one
    key; the encoder is deterministic in eval, so the outputs agree).

    Returns (rows, wer) where rows carry the modified-mask transcripts.
    """
    if mode not in ("off_groups", "aggressive", "passive"):
        raise ValueError(mode)
    device = resolve_device(device)
    model = load_model(DACSModel, cfg, state_dict, torch.float32, device)
    generator = torch.Generator(device)
    batcher = LengthBucketBatcher(examples, batch_size, time_multiple=time_multiple)
    by_path = {e.path: e for e in examples}
    rows, refs, hyps = [], [], []
    for b in batcher.epoch(epoch_seed=0):
        with torch.inference_mode():
            x, lengths, noise = batch_inputs(cfg, b, seed, generator, None, device)
            out = model(x, lengths, gumbel_noise=noise)
            scores = out.lm_score[..., 0] - out.lm_score[..., 1]  # y0 - y1
            if mode == "off_groups":
                forced = mask_off_n_groups(scores, num_per_group, num_off)
            else:
                forced = aggressive_passive_masking(scores, out.lm_mask, ratio,
                                                    mode == "aggressive")
            out2 = model.apply_heads(out.hidden_states, out.frame_mask, out.frame_lengths,
                                     gumbel_noise=noise,
                                     mask_override=(forced.to(out.lm_mask.dtype), None))
            pred = greedy_ids(out2.logits, out2.frame_mask, cfg.backbone.pad_token_id)
            pred, forced, flen = (t.cpu().numpy() for t in (pred, forced.float(),
                                                            out2.frame_lengths))
        for i, path in enumerate(b.paths):
            text = by_path[path].text
            hyp = tokenizer.decode(pred[i])
            rows.append({"path": path, "text": text, "pred_str": hyp,
                         "forced_on_rate": float(forced[i, : int(flen[i])].mean())})
            if text:
                refs.append(text)
                hyps.append(hyp)
    return rows, (corpus_wer(refs, hyps) if refs else None)


def reference_mask_off_n_groups(scores: np.ndarray, num_per_group: int,
                                num_off: int) -> np.ndarray:
    """Direct loop transcription of the reference semantics (test oracle)."""
    b, t, d = scores.shape
    out = np.ones((b, t, d), dtype=np.float32)
    n_off = int(num_off * num_per_group)
    for i in range(b):
        for j in range(t):
            order = np.argsort(scores[i, j], kind="stable")
            out[i, j, order[:n_off]] = 0
    return out
