"""Greedy CTC decoding on the device (the port's ``ops/decode.py``): the
argmax runs where the logits are; padded frames are forced to blank so the
host-side CTC collapse ignores them."""

from __future__ import annotations

import torch


def greedy_ids(logits: torch.Tensor, frame_mask: torch.Tensor,
               blank_id: int = 0) -> torch.Tensor:
    """[B, T, V] logits -> [B, T] argmax ids with padding forced to blank."""
    ids = torch.argmax(logits, dim=-1)
    return torch.where(frame_mask.bool(), ids, torch.full_like(ids, blank_id))


def ad_vote(dementia_logits: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
    """Per-utterance AD prediction: fraction of valid frames argmaxing AD
    > 0.5 (reference: federated/src/update.py:177-180 ``map_to_result``)."""
    pred = torch.argmax(dementia_logits, dim=-1).to(torch.float32)  # [B, T]
    fm = frame_mask.to(torch.float32)
    frac = (pred * fm).sum(1) / fm.sum(1).clamp_min(1.0)
    return (frac > 0.5).to(torch.int32)
