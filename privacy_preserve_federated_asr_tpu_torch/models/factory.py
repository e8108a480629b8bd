"""Backbone factory: model_type -> encoder module."""

from __future__ import annotations

import torch

from .backbone import SSLBackbone
from .config import BackboneConfig


def make_backbone(cfg: BackboneConfig, dtype: torch.dtype = torch.float32,
                  param_dtype: torch.dtype | None = None) -> SSLBackbone:
    """SSLBackbone for wav2vec2/hubert/data2vec/unispeech-sat. SEW-D waits
    for its slice."""
    if cfg.model_type == "sew-d":
        raise NotImplementedError("model_type='sew-d' is not ported yet")
    return SSLBackbone(cfg, dtype, param_dtype)
