"""Backbone factory: model_type -> encoder module."""

from __future__ import annotations

import torch

from .backbone import SSLBackbone
from .config import BackboneConfig
from .sewd import SEWDBackbone


def make_backbone(cfg: BackboneConfig, dtype: torch.dtype = torch.float32,
                  param_dtype: torch.dtype | None = None) -> SSLBackbone | SEWDBackbone:
    """SSLBackbone for wav2vec2/hubert/data2vec/unispeech-sat; SEWDBackbone
    for ``model_type="sew-d"``."""
    if cfg.model_type == "sew-d":
        return SEWDBackbone(cfg, dtype, param_dtype)
    return SSLBackbone(cfg, dtype, param_dtype)
