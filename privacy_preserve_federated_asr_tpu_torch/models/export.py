"""The port's state dicts back to the HF torch ``state_dict`` layout (the
port's ``models/export.py``; the inverse of ``models/port.py``
``state_dict_from_hf``).

The port's modules already keep HF attribute names, so the encoder exports
by name under its ForCTC attribute (``data2vec_audio.`` ...). What is left
to convert:
  * the weight-normed positional conv (wav2vec2/hubert ``single``): the
    port holds the merged weight W, which splits as ``v = W``,
    ``g = ||W||`` over the non-kept dims (weight_norm dim=2), so
    ``g * v/||v|| == W`` exactly. Key style is selectable: legacy
    ``weight_g/weight_v`` or torch>=2 ``parametrizations.weight.
    original{0,1}``;
  * the DACS heads: ``similar_fc`` is the reference's
    ``criterion_similar.fc``.

Values are fp32 numpy arrays, the JAX package's export format.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import BackboneConfig

_POS_CONV = "encoder.pos_conv_embed.conv"
# the port's head attributes -> reference ForCTC keys
# (federated/src/models.py:292-299)
_HEADS = {"lm_head": "lm_head", "dementia_head": "dementia_head",
          "arbitrator": "arbitrator", "similar_fc": "criterion_similar.fc"}
_FOR_CTC_PREFIX = {"data2vec-audio": "data2vec_audio.", "wav2vec2": "wav2vec2.",
                   "hubert": "hubert.", "unispeech-sat": "unispeech_sat."}


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _split_weight_norm(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Merged conv weight [out, in/g, k] -> (g [1,1,k], v [out,in/g,k]) with
    ``weight_norm(v, g, dim=2)`` reproducing ``w`` exactly."""
    g = np.sqrt(np.sum(w.astype(np.float64) ** 2, axis=(0, 1), keepdims=True))
    return g.astype(np.float32), _np32(w)


def export_hf_state_dict(
    backbone_sd: Mapping[str, torch.Tensor],
    cfg: BackboneConfig,
    encoder_prefix: str = "",
    weight_norm_style: str = "parametrizations",
) -> dict[str, np.ndarray]:
    """The port's :class:`SSLBackbone` state dict -> HF torch ``state_dict``
    (numpy values; wrap with ``torch.from_numpy`` to load).
    ``encoder_prefix`` prepends a wrapping attribute (e.g.
    ``"data2vec_audio."`` for a ForCTC layout). ``weight_norm_style``:
    "parametrizations" (torch >= 2 modules) or "legacy" (weight_g/weight_v).
    SpecAugment's ``masked_spec_embed`` is training state and not exported,
    as in the JAX package."""
    if weight_norm_style not in ("parametrizations", "legacy"):
        raise ValueError(f"unknown weight_norm_style {weight_norm_style!r}")
    sd: dict[str, np.ndarray] = {}
    for key, value in backbone_sd.items():
        if key == "masked_spec_embed":
            continue
        if cfg.pos_conv_type != "stacked" and key == f"{_POS_CONV}.weight":
            g, v = _split_weight_norm(_np32(value))
            if weight_norm_style == "legacy":
                gk, vk = f"{_POS_CONV}.weight_g", f"{_POS_CONV}.weight_v"
            else:
                gk = f"{_POS_CONV}.parametrizations.weight.original0"
                vk = f"{_POS_CONV}.parametrizations.weight.original1"
            sd[encoder_prefix + gk], sd[encoder_prefix + vk] = g, v
        else:
            sd[encoder_prefix + key] = _np32(value)
    return sd


def export_dacs_heads(state_dict: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """DACS task heads of the port's DACSModel state dict -> reference
    ForCTC ``state_dict`` keys."""
    sd: dict[str, np.ndarray] = {}
    for ours, theirs in _HEADS.items():
        for leaf in ("weight", "bias"):
            if f"{ours}.{leaf}" in state_dict:
                sd[f"{theirs}.{leaf}"] = _np32(state_dict[f"{ours}.{leaf}"])
    return sd


def export_for_ctc_state_dict(state_dict: Mapping[str, torch.Tensor],
                              cfg: BackboneConfig,
                              weight_norm_style: str = "parametrizations"
                              ) -> dict[str, np.ndarray]:
    """Full reference-style ForCTC export of the port's DACSModel state
    dict: encoder under its HF attribute name + task heads at the top level
    — loadable by the reference's ``update_network_weight`` surgery, by HF
    ForCTC models (the plain lm_head maps 1:1) and by ``cli --model_in``."""
    prefix = _FOR_CTC_PREFIX.get(cfg.model_type)
    if prefix is None:
        raise ValueError(f"no ForCTC export mapping for {cfg.model_type!r}")
    backbone = {k[len("backbone."):]: v for k, v in state_dict.items()
                if k.startswith("backbone.")}
    sd = export_hf_state_dict(backbone, cfg, encoder_prefix=prefix,
                              weight_norm_style=weight_norm_style)
    sd.update(export_dacs_heads(state_dict))
    return sd
