"""Audio-embedding backends for the heterogeneous text experiments (the
port's ``text/audio_backend.py``).

The reference's 2/3-input experiments embed raw audio through wav2vec2
XLSR encoders: ``inp_model(inp)['extract_features'][:, 0, :]``
(centralized/Dementia_challenge_models.py:246-259 builds Wav2Vec2Model for
en/gr/multi/wv; :295-297 takes ``extract_features``, the layer-normed
conv-frontend features of width conv_dim=512, at frame 0). That is the
frozen conv feature extractor of the port's ``SSLBackbone``
(``FeatureEncoder`` + the ``FeatureProjection`` pre-projection LayerNorm),
run here on the device at bucketed lengths (the JAX package's padding, which
the first layer's GroupNorm sees), pooling frame 0.

Waveforms are zero-mean/unit-var normalized like HF's
Wav2Vec2FeatureExtractor(do_normalize=True) in the reference's
``_Tokenize`` audio path.
"""

from __future__ import annotations

import os
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..data.audio import load_audio, normalize_input_values
from ..models.backbone import FeatureEncoder
from ..models.config import BackboneConfig


def _round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def make_ssl_audio_backend(
    cfg: BackboneConfig | None = None,
    params: Mapping[str, torch.Tensor] | None = None,
    audio_root: str | None = None,
    seed: int = 0,
    batch_size: int = 8,
    max_seconds: float = 30.0,
    time_multiple: int = 4 * 16000,
    device: str | torch.device = "cuda",
) -> Callable[[Sequence[str]], np.ndarray]:
    """Build ``embed(paths) -> [N, conv_dim]`` from the frozen SSL conv
    frontend (reference ``extract_features[:, 0, :]`` semantics).

    ``params``: an ``SSLBackbone`` state dict (HF names; its
    ``feature_extractor.*`` and ``feature_projection.layer_norm.*`` entries
    are used); ``None`` draws the frontend from a generator seeded with
    ``seed`` (the LayerNorm at unit scale and zero bias, as flax inits it).
    ``audio_root`` resolves relative utterance paths."""
    from ..serving.engine import resolve_device

    device = resolve_device(device)
    cfg = cfg or BackboneConfig.wav2vec2_base_960h()
    with torch.device(device):
        enc = FeatureEncoder(cfg, torch.float32, torch.float32)
        ln = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
    if params is not None:
        for module, prefix in ((enc, "feature_extractor."),
                               (ln, "feature_projection.layer_norm.")):
            module.load_state_dict({k[len(prefix):]: torch.as_tensor(v) for k, v in params.items()
                                    if k.startswith(prefix)}, strict=True)
    else:
        gen = torch.Generator(device).manual_seed(seed)
        with torch.no_grad():
            for name, p in enc.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif p.ndim == 1:
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, int(np.prod(p.shape[1:])) ** -0.5, generator=gen)
    enc.eval()
    max_samples = int(max_seconds * 16000)

    def _load(path: str) -> np.ndarray:
        p = path if os.path.isabs(path) or audio_root is None else os.path.join(audio_root, path)
        if not os.path.exists(p) and not p.endswith(".wav"):
            p += ".wav"
        wav = load_audio(p, target_sr=16000, normalize=False)
        return normalize_input_values(wav[:max_samples])

    @torch.no_grad()
    def embed(paths: Sequence[str]) -> np.ndarray:
        out = []
        for i in range(0, len(paths), batch_size):
            chunk = [_load(p) for p in paths[i: i + batch_size]]
            width = _round_up(max(len(w) for w in chunk), time_multiple)
            iv = np.zeros((len(chunk), width), dtype=np.float32)
            for j, w in enumerate(chunk):
                iv[j, : len(w)] = w
            feats = enc(torch.from_numpy(iv).to(device))
            out.append(ln(feats[:, 0, :]).cpu().numpy().astype(np.float32))
        return np.concatenate(out, axis=0)

    return embed


# the reference's four audio backends all share the wav2vec conv-frontend
# architecture (conv_dim 512); one family config serves en/gr/multi/wv,
# differing only by checkpoint (Dementia_challenge_models.py:246-263)
AUDIO_BACKENDS = ("en", "gr", "multi", "wv")


def audio_backends_for(
    spec_backends: Sequence[str],
    audio_root: str | None,
    params_by_backend: Mapping[str, Mapping] | None = None,
    **kw,
) -> dict[str, Callable[[Sequence[str]], np.ndarray]]:
    """One SSL backend per audio backend named in a spec. Each backend gets
    its own init seed (``1000 + i``: distinct checkpoints in the reference)
    unless a state dict is supplied."""
    out = {}
    for i, name in enumerate(AUDIO_BACKENDS):
        if name not in spec_backends:
            continue
        out[name] = make_ssl_audio_backend(params=(params_by_backend or {}).get(name),
                                           audio_root=audio_root, seed=1000 + i, **kw)
    return out
