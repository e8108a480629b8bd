"""SSL speech-encoder backbone family in PyTorch (the port's
``models/backbone.py``): data2vec-audio, wav2vec2, hubert, unispeech-sat.

Inference only: no SpecAugment, no dropout, no LayerDrop. Modules keep the
HF attribute names, so an HF or ForCTC state dict maps onto them by a prefix
strip and the weight-norm merge (``models/port.py``).

Dtype policy, as in the JAX package: convolutions and matmuls hold their
weights in the compute dtype and run in it; LayerNorm and GroupNorm keep
fp32 parameters and statistics (input upcast to fp32, normalised, then cast
to the compute dtype where the JAX path casts). Tensors are ``[B, T, C]``
between modules, like the JAX package's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multihead_attention
from .config import BackboneConfig

ACT2FN = {
    "gelu": lambda x: F.gelu(x),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_python": lambda x: F.gelu(x),
    "relu": F.relu,
    "tanh": torch.tanh,
}


def feat_extract_output_lengths(cfg: BackboneConfig, input_lengths):
    """Waveform sample count -> encoder frame count, ``(len - k) // s + 1``
    per conv layer with floor division (so a zero-length padding row gives
    a negative count, as in JAX). Takes a Python int or an integer tensor."""
    lengths = input_lengths
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = (lengths - k) // s + 1
    return lengths


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in fp32 (fp32 params), result cast to ``dtype``."""
    return ln(x.float()).to(dtype)


class ConvLayer(nn.Module):
    """One feature-extractor conv + (layer|group) norm + activation."""

    def __init__(self, cfg: BackboneConfig, layer_id: int, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.layer_id = cfg, layer_id
        in_dim = cfg.conv_dim[layer_id - 1] if layer_id > 0 else 1
        out_dim = cfg.conv_dim[layer_id]
        self.conv = nn.Conv1d(in_dim, out_dim, cfg.conv_kernel[layer_id],
                              stride=cfg.conv_stride[layer_id],
                              bias=cfg.conv_bias, dtype=dtype)
        self.dtype = dtype
        if cfg.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(out_dim, eps=1e-5)
        elif cfg.feat_extract_norm == "group" and layer_id == 0:
            # per-channel norm over time (torch GroupNorm(C, C))
            self.layer_norm = nn.GroupNorm(out_dim, out_dim, eps=1e-5)
        else:
            self.layer_norm = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C_in, T]
        x = self.conv(x)
        if isinstance(self.layer_norm, nn.LayerNorm):
            x = _layer_norm(self.layer_norm, x.transpose(1, 2), self.dtype).transpose(1, 2)
        elif self.layer_norm is not None:
            x = self.layer_norm(x.float()).to(self.dtype)
        return ACT2FN[self.cfg.feat_extract_activation](x)


class FeatureEncoder(nn.Module):
    """Raw waveform [B, T] -> conv features [B, T', C]."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv_layers = nn.ModuleList(
            ConvLayer(cfg, i, dtype) for i in range(len(cfg.conv_dim)))

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        x = input_values[:, None, :].to(self.dtype)
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the LayerNorm has no dtype in JAX: fp32 out, cast before the Dense
        return self.projection(_layer_norm(self.layer_norm, x, self.dtype))


class StackedPosConvLayer(nn.Module):
    """data2vec positional conv block: grouped conv + non-affine LN + GELU."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        k = cfg.conv_pos_kernel_size
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups, dtype=dtype)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5,
                                       elementwise_affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, D, T]
        x = self.conv(x)
        if self.cfg.conv_pos_kernel_size % 2 == 0:  # even kernel: one extra frame
            x = x[:, :, :-1]
        x = _layer_norm(self.layer_norm, x.transpose(1, 2), self.dtype).transpose(1, 2)
        return ACT2FN[self.cfg.feat_extract_activation](x)


class PositionalConvEmbedding(nn.Module):
    """``stacked`` = data2vec's N small grouped conv+LN+GELU layers;
    ``single`` = wav2vec2/hubert's one wide grouped conv (its weight norm is
    merged into a plain weight at load time, models/port.py)."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        if cfg.pos_conv_type == "stacked":
            self.layers = nn.ModuleList(StackedPosConvLayer(cfg, dtype)
                                        for _ in range(cfg.num_conv_pos_embeddings))
        else:
            k = cfg.num_conv_pos_embeddings
            self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                                  groups=cfg.num_conv_pos_embedding_groups, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, D]
        x = x.transpose(1, 2)
        if self.cfg.pos_conv_type == "stacked":
            for layer in self.layers:
                x = layer(x)
        else:
            x = self.conv(x)
            if self.cfg.num_conv_pos_embeddings % 2 == 0:
                x = x[:, :, :-1]
            x = ACT2FN[self.cfg.feat_extract_activation](x)
        return x.transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention through ``ops.attention.multihead_attention``
    (the CUDA kernel on the card, the plain version on the CPU)."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, d, dtype=dtype)
        self.k_proj = nn.Linear(d, d, dtype=dtype)
        self.v_proj = nn.Linear(d, d, dtype=dtype)
        self.out_proj = nn.Linear(d, d, dtype=dtype)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
        b, t, _ = x.shape
        h, d = self.cfg.num_attention_heads, self.cfg.head_dim
        q = self.q_proj(x).view(b, t, h, d)
        k = self.k_proj(x).view(b, t, h, d)
        v = self.v_proj(x).view(b, t, h, d)
        ctx = multihead_attention(q, k, v, key_mask)
        return self.out_proj(ctx.reshape(b, t, h * d))


class FeedForward(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype):
        super().__init__()
        self.act = ACT2FN[cfg.hidden_act]
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                            dtype=dtype)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                      dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(self.act(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Transformer block; post-norm (data2vec) or pre-norm (stable-LN)."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.attention = Attention(cfg, dtype)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg, dtype)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
        dt = self.dtype
        if self.cfg.do_stable_layer_norm:  # pre-norm
            x = x + self.attention(_layer_norm(self.layer_norm, x, dt), key_mask)
            return x + self.feed_forward(_layer_norm(self.final_layer_norm, x, dt))
        x = x + self.attention(x, key_mask)  # post-norm (data2vec audio)
        x = _layer_norm(self.layer_norm, x, dt)
        x = x + self.feed_forward(x)
        return _layer_norm(self.final_layer_norm, x, dt)


class Encoder(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.pos_conv_embed = PositionalConvEmbedding(cfg, dtype)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor,
                frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        if frame_mask is not None:
            x = x * frame_mask.to(self.dtype)[:, :, None]  # zero padded frames before pos conv
        x = x + self.pos_conv_embed(x)
        if not self.cfg.do_stable_layer_norm:
            x = _layer_norm(self.layer_norm, x, self.dtype)
        for layer in self.layers:
            x = layer(x, frame_mask)
        if self.cfg.do_stable_layer_norm:
            x = _layer_norm(self.layer_norm, x, self.dtype)
        return x


class SSLBackbone(nn.Module):
    """Full SSL speech encoder: waveform [B, T] -> embeddings [B, T', D]
    (HF ``Data2VecAudioModel`` / ``Wav2Vec2Model`` / ``HubertModel``)."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.feature_extractor = FeatureEncoder(cfg, dtype)
        self.feature_projection = FeatureProjection(cfg, dtype)
        self.encoder = Encoder(cfg, dtype)

    def forward(self, input_values: torch.Tensor,
                frame_mask: torch.Tensor | None = None) -> torch.Tensor:
        feats = self.feature_extractor(input_values)
        return self.encoder(self.feature_projection(feats), frame_mask)
