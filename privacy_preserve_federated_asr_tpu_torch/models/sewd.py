"""SEW-D backbone in PyTorch (the port's ``models/sewd.py``): Squeezed and
Efficient Wav2vec with DeBERTa-v2 disentangled attention, the fifth backbone
family of the reference's sweep (centralized/functions/OtherMdls_*.py
``SEWDForCTC``).

Architecture, as HF ``SEWDModel`` and the JAX package's ``SEWDBackbone``:
  13-layer conv frontend (GroupNorm on conv 0 only; the port's
  ``FeatureEncoder``) -> feature LayerNorm -> projection to the hidden width
  -> encoder: zero the padding frames, strided weight-normed positional conv
  (stride = squeeze factor; an even kernel drops its last frame) plus an
  average-pool squeeze, both cut to the shorter length -> post-norm
  DeBERTa-v2 layers (content + c2p + p2c attention over log-bucketed
  relative positions, with shared, layer-normed relative embeddings; padded
  keys biased by -1e9) -> linear upsample back to the conv frame rate,
  zero-padded to it.

Modules keep HF's attribute names (``encoder.encoder.layer.N.attention.
self.query_proj``, ``encoder.encoder.rel_embeddings``, ``encoder.upsample.
projection``), so an HF SEW-D state dict loads by a prefix strip and the
weight-norm merge of the positional conv (``models/port.py``).

The attention runs as torch ops, as the JAX package runs it as XLA einsums:
its scores add the c2p and p2c terms, which the flash-attention kernel does
not compute, so no SEW-D path launches it. Score products accumulate in
fp32 (the JAX ``preferred_element_type``). The dtype policy is the SSL
backbone's (``models/backbone.py``): matmul and conv weights in
``param_dtype``, cast at use; LayerNorm, GroupNorm and the relative
embeddings in fp32. Every Dense of the JAX code honours ``dense_impl``
(W8A8 through ``ops/quant.py``). Training parts live in ``train()`` mode
only (feature, attention-probability and hidden dropout); the JAX SEW-D has
no SpecAugment, and neither has this one.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .backbone import ACT2FN, Conv1d, FeatureEncoder, Linear, _layer_norm
from .config import BackboneConfig


def make_log_bucket_position(relative_pos: np.ndarray, bucket_size: int,
                             max_position: int) -> np.ndarray:
    """DeBERTa-v2 log-bucketed relative positions (numpy, as the JAX
    package computes them)."""
    sign = np.sign(relative_pos)
    mid = bucket_size // 2
    abs_pos = np.where((relative_pos < mid) & (relative_pos > -mid), mid - 1,
                       np.abs(relative_pos))
    log_pos = (np.ceil(np.log(abs_pos / mid) / np.log((max_position - 1) / mid)
                       * (mid - 1)) + mid)
    return np.where(abs_pos <= mid, relative_pos.astype(log_pos.dtype), log_pos * sign)


@functools.lru_cache(maxsize=64)
def build_relative_position(q_len: int, k_len: int, bucket_size: int,
                            max_position: int) -> np.ndarray:
    """``[q_len, k_len]`` int32 relative positions ``q - k``, log-bucketed
    when ``bucket_size`` and ``max_position`` are positive."""
    rel = np.arange(q_len)[:, None] - np.arange(k_len)[None, :]
    if bucket_size > 0 and max_position > 0:
        rel = make_log_bucket_position(rel, bucket_size, max_position)
    rel = rel.astype(np.int32)
    rel.flags.writeable = False  # cached: shared by every caller
    return rel


def _span(cfg: BackboneConfig) -> int:
    return cfg.position_buckets if cfg.position_buckets > 0 else cfg.max_position_embeddings


class DisentangledSelfAttention(nn.Module):
    """DeBERTa-v2 attention: content-content + c2p + p2c terms."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.hidden_size
        kw = dict(dtype=dtype, param_dtype=param_dtype, dense_impl=cfg.dense_impl)
        self.query_proj = Linear(d, d, **kw)
        self.key_proj = Linear(d, d, **kw)
        self.value_proj = Linear(d, d, **kw)

    def forward(self, x: torch.Tensor, rel_embeddings: torch.Tensor,
                c2p_pos: torch.Tensor, p2c_pos: torch.Tensor,
                key_bias: torch.Tensor | None) -> torch.Tensor:
        """``c2p_pos`` / ``p2c_pos``: ``[T, T]`` int64 indices into the
        ``2 * span`` relative embeddings (``clip(+-rp + span)``)."""
        c = self.cfg
        h, d = c.num_attention_heads, c.head_dim
        b, t, _ = x.shape
        span2 = 2 * _span(c)
        q = self.query_proj(x).view(b, t, h, d)
        k = self.key_proj(x).view(b, t, h, d)
        v = self.value_proj(x).view(b, t, h, d)
        scale = math.sqrt(d * (1 + len(c.pos_att_type)))
        qf, kf = q.float(), k.float()
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / scale
        if c.relative_attention:
            # shared att key: the q/k projections of the relative embeddings
            rel = rel_embeddings[None, :span2].to(self.dtype)
            idx = (b, h, t, t)
            if "c2p" in c.pos_att_type:
                pos_k = self.key_proj(rel).view(span2, h, d).float()
                c2p = torch.einsum("bqhd,shd->bhqs", qf, pos_k)
                scores = scores + torch.gather(c2p, -1, c2p_pos.expand(idx)) / scale
            if "p2c" in c.pos_att_type:
                pos_q = self.query_proj(rel).view(span2, h, d).float()
                p2c = torch.einsum("bkhd,shd->bhks", kf, pos_q)
                # gathered along the key axis's own row, then transposed
                g = torch.gather(p2c, -1, p2c_pos.expand(idx))
                scores = scores + g.transpose(-1, -2) / scale
        if key_bias is not None:
            scores = scores + key_bias
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        probs = F.dropout(probs, c.attention_dropout, self.training)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, h * d)


class _DenseLayerNorm(nn.Module):
    """HF's ``dense`` + ``LayerNorm`` (+ dropout) of a residual branch:
    ``LN(residual + dropout(dense(x)))``, the LN in fp32."""

    def __init__(self, cfg: BackboneConfig, d_in: int, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.dense = Linear(d_in, cfg.hidden_size, dtype=dtype, param_dtype=param_dtype,
                            dense_impl=cfg.dense_impl)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return _layer_norm(self.LayerNorm, residual + self.dropout(self.dense(x)), self.dtype)


class SEWDAttention(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.self = DisentangledSelfAttention(cfg, dtype, param_dtype)
        self.output = _DenseLayerNorm(cfg, cfg.hidden_size, dtype, param_dtype)


class SEWDIntermediate(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.intermediate_size, dtype=dtype,
                            param_dtype=param_dtype, dense_impl=cfg.dense_impl)


class SEWDLayer(nn.Module):
    """Post-norm BERT-style block with disentangled attention."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.act = ACT2FN[cfg.hidden_act]
        self.attention = SEWDAttention(cfg, dtype, param_dtype)
        self.intermediate = SEWDIntermediate(cfg, dtype, param_dtype)
        self.output = _DenseLayerNorm(cfg, cfg.intermediate_size, dtype, param_dtype)

    def forward(self, x, rel_embeddings, c2p_pos, p2c_pos, key_bias):
        attn = self.attention.self(x, rel_embeddings, c2p_pos, p2c_pos, key_bias)
        x = self.attention.output(attn, x)
        return self.output(self.act(self.intermediate.dense(x)), x)


class SEWDTransformerEncoder(nn.Module):
    """The DeBERTa-v2 stack with its shared relative embeddings (fp32, as
    the JAX package's param) and their LayerNorm."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.layer = nn.ModuleList(SEWDLayer(cfg, dtype, param_dtype)
                                   for _ in range(cfg.num_hidden_layers))
        self.rel_embeddings = nn.Embedding(2 * _span(cfg), cfg.hidden_size)
        if "layer_norm" in cfg.norm_rel_ebd:
            self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class SEWDPositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                           stride=cfg.squeeze_factor,
                           groups=cfg.num_conv_pos_embedding_groups, dtype=dtype,
                           param_dtype=param_dtype)


class SEWDUpsampling(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.projection = Linear(cfg.hidden_size, cfg.hidden_size * cfg.squeeze_factor,
                                 dtype=dtype, param_dtype=param_dtype,
                                 dense_impl=cfg.dense_impl)


class SEWDEncoder(nn.Module):
    """Positional conv + squeeze, the transformer, the upsample."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.pos_conv_embed = SEWDPositionalConvEmbedding(cfg, dtype, param_dtype)
        self.encoder = SEWDTransformerEncoder(cfg, dtype, param_dtype)
        self.upsample = SEWDUpsampling(cfg, dtype, param_dtype)
        # remat (the JAX ``nn.remat(SEWDLayer)``): each layer's activations
        # are recomputed in the backward pass
        self.remat = False
        self._rel_index: dict = {}

    def _relative_index(self, t: int, device: torch.device):
        """``(c2p_pos, p2c_pos)`` for ``t`` squeezed frames on ``device``,
        kept per (t, device): they depend on the length only."""
        key = (t, str(device))
        if key not in self._rel_index:
            c = self.cfg
            span = _span(c)
            rp = build_relative_position(t, t, c.position_buckets, c.max_position_embeddings)
            self._rel_index[key] = tuple(
                torch.from_numpy(np.clip(s * rp.astype(np.int64) + span, 0, 2 * span - 1)
                                 ).to(device)
                for s in (1, -1))
        return self._rel_index[key]

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor | None) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        b, t_conv, d = x.shape
        sq = c.squeeze_factor
        if frame_mask is not None:
            x = x * frame_mask.to(dt)[:, :, None]
        pos = self.pos_conv_embed.conv(x.transpose(1, 2))
        if c.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :, :-1]
        pos = ACT2FN[c.feat_extract_activation](pos).transpose(1, 2)
        t_pool = t_conv // sq
        pooled = x[:, : t_pool * sq].reshape(b, t_pool, sq, d).mean(2)
        t_inner = min(pos.shape[1], t_pool)
        h = pooled[:, :t_inner] + pos[:, :t_inner]

        key_bias = None
        if frame_mask is not None:
            inner_lengths = frame_mask.sum(1) // sq
            valid = torch.arange(t_inner, device=x.device)[None, :] < inner_lengths[:, None]
            key_bias = torch.where(valid[:, None, None, :], 0.0, -1e9).to(torch.float32)

        enc = self.encoder
        rel = enc.rel_embeddings.weight
        if hasattr(enc, "LayerNorm"):
            rel = enc.LayerNorm(rel.float())
        c2p_pos, p2c_pos = self._relative_index(t_inner, x.device)
        for layer in enc.layer:
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(layer, h, rel, c2p_pos, p2c_pos, key_bias,
                               use_reentrant=False, preserve_rng_state=True)
            else:
                h = layer(h, rel, c2p_pos, p2c_pos, key_bias)

        up = ACT2FN[c.feat_extract_activation](self.upsample.projection(h))
        up = up.reshape(b, t_inner * sq, d)
        if up.shape[1] < t_conv:
            up = F.pad(up, (0, 0, 0, t_conv - up.shape[1]))
        return up


class SEWDBackbone(nn.Module):
    """SEW-D speech encoder: waveform [B, T] -> embeddings [B, T', D] at the
    conv frame rate (HF ``SEWDModel``). The signature is
    :class:`SSLBackbone`'s; ``seed_generator`` is accepted and unused (the
    attention here is not the kernel and draws its dropout from torch's
    generator)."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        param_dtype = dtype if param_dtype is None else param_dtype
        self.cfg, self.dtype = cfg, dtype
        self.feature_extractor = FeatureEncoder(cfg, dtype, param_dtype)
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.feature_layer_norm_eps)
        if cfg.conv_dim[-1] != cfg.hidden_size:
            self.feature_projection = Linear(cfg.conv_dim[-1], cfg.hidden_size, dtype=dtype,
                                             param_dtype=param_dtype,
                                             dense_impl=cfg.dense_impl)
        self.feature_dropout = nn.Dropout(cfg.feat_proj_dropout)
        self.encoder = SEWDEncoder(cfg, dtype, param_dtype)

    def forward(self, input_values: torch.Tensor | None,
                frame_mask: torch.Tensor | None = None,
                precomputed_features: torch.Tensor | None = None,
                seed_generator: torch.Generator | None = None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        del seed_generator, rows  # no SpecAugment, no kernel dropout here
        feats = (precomputed_features if precomputed_features is not None
                 else self.feature_extractor(input_values))
        x = _layer_norm(self.layer_norm, feats, self.dtype)
        if hasattr(self, "feature_projection"):
            x = self.feature_projection(x)
        return self.encoder(self.feature_dropout(x), frame_mask)
