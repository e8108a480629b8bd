"""SSL speech-encoder backbone family in PyTorch (the port's
``models/backbone.py``): data2vec-audio, wav2vec2, hubert, unispeech-sat.

Modules keep the HF attribute names, so an HF or ForCTC state dict maps onto
them by a prefix strip and the weight-norm merge (``models/port.py``).

Dtype policy, as flax's ``param_dtype``/``dtype`` in the JAX package:
convolutions and matmuls store their weights in ``param_dtype`` and cast
weights and inputs to the compute ``dtype`` at use (training holds fp32
params and computes in bf16; serving stores bf16, where the cast is a
no-op). LayerNorm and GroupNorm keep fp32 parameters and statistics (input
upcast to fp32, normalised, then cast to the compute dtype where the JAX
path casts). ``torch.autocast`` is not used: it casts at other places.
Tensors are ``[B, T, C]`` between modules, like the JAX package's layout.

Training parts (live in ``train()`` mode only): feat-proj, hidden,
activation and attention dropout (the latter inside the attention kernel,
as a rate and a host seed per layer), SpecAugment, and the
``precomputed_features`` entry that skips the frozen conv frontend.
LayerDrop is not implemented, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dropout_seed, hash_stride, multihead_attention
from ..ops.quant import int8_linear, int8_train_linear
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


_DENSE = {"fp": None, "int8": int8_linear, "int8_train": int8_train_linear}


def _layer_norm(ln: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in fp32 (fp32 params), result cast to ``dtype``."""
    return ln(x.float()).to(dtype)


class Linear(nn.Linear):
    """flax ``Dense``: params stored in ``param_dtype``, inputs and params
    cast to ``dtype`` at use. ``dense_impl`` "int8" / "int8_train" runs the
    matmul as W8A8 (ops/quant.py) and adds the bias after it, in ``dtype``,
    as flax does; the default "fp" is one ``F.linear``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 dtype: torch.dtype, param_dtype: torch.dtype, dense_impl: str = "fp"):
        super().__init__(in_features, out_features, bias=bias, dtype=param_dtype)
        if dense_impl not in _DENSE:
            raise ValueError(f"unknown dense_impl {dense_impl!r}")
        self.compute_dtype, self.dense_impl = dtype, dense_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        matmul = _DENSE[self.dense_impl]
        if matmul is None:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        y = matmul(x.to(dt), self.weight.to(dt))
        return y if bias is None else y + bias


class Conv1d(nn.Conv1d):
    """flax ``Conv`` over ``[B, C, T]``: params stored in ``param_dtype``,
    cast to ``dtype`` at use."""

    def __init__(self, *args, dtype: torch.dtype, param_dtype: torch.dtype, **kw):
        super().__init__(*args, dtype=param_dtype, **kw)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvLayer(nn.Module):
    """One feature-extractor conv + (layer|group) norm + activation."""

    def __init__(self, cfg: BackboneConfig, layer_id: int, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.cfg, self.layer_id = cfg, layer_id
        in_dim = cfg.conv_dim[layer_id - 1] if layer_id > 0 else 1
        out_dim = cfg.conv_dim[layer_id]
        self.conv = Conv1d(in_dim, out_dim, cfg.conv_kernel[layer_id],
                           stride=cfg.conv_stride[layer_id], bias=cfg.conv_bias,
                           dtype=dtype, param_dtype=param_dtype)
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

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv_layers = nn.ModuleList(
            ConvLayer(cfg, i, dtype, param_dtype) for i in range(len(cfg.conv_dim)))

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        x = input_values[:, None, :].to(self.dtype)
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size, dtype=dtype,
                                 param_dtype=param_dtype, dense_impl=cfg.dense_impl)
        self.dropout = nn.Dropout(cfg.feat_proj_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the LayerNorm has no dtype in JAX: fp32 out, cast before the Dense
        return self.dropout(self.projection(_layer_norm(self.layer_norm, x, self.dtype)))


class StackedPosConvLayer(nn.Module):
    """data2vec positional conv block: grouped conv + non-affine LN + GELU."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        k = cfg.conv_pos_kernel_size
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                           groups=cfg.num_conv_pos_embedding_groups, dtype=dtype,
                           param_dtype=param_dtype)
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

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        if cfg.pos_conv_type == "stacked":
            self.layers = nn.ModuleList(StackedPosConvLayer(cfg, dtype, param_dtype)
                                        for _ in range(cfg.num_conv_pos_embeddings))
        else:
            k = cfg.num_conv_pos_embeddings
            self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, k, padding=k // 2,
                               groups=cfg.num_conv_pos_embedding_groups, dtype=dtype,
                               param_dtype=param_dtype)

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
    (the CUDA kernels on the card, the plain versions on the CPU); in
    training the attention dropout runs inside the kernel from ``seed``."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        kw = dict(dtype=dtype, param_dtype=param_dtype, dense_impl=cfg.dense_impl)
        self.q_proj = Linear(d, d, **kw)
        self.k_proj = Linear(d, d, **kw)
        self.v_proj = Linear(d, d, **kw)
        self.out_proj = Linear(d, d, **kw)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None,
                seed: int = 0) -> torch.Tensor:
        b, t, _ = x.shape
        h, d = self.cfg.num_attention_heads, self.cfg.head_dim
        q = self.q_proj(x).view(b, t, h, d)
        k = self.k_proj(x).view(b, t, h, d)
        v = self.v_proj(x).view(b, t, h, d)
        rate = self.cfg.attention_dropout if self.training else 0.0
        ctx = multihead_attention(q, k, v, key_mask, rate, seed, hash_stride(t))
        return self.out_proj(ctx.reshape(b, t, h * d))


class FeedForward(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.act = ACT2FN[cfg.hidden_act]
        kw = dict(dtype=dtype, param_dtype=param_dtype, dense_impl=cfg.dense_impl)
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.activation_dropout = nn.Dropout(cfg.activation_dropout)
        self.hidden_dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.activation_dropout(self.act(self.intermediate_dense(x)))
        return self.hidden_dropout(self.output_dense(x))


class EncoderLayer(nn.Module):
    """Transformer block; post-norm (data2vec) or pre-norm (stable-LN)."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.attention = Attention(cfg, dtype, param_dtype)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.feed_forward = FeedForward(cfg, dtype, param_dtype)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None,
                seed: int = 0) -> torch.Tensor:
        dt = self.dtype
        if self.cfg.do_stable_layer_norm:  # pre-norm
            x = x + self.dropout(self.attention(
                _layer_norm(self.layer_norm, x, dt), key_mask, seed))
            return x + self.feed_forward(_layer_norm(self.final_layer_norm, x, dt))
        x = x + self.dropout(self.attention(x, key_mask, seed))  # post-norm (data2vec)
        x = _layer_norm(self.layer_norm, x, dt)
        x = x + self.feed_forward(x)
        return _layer_norm(self.final_layer_norm, x, dt)


class Encoder(nn.Module):
    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.pos_conv_embed = PositionalConvEmbedding(cfg, dtype, param_dtype)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype, param_dtype)
                                    for _ in range(cfg.num_hidden_layers))
        # remat (the JAX ``nn.remat(EncoderLayer)``): each layer's
        # activations are recomputed in the backward pass
        self.remat = False

    def forward(self, x: torch.Tensor, frame_mask: torch.Tensor | None = None,
                seed_generator: torch.Generator | None = None) -> torch.Tensor:
        if frame_mask is not None:
            x = x * frame_mask.to(self.dtype)[:, :, None]  # zero padded frames before pos conv
        x = x + self.pos_conv_embed(x)
        if not self.cfg.do_stable_layer_norm:
            x = _layer_norm(self.layer_norm, x, self.dtype)
        x = self.dropout(x)
        draw = self.training and self.cfg.attention_dropout > 0.0
        for layer in self.layers:
            # the seed is drawn outside the checkpoint, so the recompute's
            # attention kernel sees it again; preserve_rng_state replays the
            # other dropout masks
            seed = dropout_seed(seed_generator) if draw else 0
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, frame_mask, seed, use_reentrant=False,
                               preserve_rng_state=True)
            else:
                x = layer(x, frame_mask, seed)
        if self.cfg.do_stable_layer_norm:
            x = _layer_norm(self.layer_norm, x, self.dtype)
        return x


def sample_span_mask(shape: tuple[int, int], mask_prob: float, mask_length: int,
                     valid_mask: torch.Tensor | None = None,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """SpecAugment span sampling as the JAX package does it: Bernoulli span
    *starts* at rate ``mask_prob / mask_length`` (expected coverage =
    mask_prob), dilated to ``mask_length`` frames by a max window. Draws
    from the default generator of ``device``."""
    b, t = shape
    starts = torch.rand((b, t), device=device) < mask_prob / mask_length
    if valid_mask is not None:
        starts = starts & valid_mask.bool()
    spans = F.max_pool1d(F.pad(starts.float()[:, None], (mask_length - 1, 0)),
                         mask_length, stride=1)[:, 0]
    return spans.bool()


class SSLBackbone(nn.Module):
    """Full SSL speech encoder: waveform [B, T] -> embeddings [B, T', D]
    (HF ``Data2VecAudioModel`` / ``Wav2Vec2Model`` / ``HubertModel``)."""

    def __init__(self, cfg: BackboneConfig, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None):
        super().__init__()
        param_dtype = dtype if param_dtype is None else param_dtype
        self.cfg, self.dtype = cfg, dtype
        self.feature_extractor = FeatureEncoder(cfg, dtype, param_dtype)
        self.feature_projection = FeatureProjection(cfg, dtype, param_dtype)
        if cfg.mask_time_prob > 0:
            # SpecAugment's learned time-mask embedding (fp32, like LN params)
            self.masked_spec_embed = nn.Parameter(torch.empty(cfg.hidden_size).uniform_())
        self.encoder = Encoder(cfg, dtype, param_dtype)

    def forward(self, input_values: torch.Tensor | None,
                frame_mask: torch.Tensor | None = None,
                precomputed_features: torch.Tensor | None = None,
                seed_generator: torch.Generator | None = None) -> torch.Tensor:
        """``precomputed_features`` (the frozen conv frontend's output, which
        the stage-0 trainer caches) replaces the feature extractor.
        ``seed_generator``: the CPU generator the attention-dropout seeds come
        from in training (default: torch's default CPU generator)."""
        cfg = self.cfg
        if precomputed_features is not None:
            feats = precomputed_features
        else:
            feats = self.feature_extractor(input_values)
        x = self.feature_projection(feats)
        if self.training and (cfg.mask_time_prob > 0 or cfg.mask_feature_prob > 0):
            x = self._spec_augment(x, frame_mask)
        return self.encoder(x, frame_mask, seed_generator)

    def _spec_augment(self, x: torch.Tensor, frame_mask: torch.Tensor | None) -> torch.Tensor:
        """Masked time spans are replaced by the learned embedding; masked
        feature spans are zeroed (HF ``_mask_hidden_states``)."""
        cfg = self.cfg
        b, t, d = x.shape
        if cfg.mask_time_prob > 0:
            tm = sample_span_mask((b, t), cfg.mask_time_prob, cfg.mask_time_length,
                                  frame_mask, x.device)
            x = torch.where(tm[:, :, None], self.masked_spec_embed.to(x.dtype), x)
        if cfg.mask_feature_prob > 0:
            fm = sample_span_mask((b, d), cfg.mask_feature_prob, cfg.mask_feature_length,
                                  device=x.device)
            x = torch.where(fm[:, None, :], torch.zeros((), dtype=x.dtype,
                                                        device=x.device), x)
        return x
