"""Typed model configuration, the port's copy of the JAX package's
``models/config.py``.

One ``BackboneConfig`` covers the wav2vec2 / hubert / data2vec-audio /
unispeech-sat SSL encoder family; the structural switches are:

  * ``feat_extract_norm``: "layer" (LN after every conv; data2vec, *-lv60)
    vs "group" (GroupNorm after conv 0 only; base checkpoints),
  * ``pos_conv_type``: "stacked" (data2vec: N small grouped conv+LN+GELU
    layers) vs "single" (wav2vec2/hubert: one big weight-normed conv),
  * ``do_stable_layer_norm``: pre-norm (wav2vec2/hubert large) vs post-norm
    (data2vec, base checkpoints) transformer blocks.

``model_type="sew-d"`` selects the SEW-D backbone (models/sewd.py), which
reads the SEW-D fields (squeeze factor, relative-position buckets,
disentangled attention terms).

The fields are the subset of the JAX package's that serving and training
read, with the same names, defaults and presets, so a configuration (or a
golden fixture's metadata) means the same model in both packages.
``dense_impl`` picks the backbone's Dense matmuls: ``"fp"``, the inference
W8A8 ``"int8"`` or the trainable ``"int8_train"`` (ops/quant.py). The two
JAX fields left out belong to paths the port does not run
(``attention_impl``: the port always takes its kernel on the card;
``layerdrop``, unused under jit in JAX too).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class BackboneConfig:
    model_type: str = "data2vec-audio"
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5

    # feature extractor (conv frontend over raw 16 kHz waveform)
    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" | "group"
    feat_extract_activation: str = "gelu"

    # positional convolution
    pos_conv_type: str = "stacked"  # "stacked" (data2vec) | "single" (w2v2)
    num_conv_pos_embeddings: int = 5        # stacked: layer count; single: kernel
    conv_pos_kernel_size: int = 19          # stacked only
    num_conv_pos_embedding_groups: int = 16

    do_stable_layer_norm: bool = False

    # Dense matmuls of the projections and FFNs: "fp" | "int8" (dynamic
    # W8A8, inference) | "int8_train" (W8A8 with SwitchBack gradients)
    dense_impl: str = "fp"

    # SEW-D extras (squeezed encoder + DeBERTa-v2 disentangled attention)
    squeeze_factor: int = 1
    position_buckets: int = -1
    relative_attention: bool = False
    pos_att_type: tuple[str, ...] = ()
    norm_rel_ebd: str = "none"
    max_position_embeddings: int = 512
    feature_layer_norm_eps: float = 1e-5

    # SpecAugment (the reference trains with mask_time_prob=0)
    mask_time_prob: float = 0.0
    mask_time_length: int = 10
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10

    # dropouts (live only in training mode: ``model.train()``)
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    final_dropout: float = 0.0

    # CTC head / loss
    vocab_size: int = 32
    pad_token_id: int = 0
    ctc_loss_reduction: str = "sum"
    ctc_zero_infinity: bool = True

    def replace(self, **kw) -> "BackboneConfig":
        return dataclasses.replace(self, **kw)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    # ---- presets matching the HF checkpoints the reference sweeps over ----

    @classmethod
    def data2vec_audio_large(cls) -> "BackboneConfig":
        """facebook/data2vec-audio-large-960h (the reference flagship)."""
        return cls()

    @classmethod
    def data2vec_audio_base(cls) -> "BackboneConfig":
        return cls(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072)

    @classmethod
    def wav2vec2_large_960h_lv60(cls) -> "BackboneConfig":
        return cls(model_type="wav2vec2", conv_bias=True, feat_extract_norm="layer",
                   pos_conv_type="single", num_conv_pos_embeddings=128,
                   do_stable_layer_norm=True)

    @classmethod
    def wav2vec2_base_960h(cls) -> "BackboneConfig":
        return cls(model_type="wav2vec2", hidden_size=768, num_hidden_layers=12,
                   num_attention_heads=12, intermediate_size=3072, conv_bias=False,
                   feat_extract_norm="group", pos_conv_type="single",
                   num_conv_pos_embeddings=128, do_stable_layer_norm=False)

    @classmethod
    def hubert_large_ls960(cls) -> "BackboneConfig":
        return cls(model_type="hubert", conv_bias=True, feat_extract_norm="layer",
                   pos_conv_type="single", num_conv_pos_embeddings=128,
                   do_stable_layer_norm=True)

    @classmethod
    def sew_d_mid(cls) -> "BackboneConfig":
        """asapp/sew-d-mid-* family (HF SEWDConfig defaults)."""
        return cls(
            model_type="sew-d", hidden_size=768, num_hidden_layers=12,
            num_attention_heads=12, intermediate_size=3072,
            conv_dim=(64, 128, 128, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512),
            conv_kernel=(10, 3, 1, 3, 1, 3, 1, 3, 1, 2, 1, 2, 1),
            conv_stride=(5, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1),
            conv_bias=False, feat_extract_norm="group",
            pos_conv_type="single", num_conv_pos_embeddings=128,
            num_conv_pos_embedding_groups=16,
            squeeze_factor=2, position_buckets=256, relative_attention=True,
            pos_att_type=("p2c", "c2p"), norm_rel_ebd="layer_norm",
            max_position_embeddings=512, layer_norm_eps=1e-7,
            feature_layer_norm_eps=1e-5, hidden_act="gelu_python",
        )

    @classmethod
    def unispeech_sat_large(cls) -> "BackboneConfig":
        return cls(model_type="unispeech-sat", conv_bias=True, feat_extract_norm="layer",
                   pos_conv_type="single", num_conv_pos_embeddings=128,
                   do_stable_layer_norm=True)

    @classmethod
    def tiny_for_tests(cls, **kw) -> "BackboneConfig":
        base = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
                    conv_stride=(5, 2), num_conv_pos_embeddings=2,
                    conv_pos_kernel_size=5, num_conv_pos_embedding_groups=4,
                    vocab_size=32)
        base.update(kw)
        return cls(**base)


@dataclass(frozen=True)
class DACSConfig:
    """DACS task heads + objective knobs (reference: federated/src/models.py
    Data2VecAudioForCTC.__init__ :262-326 and forward :375-631)."""

    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    # method family (models/recipes.py): dacs | toggle_more | grl share
    # DACSModel; single_toggle | fsm have their own (models/variants.py)
    method: str = "dacs"
    stage: int = 2               # 0 = ASR fine-tune, 1 = AD head, 2 = toggling net
    lambda_grl: float = 0.5      # GRL strength (args.LAMBDA)
    gs_tau: float = 1.0          # gumbel-softmax temperature
    toggle_ratio: float = 0.0    # mask-propensity rescale knob
    ad_loss: str = "cel"         # cel | recall | prec | f1 | recall_ori | prec_ori
    w_loss: tuple[float, float] = (0.1, 0.9)  # HC / AD class weights
    am_loss_type: str = "cosface"
    num_ad_classes: int = 2
    # method="grl": gradient-reversed AD CE (reference --GRL flag, off there too)
    grl_reverse: bool = False
    # False reproduces the reference quirk: AD logits mean-pooled over *all*
    # timesteps, padding included (batch size 1 there)
    pool_valid_frames_only: bool = True
    num_lms: int = 1             # >1 adds the N-best multitask lm heads
    fsm_lm_thres: float = 0.5    # method="fsm": sigmoid mask thresholds
    fsm_ad_thres: float = 0.5

    @property
    def hidden_size(self) -> int:
        return self.backbone.hidden_size

    def resolve_compute(self, compute_dtype: str) -> tuple["DACSConfig", torch.dtype]:
        """(cfg, torch dtype) for an inference surface's ``compute_dtype``
        choice: "float32" / "bfloat16" pick the matmul dtype; "int8" is
        bf16 compute with dynamic-W8A8 Dense matmuls (ops/quant.py,
        inference only)."""
        if compute_dtype == "int8":
            return (self.replace(backbone=self.backbone.replace(dense_impl="int8")),
                    torch.bfloat16)
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if compute_dtype not in dtypes:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        return self, dtypes[compute_dtype]

    def replace(self, **kw) -> "DACSConfig":
        return dataclasses.replace(self, **kw)
