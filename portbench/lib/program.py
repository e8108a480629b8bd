"""The program under test, built from a configuration file: the port's
``DACSConfig`` with every backbone key the file states (the tests hold each
file to its port preset)."""

from __future__ import annotations

BACKBONE_KEYS = (
    "model_type", "hidden_size", "num_hidden_layers", "num_attention_heads",
    "intermediate_size", "hidden_act", "layer_norm_eps", "conv_dim", "conv_kernel",
    "conv_stride", "conv_bias", "feat_extract_norm", "feat_extract_activation",
    "pos_conv_type", "num_conv_pos_embeddings", "conv_pos_kernel_size",
    "num_conv_pos_embedding_groups", "do_stable_layer_norm", "mask_time_prob",
    "mask_feature_prob", "hidden_dropout", "attention_dropout", "activation_dropout",
    "feat_proj_dropout", "final_dropout", "vocab_size", "pad_token_id",
    "ctc_loss_reduction", "ctc_zero_infinity")


def backbone_kwargs(cfg: dict) -> dict:
    return {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k] for k in BACKBONE_KEYS}


def dacs_config(cfg: dict, stage: int, dense_impl: str = "fp"):
    """The port's ``DACSConfig`` for a configuration file at ``stage``."""
    from privacy_preserve_federated_asr_tpu_torch.models.config import (
        BackboneConfig,
        DACSConfig,
    )

    backbone = BackboneConfig(**backbone_kwargs(cfg), dense_impl=dense_impl)
    return DACSConfig(backbone=backbone, method=cfg["method"], stage=stage,
                      gs_tau=cfg["gs_tau"], toggle_ratio=cfg["toggle_ratio"],
                      num_ad_classes=2)
