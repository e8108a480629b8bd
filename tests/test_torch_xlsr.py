"""XLS-R 2B (``facebook/wav2vec2-xls-r-2b``) in the port: the preset at the
published widths and depth, counted on the meta device; its layer layout
(pre-LN blocks, one weight-normed positional conv of even kernel) at a tiny
width through the port's stage-0 loss and gradients against the
benchmark's plain fp32 reference (``portbench/reference/ssl_dacs.py``); and
``--model_type xlsr-2b`` in the CLI. Its head dim 120 runs through the
attention kernels on the card only (``tests/test_torch_attention.py -m
cuda``)."""

import numpy as np
import pytest
import torch

from portbench.lib import inputs
from portbench.lib.program import dacs_config
from portbench.reference import ssl_dacs as ref
from portbench.tests.conftest import tiny_config
from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.models import BackboneConfig, DACSConfig
from privacy_preserve_federated_asr_tpu_torch.models.dacs import DACSModel
from privacy_preserve_federated_asr_tpu_torch.models.objectives import dacs_loss
from privacy_preserve_federated_asr_tpu_torch.models.recipes import stage_trainable_predicate
from test_torch_attention import one_torch_thread  # noqa: F401

CONFIG = "wav2vec2-xls-r-2b.dacs"


def test_preset_widths_depth_and_stage0_count():
    """48 x 1920, 16 heads of 120, FFN 7680 and the kernel-128 conv of 16
    groups; stage 0 trains ~2.16B parameters, the same set the reference
    names."""
    cfg = BackboneConfig.wav2vec2_xls_r_2b()
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.intermediate_size, cfg.head_dim) == (1920, 48, 16, 7680, 120)
    assert (cfg.pos_conv_type, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups,
            cfg.do_stable_layer_norm, cfg.feat_extract_norm) == ("single", 128, 16, True, "layer")
    with torch.device("meta"):
        model = DACSModel(DACSConfig(backbone=cfg, stage=0))
    params = dict(model.named_parameters())
    assert params["backbone.encoder.pos_conv_embed.conv.weight"].shape == (1920, 120, 128)
    assert params["backbone.encoder.layers.47.feed_forward.intermediate_dense.weight"].shape \
        == (7680, 1920)
    pred = stage_trainable_predicate(0)
    trained = {k for k in params if pred(tuple(k.split(".")))}
    assert trained == {k for k in params if ref.stage0_trainable(k)}
    count = sum(params[k].numel() for k in trained)
    assert 2.15e9 < count < 2.17e9, count


def test_tiny_stage0_loss_and_gradients_match_reference_fp32():
    """The configuration file's layout at a tiny width (pre-LN, the single
    conv of even kernel 8, whose last frame is dropped), dropout 0: the
    port's stage-0 loss and every trained gradient against the reference's."""
    ref.fp32_only()
    cfg = tiny_config(CONFIG)
    assert cfg["do_stable_layer_norm"] and cfg["pos_conv_type"] == "single"
    cfg.update(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    w = inputs.draw_weights(cfg, 11, "cpu")
    model = DACSModel(dacs_config(cfg, stage=0))
    model.load_state_dict(w)
    model.train()
    r = inputs.rng(11, 0)
    lens = np.array([12000, 8000])
    audio = ref.pad_rows([ref.normalize(inputs.audio(r, n)) for n in lens], 12000)
    labels = r.integers(4, 32, size=(2, 5)).astype(np.int32)
    out = model(torch.from_numpy(audio), torch.from_numpy(lens.astype(np.int32)),
                need_masks=False)
    loss, _ = dacs_loss(out, torch.from_numpy(labels), torch.tensor([5, 5]), torch.zeros(2),
                        model.cfg, model.similar_fc.weight, aux_metrics=False)
    loss.backward()
    wr = {k: v.clone() for k, v in w.items()}
    trainable = {k: t.requires_grad_() for k, t in wr.items() if ref.stage0_trainable(k)}
    plan = ref.DropoutPlan(cfg, 2, ref.conv_out_frames(cfg, 12000), torch.Generator(), "cpu",
                           torch.float32)
    total, grads = ref.train_step_grads(cfg, wr, trainable, audio, lens, labels,
                                        np.array([5, 5]), plan, "cpu", block=1)
    assert total == pytest.approx(float(loss.detach()), rel=1e-5)
    params = dict(model.named_parameters())
    pred = stage_trainable_predicate(0)
    assert set(grads) == {k for k in params if pred(tuple(k.split(".")))}
    # the floor at the gradients' scale: the key biases' exact gradient is 0
    # (a shift shared by a query's keys leaves its softmax as it was), so
    # both sides hold rounding noise there, ~1e-9 in the pre-LN layout
    norms = sorted(float(g.norm()) for g in grads.values())
    floor = 1e-9 * norms[len(norms) // 2]
    for k, g in grads.items():  # two CTC implementations: compare by norm
        assert float((params[k].grad - g).norm()) <= 1e-4 * float(g.norm()) + floor, k


@pytest.mark.parametrize("cmd", ["train", "serve", "extract"])
def test_cli_knows_xlsr_2b(cmd):
    args = cli.build_parser().parse_args([cmd, "--model_type", "xlsr-2b", "-st", "0"])
    assert cli.BACKBONES[args.model_type] == "wav2vec2_xls_r_2b"
    assert cli._dacs_cfg(args).backbone == BackboneConfig.wav2vec2_xls_r_2b()
