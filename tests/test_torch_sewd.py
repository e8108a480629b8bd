"""The port's SEW-D backbone (privacy_preserve_federated_asr_tpu_torch/models/
sewd.py) against the JAX package's ``SEWDBackbone`` on the CPU: DACS on a
tiny random SEW-D at fp32 on ragged lengths (the backbone's output, the
heads, the stage-0 loss and every gradient), its int8 forward, an HF SEW-D
checkpoint through the port's CLI loader, and the export refusal. The HF
golden (``golden_sewd.npz``) is the fifth case of
tests/test_torch_backbone.py::test_golden_hf_state_dict_strict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu.models import (
    BackboneConfig as JaxBackboneConfig,
    DACSConfig as JaxDACSConfig,
    DACSModel as JaxDACSModel,
)
from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    DACSModel,
    feat_extract_output_lengths,
    flax_from_state_dict,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.models.export import export_for_ctc_state_dict
from privacy_preserve_federated_asr_tpu_torch.models.objectives import dacs_loss
from privacy_preserve_federated_asr_tpu_torch.models.sewd import SEWDBackbone
from test_golden_port import _load
from test_torch_backbone import TINY, one_torch_thread, random_flax_params  # noqa: F401
from test_torch_quant import _share_close
from test_torch_train import _assert_tree_close

# tests/test_quant.py's tiny SEW-D at one layer, no dropout: an odd
# frame count (ragged rows) exercises the squeeze's cut and the upsample's pad
SEWD = dict(model_type="sew-d", hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
            intermediate_size=64, conv_dim=(16, 16, 24), conv_kernel=(10, 3, 1),
            conv_stride=(5, 2, 1), conv_bias=False, feat_extract_norm="group",
            pos_conv_type="single", num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, squeeze_factor=2, position_buckets=16,
            relative_attention=True, pos_att_type=("p2c", "c2p"), norm_rel_ebd="layer_norm",
            max_position_embeddings=64, layer_norm_eps=1e-7, feature_layer_norm_eps=1e-5,
            hidden_act="gelu_python", feat_proj_dropout=0.0, final_dropout=0.0, **TINY)
N = 3600
LENGTHS = (3600, 2100)


def _cfgs(stage=0, **kw):
    return (JaxDACSConfig(backbone=JaxBackboneConfig(**SEWD, **kw), stage=stage),
            DACSConfig(backbone=BackboneConfig(**SEWD, **kw), stage=stage))


def _inputs():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, N)).astype(np.float32)
    x[1, LENGTHS[1]:] = 0.0
    t = feat_extract_output_lengths(BackboneConfig(**SEWD), N)
    noise = tuple(rng.gumbel(size=(2, t, 32, 2)).astype(np.float32) for _ in range(2))
    labels = np.full((2, 6), -100, np.int32)
    labels[0, :4], labels[1, :2] = rng.integers(1, 32, 4), rng.integers(1, 32, 2)
    return (x, np.array(LENGTHS, np.int32), noise, labels, np.array([4, 2], np.int32),
            np.array([1, 0], np.int32))


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs()
    return random_flax_params(JaxDACSModel(jcfg), (np.zeros((1, N), np.float32),), seed=4,
                              rng_names=("params", "gumbel", "dropout"))


def test_dacs_on_sewd_matches_jax(params):
    """fp32, ragged rows (359 and 209 conv frames: odd, so the squeeze drops
    a frame and the upsample pads it back): every output of the DACS model
    over the SEW-D encoder (hidden states = the backbone's output, on every
    frame) within 1e-4, the stage-0 loss rtol 1e-4, every parameter's
    gradient rtol 1e-3 over a floor of 1e-4 of the tree's largest. The
    flax tree round-trips through the HF names."""
    from privacy_preserve_federated_asr_tpu.models.objectives import dacs_loss as jdacs_loss

    jcfg, cfg = _cfgs()
    x, il, noise, labels, ll, dem = _inputs()

    def loss_fn(p):
        out = JaxDACSModel(jcfg).apply({"params": p}, jnp.asarray(x), jnp.asarray(il),
                                       deterministic=True, gumbel_noise=noise)
        loss, _ = jdacs_loss(out, jnp.asarray(labels), jnp.asarray(ll), jnp.asarray(dem),
                             jcfg, p["similar_fc"]["kernel"])
        return loss, out

    (jloss, jout), jgrads = jax.device_get(
        jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params))

    sd = state_dict_from_flax(params, cfg)
    assert "backbone.encoder.encoder.layer.0.attention.self.query_proj.weight" in sd
    assert isinstance(DACSModel(cfg).backbone, SEWDBackbone)
    model = DACSModel(cfg)
    model.load_state_dict(sd, strict=True)
    out = model(torch.from_numpy(x), torch.from_numpy(il),
                gumbel_noise=tuple(torch.from_numpy(n) for n in noise))
    assert out.frame_lengths.tolist() == [359, 209]
    for k in ("hidden_states", "logits_unmask", "logits", "logits_r",
              "dementia_logits_unmask", "dementia_logits_lm", "dementia_logits_ad"):
        np.testing.assert_allclose(getattr(out, k).detach().numpy(), getattr(jout, k),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(out.lm_mask.detach().numpy(), jout.lm_mask)
    loss, _ = dacs_loss(out, *(torch.from_numpy(a) for a in (labels, ll, dem)), cfg,
                        model.similar_fc.weight)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    grads = flax_from_state_dict({n: torch.zeros_like(p) if p.grad is None else p.grad
                                  for n, p in model.named_parameters()})
    _assert_tree_close(grads, jgrads, rtol=1e-3, rel_atol=1e-4)
    back = flax_from_state_dict(sd)
    assert jax.tree.structure(back) == jax.tree.structure(jax.device_get(params))


def test_sewd_int8_matches_jax_int8(params):
    """``dense_impl="int8"`` (every Dense of the SEW-D encoder, the relative
    embeddings' projections included) at fp32 against the JAX int8 SEW-D:
    99% of the hidden states within 1e-2 and all within 0.05 (an input on a
    rounding edge moves its row by one quantum, as in
    tests/test_torch_quant.py), and the int8 output near the fp one
    (cosine > 0.99, tests/test_quant.py's bound)."""
    from privacy_preserve_federated_asr_tpu.models.sewd import SEWDBackbone as JaxSEWD

    x, il, *_ = _inputs()
    fm = (np.arange(feat_extract_output_lengths(BackboneConfig(**SEWD), N))[None]
          < feat_extract_output_lengths(BackboneConfig(**SEWD), il)[:, None]).astype(np.int32)
    bparams = params["backbone"]
    want = np.asarray(jax.jit(lambda p, a, m: JaxSEWD(JaxBackboneConfig(
        **SEWD, dense_impl="int8")).apply({"params": p}, a, m))(bparams, x, fm))
    cfg8 = BackboneConfig(**SEWD, dense_impl="int8")
    model8 = SEWDBackbone(cfg8).eval()
    sd = {k[len("backbone."):]: v for k, v in state_dict_from_flax(
        params, DACSConfig(backbone=cfg8)).items() if k.startswith("backbone.")}
    model8.load_state_dict(sd, strict=True)
    model = SEWDBackbone(BackboneConfig(**SEWD)).eval()
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = model8(torch.from_numpy(x), torch.from_numpy(fm)).numpy()
        fp = model(torch.from_numpy(x), torch.from_numpy(fm)).numpy()
    _share_close(got, want, atol=1e-2, share=0.99)
    _share_close(got, want, atol=5e-2, share=1.0)
    assert (got * fp).sum() / (np.linalg.norm(got) * np.linalg.norm(fp)) > 0.99


def test_cli_loads_hf_sewd_checkpoint(tmp_path, capsys):
    """The golden's HF SEW-D state dict as an HF ``SEWDForCTC`` file (the
    ``sew_d.`` prefix, legacy ``weight_g``/``weight_v`` pos-conv keys, an
    ``lm_head``) loads through the port's ``cli load_weights`` into DACS on
    SEW-D, and the encoder reproduces the golden's HF output (rtol 2e-3,
    atol 3e-4, frames rounded down to the squeeze factor, as the JAX golden
    test holds it). The JAX CLI's ``load_params`` fails on the same file:
    its ``port_hf_state_dict`` knows neither the prefix nor SEW-D's names."""
    from privacy_preserve_federated_asr_tpu.models.port import port_hf_state_dict

    jcfg, sd, x, lengths, expected = _load("sewd")
    cfg = DACSConfig(backbone=BackboneConfig(**{f: getattr(jcfg, f)
                                                for f in BackboneConfig.__dataclass_fields__}),
                     stage=0)
    hf = {}
    for k, v in sd.items():
        if k.endswith("parametrizations.weight.original0"):
            k = k.replace("parametrizations.weight.original0", "weight_g")
        elif k.endswith("parametrizations.weight.original1"):
            k = k.replace("parametrizations.weight.original1", "weight_v")
        hf["sew_d." + k] = torch.from_numpy(v)
    hf["lm_head.weight"] = torch.full((32, 32), 0.5)
    hf["lm_head.bias"] = torch.zeros(32)
    torch.save(hf, tmp_path / "pytorch_model.bin")
    got = cli.load_weights(cfg, str(tmp_path), seed=0)
    assert torch.equal(got["lm_head.weight"], hf["lm_head.weight"])
    model = SEWDBackbone(cfg.backbone).eval()
    model.load_state_dict({k[len("backbone."):]: v for k, v in got.items()
                           if k.startswith("backbone.")}, strict=True)
    fl = feat_extract_output_lengths(cfg.backbone, lengths)
    t = feat_extract_output_lengths(cfg.backbone, x.shape[1])
    fm = (np.arange(t)[None] < fl[:, None]).astype(np.int32)
    with torch.inference_mode():
        ours = model(torch.from_numpy(x), torch.from_numpy(fm)).numpy()
    for b, n in enumerate(fl):
        n = int(n) // cfg.backbone.squeeze_factor * cfg.backbone.squeeze_factor
        np.testing.assert_allclose(ours[b, :n], expected[b, :n], rtol=2e-3, atol=3e-4)
    with pytest.raises((KeyError, ValueError)):
        port_hf_state_dict({k: v.numpy() for k, v in hf.items()}, jcfg)


def test_export_hf_refuses_sewd():
    """No ForCTC export layout for SEW-D, as in the JAX package
    (models/export.py): ``ValueError``."""
    from privacy_preserve_federated_asr_tpu.models.export import (
        export_for_ctc_state_dict as jexport)

    cfg = BackboneConfig(**SEWD)
    with pytest.raises(ValueError, match="sew-d"):
        export_for_ctc_state_dict({}, cfg)
    with pytest.raises(ValueError, match="sew-d"):
        jexport({"backbone": {}}, JaxBackboneConfig(**SEWD))
    assert cli.BACKBONES["sewd"] == "sew_d_mid"
