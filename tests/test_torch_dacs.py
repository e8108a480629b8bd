"""The port's DACSModel (privacy_preserve_federated_asr_tpu_torch/models/
dacs.py) against the JAX DACSModel at stage 2, fp32, with the same weights
and the same injected Gumbel noise: every DACSOutputs field agrees, the hard
masks exactly."""

import dataclasses

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
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    DACSModel,
    feat_extract_output_lengths,
    state_dict_from_flax,
)
from test_torch_backbone import TINY, one_torch_thread, random_flax_params  # noqa: F401

EXACT = ("lm_mask", "ad_mask", "frame_mask", "frame_lengths")


@pytest.mark.parametrize("toggle_ratio", [0.0, 0.3])
def test_stage2_outputs_match_jax(toggle_ratio):
    kw = dict(stage=2, toggle_ratio=toggle_ratio, gs_tau=0.7)
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**TINY), **kw)
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), **kw)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 2000)).astype(np.float32)
    lengths = np.array([2000, 1300], np.int32)
    t = feat_extract_output_lengths(cfg.backbone, x.shape[1])
    noise = tuple(rng.gumbel(size=(2, t, cfg.hidden_size, 2)).astype(np.float32)
                  for _ in range(2))

    jmodel = JaxDACSModel(jcfg)
    params = random_flax_params(jmodel, (jnp.asarray(x),), seed=8,
                                rng_names=("params", "gumbel", "dropout"))
    ref = jax.jit(lambda p, x, il, n: jmodel.apply({"params": p}, x, il, gumbel_noise=n))(
        params, jnp.asarray(x), jnp.asarray(lengths), tuple(jnp.asarray(n) for n in noise))

    model = DACSModel(cfg).eval()
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(x), torch.from_numpy(lengths),
                    gumbel_noise=tuple(torch.from_numpy(n) for n in noise))

    fields = [f.name for f in dataclasses.fields(out)]
    assert len(fields) == 14 and fields[-1] == "extra_logits"
    assert out.extra_logits == () and ref.extra_logits == ()  # num_lms 1
    valid = np.asarray(ref.frame_mask).astype(bool)
    for name in fields[:-1]:
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        if name in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:  # padded frames see a -1e9 bias in JAX, a replaced -1e30 here
            np.testing.assert_allclose(got[valid], want[valid], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    assert 0 < out.lm_mask.sum() < out.lm_mask.numel()  # masks are not trivial


@pytest.mark.parametrize("pos_conv", ["stacked", "single"])
def test_export_hf_state_dict_loads_strict(pos_conv, tmp_path):
    """The JAX package's ForCTC export (what `cli export-hf` writes, weight
    norm split for the single pos conv) loads into the port's DACSModel with
    strict=True, through state_dict_from_hf and the CLI's --model_in path,
    and carries the same weights as state_dict_from_flax."""
    from privacy_preserve_federated_asr_tpu.models.export import export_for_ctc_state_dict
    from privacy_preserve_federated_asr_tpu_torch.cli import load_weights
    from privacy_preserve_federated_asr_tpu_torch.models import state_dict_from_hf

    kw = dict(pos_conv_type=pos_conv,
              num_conv_pos_embeddings=16 if pos_conv == "single" else 2)
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**TINY, **kw))
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(**kw))
    params = random_flax_params(JaxDACSModel(jcfg), (jnp.zeros((1, 2000)),), seed=12,
                                rng_names=("params", "gumbel", "dropout"))
    exported = {k: torch.from_numpy(v) for k, v in
                export_for_ctc_state_dict(params, jcfg.backbone).items()}
    want = state_dict_from_flax(params, cfg)
    got = state_dict_from_hf(exported, cfg)
    DACSModel(cfg).load_state_dict(got, strict=True)
    path = tmp_path / "pytorch_model.bin"
    torch.save(exported, path)
    via_cli = load_weights(cfg, str(tmp_path))
    for sd in (got, via_cli):
        assert set(sd) == set(want)
        for k in want:
            torch.testing.assert_close(sd[k], want[k], rtol=1e-6, atol=1e-6, msg=k)
