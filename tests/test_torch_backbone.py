"""The port's SSLBackbone (privacy_preserve_federated_asr_tpu_torch/models/
backbone.py) and SEWDBackbone (models/sewd.py): the 4 SSL goldens and the
SEW-D golden loaded through ``state_dict_from_hf`` with strict=True, and the
flax SSLBackbone under the same weights carried across with
``state_dict_from_flax``, post-norm and pre-norm, at fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu.models import SSLBackbone as FlaxBackbone
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    SSLBackbone,
    feat_extract_output_lengths,
    state_dict_from_flax,
    state_dict_from_hf,
)
from privacy_preserve_federated_asr_tpu_torch.models.factory import make_backbone
from privacy_preserve_federated_asr_tpu_torch.models.sewd import SEWDBackbone
from test_golden_port import _load

# the JAX configs' dropouts off (the port's config has none: inference only)
TINY = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the cores the
    parallel test workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame_mask(cfg, lengths, n):
    fl = feat_extract_output_lengths(cfg, np.asarray(lengths))
    t = feat_extract_output_lengths(cfg, n)
    return fl, (np.arange(t)[None, :] < fl[:, None]).astype(np.int32)


@pytest.mark.parametrize("name", ["data2vec", "wav2vec2", "hubert", "unispeech_sat", "sewd"])
def test_golden_hf_state_dict_strict(name):
    """The HF goldens through ``state_dict_from_hf`` with strict=True. SEW-D
    at the JAX golden test's tolerance (rtol 2e-3, atol 3e-4) over frames
    rounded down to a multiple of the squeeze factor; the SSL families at
    rtol 5e-4, atol 5e-5."""
    jcfg, sd, x, lengths, expected = _load(name)
    from privacy_preserve_federated_asr_tpu.models import BackboneConfig as JaxCfg

    ours_fields = set(BackboneConfig.__dataclass_fields__)
    # the JAX fields the port leaves out sit at their defaults in the fixture,
    # where they are training-only or select paths the port does not run
    for f in set(jcfg.__dataclass_fields__) - ours_fields:
        assert getattr(jcfg, f) == getattr(JaxCfg(), f), f
    cfg = BackboneConfig(**{f: getattr(jcfg, f) for f in ours_fields})
    model = make_backbone(cfg).eval()
    assert isinstance(model, SEWDBackbone if name == "sewd" else SSLBackbone)
    model.load_state_dict(state_dict_from_hf(sd, cfg), strict=True)
    fl, fm = _frame_mask(cfg, lengths, x.shape[1])
    with torch.inference_mode():
        ours = model(torch.from_numpy(x), torch.from_numpy(fm)).numpy()
    assert ours.shape == expected.shape
    tol = dict(rtol=2e-3, atol=3e-4) if name == "sewd" else dict(rtol=5e-4, atol=5e-5)
    for b, n in enumerate(fl):
        if name == "sewd":
            n = int(n) // cfg.squeeze_factor * cfg.squeeze_factor
        np.testing.assert_allclose(ours[b, :n], expected[b, :n], **tol)


def random_flax_params(module, example, seed, rng_names=("params",)):
    """numpy params of ``module``'s shapes (eval_shape: traced, not compiled)."""
    rngs = {n: jax.random.PRNGKey(0) for n in rng_names}
    shapes = jax.eval_shape(lambda: module.init(rngs, *example))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "bias":
            return rng.normal(0, 0.02, s.shape).astype(np.float32)
        if name == "scale":
            return (1 + rng.normal(0, 0.1, s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return rng.normal(0, fan_in ** -0.5, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)["params"]


@pytest.mark.parametrize("stable", [False, True], ids=["post_norm", "pre_norm"])
def test_matches_flax_backbone(stable):
    kw = dict(do_stable_layer_norm=stable)
    if stable:  # the pre-norm families: single weight-normed pos conv, even k
        kw.update(pos_conv_type="single", num_conv_pos_embeddings=16)
    cfg = BackboneConfig.tiny_for_tests(**kw)
    from privacy_preserve_federated_asr_tpu.models import BackboneConfig as JaxCfg

    jcfg = JaxCfg.tiny_for_tests(**TINY, **kw)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 2400)).astype(np.float32)
    lengths = np.array([2400, 1500])
    fl, fm = _frame_mask(cfg, lengths, x.shape[1])
    flax_model = FlaxBackbone(jcfg)
    params = random_flax_params(flax_model, (jnp.asarray(x), jnp.asarray(fm)), seed=6)
    ref = np.asarray(jax.jit(lambda p, x, fm: flax_model.apply({"params": p}, x, fm))(
        params, jnp.asarray(x), jnp.asarray(fm)))

    model = SSLBackbone(cfg).eval()
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    with torch.inference_mode():
        ours = model(torch.from_numpy(x), torch.from_numpy(fm)).numpy()
    for b, n in enumerate(fl):
        np.testing.assert_allclose(ours[b, :n], ref[b, :n], rtol=1e-4, atol=1e-5)
