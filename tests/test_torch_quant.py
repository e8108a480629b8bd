"""The port's int8 (W8A8) paths on the CPU
(privacy_preserve_federated_asr_tpu_torch/ops/quant.py, ``dense_impl`` in the
backbone, ``compute_dtype="int8"`` in the engine, ``int8_train`` in the
Trainer and the federated engine) against the JAX package's ops/quant.py,
model, gradients and engine on the same numpy inputs and weights (bridged
by state_dict_from_flax).

The int8 products accumulate exactly in int32, so on equal inputs the port
and JAX agree bit for bit (held below). Through a model the inputs of each
quantization differ by float rounding, and an activation that straddles a
rounding edge moves by one quantum: those cases are held to a share of
elements within a tolerance, stated at each test."""

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
from privacy_preserve_federated_asr_tpu.models.objectives import dacs_loss as jdacs_loss
from privacy_preserve_federated_asr_tpu.ops import quant as jquant
from privacy_preserve_federated_asr_tpu.serving import InferenceEngine as JaxEngine
from privacy_preserve_federated_asr_tpu.serving import ServingConfig as JaxServingConfig
from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.data import AsrExample, prepare_examples
from privacy_preserve_federated_asr_tpu_torch.data.audio import normalize_input_values
from privacy_preserve_federated_asr_tpu_torch.data.tokenizer import CTCCharTokenizer
from privacy_preserve_federated_asr_tpu_torch.federated import FederatedConfig, FederatedEngine
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    DACSModel,
    flax_from_state_dict,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.models.objectives import dacs_loss
from privacy_preserve_federated_asr_tpu_torch.ops import quant
from privacy_preserve_federated_asr_tpu_torch.serving import InferenceEngine, ServingConfig
from privacy_preserve_federated_asr_tpu_torch.train.trainer import Trainer, TrainerConfig
from test_torch_backbone import TINY, one_torch_thread, random_flax_params  # noqa: F401

# one encoder layer: every JAX program here compiles in about half the time
ONE_LAYER = dict(**TINY, num_hidden_layers=1)

TOK = CTCCharTokenizer()


def _cfgs(stage=0, dense_impl="int8"):
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(
        **ONE_LAYER, dense_impl=dense_impl), stage=stage)
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(**ONE_LAYER, dense_impl=dense_impl),
                     stage=stage)
    return jcfg, cfg


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _cfgs()
    return random_flax_params(JaxDACSModel(jcfg), (np.zeros((1, 3200), np.float32),),
                              seed=9, rng_names=("params", "gumbel", "dropout"))


def _share_close(got, want, atol, share):
    """At least ``share`` of the elements within ``atol``, all finite."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    close = np.abs(got - want) <= atol
    assert close.mean() >= share, (close.mean(), np.abs(got - want).max())


def test_quantize_symmetric_matches_jax():
    """q and scale bit-equal to JAX's along either axis; an all-zero row
    quantizes to zeros with scale 1."""
    x = np.random.default_rng(0).normal(0, 3, (8, 64)).astype(np.float32)
    x[3] = 0.0
    for dim in (-1, 0):
        q, scale = quant.quantize_symmetric(torch.from_numpy(x), dim=dim)
        jq, jscale = jquant.quantize_symmetric(jnp.asarray(x), axis=dim)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        if dim == -1:
            assert (q[3] == 0).all() and scale[3, 0] == 1.0


@pytest.mark.parametrize("shape", [(3, 17, 64), (5, 64)], ids=["3x17", "5rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(shape, dtype):
    """``int8_linear(x, W)`` against ``int8_dense_dot_general(x, W^T)``:
    bit-equal in fp32 and bf16 (5 rows: the zero-row padding to 17 is
    exact); the trainable forward is the same value."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, 0.05, (48, 64)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    got = quant.int8_linear(xt, wt)
    dims = (((len(shape) - 1,), (0,)), ((), ()))
    want = jquant.int8_dense_dot_general(jnp.asarray(x, jdt), jnp.asarray(w.T, jdt), dims)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert torch.equal(quant.int8_train_linear(xt, wt), got)
    rel = (got.float() - xt.float() @ wt.float().T).norm() / (xt.float() @ wt.float().T).norm()
    assert rel < 0.02, rel  # the quantization error against the fp product


def test_int8_train_gradients_match_jax():
    """SwitchBack gradients of 0.5 * sum(y^2) against the JAX custom_vjp:
    grad-input within rtol 1e-6 (the same int8 codes and scales; XLA may order
    the two rescale products otherwise), grad-weight (fp32 products in
    another order) rtol 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (4, 33, 64)).astype(np.float32)
    w = rng.normal(0, 0.05, (48, 64)).astype(np.float32)
    dims = (((2,), (0,)), ((), ()))

    def jloss(a, k):
        return 0.5 * (jquant.int8_train_dense_dot_general(a, k, dims) ** 2).sum()

    jgx, jgw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w.T))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (0.5 * quant.int8_train_linear(xt, wt).square().sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-6, atol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw).T, rtol=1e-5, atol=1e-6)


def test_backbone_int8_matches_jax(params):
    """DACSModel with ``dense_impl="int8"`` at fp32 against the JAX model:
    hidden states and CTC logits (largest magnitude ~4), 99% of elements
    within 1e-2 and all within 0.05; greedy ids equal on frames whose top
    two logits are 1e-2 apart. An input on a rounding edge moves its row by
    one quantum and the move carries through the layers: the JAX model's
    own jitted and eager forwards differ by up to 0.02 on these inputs, the
    fp models by 2e-6. The
    DACS heads stay fp; ``resolve_compute("int8")`` gives bf16 and
    ``dense_impl="int8"`` as in JAX."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 3200)).astype(np.float32)
    il = np.array([3200, 2400], np.int32)
    jout = jax.jit(lambda p, a, n: JaxDACSModel(jcfg).apply(
        {"params": p}, a, n, deterministic=True, rngs={"gumbel": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(x), jnp.asarray(il))
    model = DACSModel(cfg).eval()
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(x), torch.from_numpy(il),
                    generator=torch.Generator().manual_seed(0))
    fm = np.asarray(jout.frame_mask, bool)
    for k in ("hidden_states", "logits_unmask"):
        got, want = getattr(out, k).numpy()[fm], np.asarray(getattr(jout, k))[fm]
        _share_close(got, want, 1e-2, 0.99)
        np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    want = np.asarray(jout.logits_unmask)[fm]
    top2 = np.sort(want, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2
    got = out.logits_unmask.numpy()[fm]
    np.testing.assert_array_equal(got[clear].argmax(-1), want[clear].argmax(-1))
    dense = {n: m.dense_impl for n, m in model.named_modules() if hasattr(m, "dense_impl")}
    assert {v for n, v in dense.items() if n.startswith("backbone.")} == {"int8"}
    assert {v for n, v in dense.items() if not n.startswith("backbone.")} == {"fp"}
    fp_cfg = _cfgs(dense_impl="fp")[1]
    rcfg, dtype = fp_cfg.resolve_compute("int8")
    jrcfg, jdtype = _cfgs(dense_impl="fp")[0].resolve_compute("int8")
    assert (rcfg.backbone.dense_impl, dtype) == (jrcfg.backbone.dense_impl, torch.bfloat16)
    assert jdtype == jnp.bfloat16
    assert fp_cfg.resolve_compute("float32") == (fp_cfg, torch.float32)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 2000)).astype(np.float32)
    il = np.array([2000, 1300], np.int32)
    labels = np.full((2, 8), -100, np.int32)
    labels[0, :5] = rng.integers(1, 32, 5)
    labels[1, :3] = rng.integers(1, 32, 3)
    return x, il, labels, np.array([5, 3], np.int32), np.array([1, 0], np.int32), \
        np.ones(2, np.float32)


def _examples(n, seed=0):
    rng = np.random.default_rng(seed)
    return prepare_examples([AsrExample(
        path=f"S{i % 2:03d}_PAR_{seed}{i}.wav", array=rng.normal(0, 0.3, 3200 - 800 * (i % 2))
        .astype(np.float32), text=("HI", "OK GO")[i % 2], dementia_label=i % 2)
        for i in range(n)], TOK)


def test_trainer_int8_rules_and_step_matches_jax(params):
    """The Trainer refuses ``dense_impl="int8"`` and ``compute_dtype="int8"``
    with JAX's message and takes ``int8_train``. One stage-0 step's loss
    and gradients against jax.value_and_grad of the same int8_train model:
    loss rtol 1e-4; each gradient leaf 98% of elements within 1e-3 of its
    largest value plus rtol 1e-2, cosine > 0.9999 (the key bias, whose
    exact gradient is 0, exempt). Then the Trainer's own
    step: the frozen frontend bit-unchanged, the rest moved and finite."""
    _, cfg8 = _cfgs()
    sd = state_dict_from_flax(params, cfg8)
    for bad, tc in ((cfg8, TrainerConfig()),
                    (_cfgs(dense_impl="fp")[1], TrainerConfig(compute_dtype="int8"))):
        with pytest.raises(ValueError, match="training requires"):
            Trainer(bad, sd, [], None, TOK, tc, device="cpu")

    jcfg, cfg = _cfgs(dense_impl="int8_train")
    x, il, labels, ll, dem, sm = _batch(cfg)
    jmodel = JaxDACSModel(jcfg)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(il),
                           deterministic=False, rngs={"gumbel": jax.random.PRNGKey(0),
                                                      "dropout": jax.random.PRNGKey(0)})
        return jdacs_loss(out, jnp.asarray(labels), jnp.asarray(ll), jnp.asarray(dem), jcfg,
                          p["similar_fc"]["kernel"], jnp.asarray(sm))[0]

    ref, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = DACSModel(cfg).train()
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    out = model(torch.from_numpy(x), torch.from_numpy(il), need_masks=False)
    loss, _ = dacs_loss(out, *(torch.from_numpy(a) for a in (labels, ll, dem)), cfg,
                        model.similar_fc.weight, torch.from_numpy(sm), aux_metrics=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4)
    grads = flax_from_state_dict({n: p.grad for n, p in model.named_parameters()
                                  if p.grad is not None})
    ref_grads = jax.device_get(ref_grads)
    checked = 0
    for path, g in _leaves(grads):
        w = _get(ref_grads, path)
        scale = np.abs(w).max()
        if scale == 0.0:
            continue
        if path[-2:] == ("k_proj", "bias"):
            continue  # exact gradient 0 (softmax ignores a shared key shift): noise
        _share_close(g, w, 1e-3 * scale + 1e-2 * np.abs(w), 0.98)
        cos = (g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos > 0.9999, ("/".join(path), cos)
        checked += 1
    assert checked > 20

    tr = Trainer(cfg, state_dict_from_flax(params, cfg), _examples(2), None, TOK,
                 TrainerConfig(num_epochs=1, batch_size=2, time_multiple=3200,
                               warmup_steps=1, learning_rate=1e-3, logging_steps=10**6,
                               eval_steps=10**6), device="cpu")
    before = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    calls = _count_int8_train()
    tr.train()
    assert calls() > 0 and tr.state.step == 1
    for k, v in tr.state.model.state_dict().items():
        assert torch.isfinite(v).all(), k
        if k.startswith("backbone.feature_extractor."):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(tr.state.model.state_dict()["lm_head.weight"], before["lm_head.weight"])


def _count_int8_train():
    """Count Int8TrainLinear's backward calls from now on (the int8
    grad-input product ran)."""
    calls = [0]
    real = quant.Int8TrainLinear.backward

    def counted(ctx, g):
        calls[0] += 1
        return real(ctx, g)

    quant.Int8TrainLinear.backward = staticmethod(counted)
    return lambda: (setattr(quant.Int8TrainLinear, "backward", staticmethod(real))
                    or calls[0])


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_federated_int8_train_round_and_cli_flags(params):
    """`--int8` on train and federated sets ``dense_impl="int8_train"``; a
    stage-0 federated round of that model runs its int8 gradients and moves
    the stage's network finitely."""
    for cmd in ("train", "federated"):
        args = cli.build_parser().parse_args([cmd, "--model_type", "tiny", "--int8"])
        assert cli._dacs_cfg(args).backbone.dense_impl == "int8_train"
    _, cfg = _cfgs(dense_impl="int8_train")
    sd = state_dict_from_flax(params, cfg)
    eng = FederatedEngine(
        cfg, FederatedConfig(num_rounds=1, num_clients=2, local_ep=1, batch_size=2,
                             eval_batch_size=2, time_multiple=3200, warmup_steps=1,
                             learning_rate=1e-3),
        {0: _examples(2, 1), 1: _examples(2, 2)}, [], None, TOK, sd, device="cpu")
    calls = _count_int8_train()
    got = eng.run_rounds(stage=0, num_rounds=1)
    assert calls() > 0
    assert all(torch.isfinite(v).all() for v in got.values())
    assert not torch.equal(got["lm_head.weight"], sd["lm_head.weight"].float())


def test_int8_engine_matches_jax_engine(params):
    """``compute_dtype="int8"`` serving (bf16 + W8A8) against the JAX int8
    engine on the same weights and padded batch: frames and AD votes equal,
    AD probabilities within 0.02, greedy ids equal on 95% of the valid
    frames and transcripts within an edit distance of 5% of their length.
    Random weights leave the top logits close, bf16 activations round in
    other places in the two frameworks (the bf16 engines without int8
    differ by up to 2.5% of a transcript on these inputs) and a rounding
    edge moves a whole quantization row."""
    jcfg, cfg = _cfgs(stage=1, dense_impl="fp")
    scfg = dict(batch_size=2, time_multiple=3200, max_seconds=0.4, compute_dtype="int8")
    jeng = JaxEngine(jcfg, params, scfg=JaxServingConfig(**scfg))
    eng = InferenceEngine(cfg, state_dict_from_flax(params, cfg),
                          scfg=ServingConfig(**scfg), device="cpu")
    assert eng.cfg.backbone.dense_impl == "int8" and eng.model.backbone.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    waves = [rng.normal(0, 0.3, n).astype(np.float32) for n in (3200, 2600)]
    for got, want in zip(eng.infer_batch(waves), jeng.infer_batch(waves)):
        assert (got.frames, got.samples, got.ad_pred) == (want.frames, want.samples,
                                                          want.ad_pred)
        assert _edit_distance(got.transcript, want.transcript) <= 0.05 * len(
            want.transcript), (got.transcript, want.transcript)
        assert abs(got.ad_prob - want.ad_prob) < 0.02
    iv = np.zeros((2, 3200), np.float32)   # the batch infer_batch ran
    il = np.array([len(w) for w in waves], np.int32)
    for i, w in enumerate(waves):
        iv[i, : len(w)] = normalize_input_values(w)
    pred, _, _, flen = eng._forward(iv, il)
    jpred, _, _, jflen = (np.asarray(a) for a in jax.device_get(
        jeng._forward(params, jnp.asarray(iv), jnp.asarray(il))))
    np.testing.assert_array_equal(flen, jflen)
    valid = np.arange(pred.shape[1])[None] < flen[:, None]
    assert (pred == jpred)[valid].mean() >= 0.95


def _edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]
