"""The port's method variants (privacy_preserve_federated_asr_tpu_torch/
models/variants.py: single-toggle and FSM, ``fsm_attention_loss``, their
recipes, the Trainer, extraction and serving with them, and the head
grafting of ``cli load_weights``) against the JAX package's on the CPU, with
the same numpy inputs and weights (bridged by ``state_dict_from_flax``).

A one-layer tiny backbone (TINY: no dropout) keeps every JAX program small;
each JAX reference is jitted once per module. Single-toggle's Gumbel noise
is injected into both packages. FSM's masks are thresholds of a sigmoid:
each test reports how many scores sit within 1e-5 of the threshold and
holds the masks equal outside that band (fp32 scores of the two packages
differ by ~1e-7)."""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu.models import (
    BackboneConfig as JaxBackboneConfig,
    DACSConfig as JaxDACSConfig,
)
from privacy_preserve_federated_asr_tpu.models.recipes import get_recipe as jax_recipe
from privacy_preserve_federated_asr_tpu.ops.decode import ad_vote as jax_ad_vote
from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch import evaluation as ev
from privacy_preserve_federated_asr_tpu_torch.data import AsrExample, CTCCharTokenizer
from privacy_preserve_federated_asr_tpu_torch.data.dataset import prepare_examples
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    feat_extract_output_lengths,
    flax_from_state_dict,
    init_dacs_state_dict,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.models.recipes import RECIPES, get_recipe
from privacy_preserve_federated_asr_tpu_torch.ops.losses import fsm_attention_loss
from privacy_preserve_federated_asr_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from privacy_preserve_federated_asr_tpu_torch.train.optim import make_lr_schedule, path_of
from privacy_preserve_federated_asr_tpu_torch.train.steps import DeviceBatch
from test_torch_backbone import TINY, one_torch_thread, random_flax_params  # noqa: F401
from test_torch_tools import jax_init_by_shapes  # noqa: F401
from test_torch_train import _assert_tree_close, _get, _leaves

ONE_LAYER = dict(**TINY, num_hidden_layers=1)
TOK = CTCCharTokenizer()
N, LENGTHS = 2000, (2000, 1300)
# the distinct FSM objectives: stages 2 and 6 share stage 1's
FSM_LOSS_STAGES = (1, 3, 4, 5)
BAND = 1e-5


def _cfgs(method, stage, **kw):
    kw = dict(method=method, stage=stage, ad_loss="recall", lambda_grl=0.3, **kw)
    return (JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**ONE_LAYER), **kw),
            DACSConfig(backbone=BackboneConfig.tiny_for_tests(**ONE_LAYER), **kw))


def _batch():
    """Two utterances (one padded), labels of 5 and 3 ids, AD labels 1 / 0,
    and one Gumbel draw of the single-toggle mask-score shape."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, N)).astype(np.float32)
    x[1, LENGTHS[1]:] = 0.0
    il = np.array(LENGTHS, np.int32)
    labels = np.full((2, 8), -100, np.int32)
    labels[0, :5] = rng.integers(1, 32, 5)
    labels[1, :3] = rng.integers(1, 32, 3)
    ll, dem, sm = np.array([5, 3], np.int32), np.array([1, 0], np.int32), np.ones(2, np.float32)
    t = feat_extract_output_lengths(BackboneConfig.tiny_for_tests(), N)
    noise = rng.gumbel(size=(2, t, 32, 2)).astype(np.float32)
    return x, il, labels, ll, dem, sm, noise


def _loss_args(labels, ll, dem, as_jax):
    f = jnp.asarray if as_jax else torch.from_numpy
    return f(labels), f(ll), f(dem)


def _jax_reference(method, stages):
    """JAX params and one jitted program: the model's outputs, the metrics,
    and per stage the loss and every parameter's gradient (one batched
    reverse pass over the stages' losses)."""
    jcfg, _ = _cfgs(method, stages[0])
    recipe = jax_recipe(method)
    jmodel = recipe.make_model(jcfg)
    x, il, labels, ll, dem, sm, noise = _batch()
    extra = dict(gumbel_noise=jnp.asarray(noise)) if method == "single_toggle" else {}
    params = random_flax_params(jmodel, (np.zeros((1, N), np.float32),), seed=7,
                                rng_names=("params", "gumbel", "dropout"))

    def losses(q):
        out = jmodel.apply({"params": q}, jnp.asarray(x), jnp.asarray(il),
                           deterministic=True, **extra)
        per_stage = [recipe.loss(out, *_loss_args(labels, ll, dem, True),
                                 jcfg.replace(stage=stage), q, jnp.asarray(sm), True)
                     for stage in stages]
        vec = jnp.stack([loss for loss, _ in per_stage])
        return vec, (vec, per_stage[0][1], out)

    jac, (vec, metrics, out) = jax.device_get(
        jax.jit(jax.jacrev(losses, has_aux=True))(params))
    res = {stage: (vec[i], jax.tree.map(lambda g, i=i: g[i], jac))
           for i, stage in enumerate(stages)}
    return params, out, metrics, res


@pytest.fixture(scope="module")
def st_ref():
    return _jax_reference("single_toggle", (1, 2))


@pytest.fixture(scope="module")
def fsm_ref():
    return _jax_reference("fsm", FSM_LOSS_STAGES)


def _port_model(method, stage, params):
    _, cfg = _cfgs(method, stage)
    model = get_recipe(method).make_model(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    return cfg, model


def _port_run(method, stage, params):
    """The port model's outputs, the stage's loss and metrics, and every
    parameter's gradient as a flax tree (zeros where none reached)."""
    cfg, model = _port_model(method, stage, params)
    x, il, labels, ll, dem, sm, noise = _batch()
    model.train()
    model.backbone.eval()
    extra = dict(gumbel_noise=(torch.from_numpy(noise),)) if method == "single_toggle" else {}
    out = model(torch.from_numpy(x), torch.from_numpy(il), **extra)
    loss, metrics = get_recipe(method).loss(out, *_loss_args(labels, ll, dem, False),
                                            cfg, model, torch.from_numpy(sm), True)
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    return out, loss, metrics, grads


def _band(score, thres):
    return np.abs(np.asarray(score, np.float64) - thres) < BAND


@pytest.mark.parametrize("masked", [False, True], ids=["all_frames", "frame_mask"])
def test_fsm_attention_loss_matches_jax(masked):
    """``fsm_attention_loss`` of hard masks (one row all-off: the eps
    floor) against JAX, fp32, rtol 1e-6."""
    from privacy_preserve_federated_asr_tpu.ops.losses import fsm_attention_loss as jloss

    rng = np.random.default_rng(3)
    lm = (rng.random((3, 7, 16)) < 0.5).astype(np.float32)
    ad = (rng.random((3, 7, 16)) < 0.3).astype(np.float32)
    lm[2] = 0.0
    fm = (np.arange(7)[None] < np.array([[7], [4], [5]])).astype(np.int32) if masked else None
    got = fsm_attention_loss(torch.from_numpy(lm), torch.from_numpy(ad),
                             None if fm is None else torch.from_numpy(fm))
    want = jloss(jnp.asarray(lm), jnp.asarray(ad), None if fm is None else jnp.asarray(fm))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_single_toggle_forward_loss_grads_match_jax(st_ref, stage):
    """Injected noise: the mask and every stream (1e-5), the loss and its
    metrics (rtol 1e-4), every parameter's gradient (rtol 1e-3 over a floor
    of 1e-4 of the tree's largest); stage 3 has stage 2's loss. The
    arbitrator is D->2D."""
    params, jout, jmetrics, res = st_ref
    out, loss, metrics, grads = _port_run("single_toggle", stage, params)
    assert out.lm_score.shape[-2:] == (32, 2)
    np.testing.assert_array_equal(out.lm_mask.detach().numpy(), jout.lm_mask)
    for k in ("hidden_states", "logits", "dementia_logits_unmask", "dementia_logits_lm"):
        np.testing.assert_allclose(getattr(out, k).detach().numpy(), getattr(jout, k),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    jloss, jgrads = res[min(stage, 2)]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert set(metrics) == set(jmetrics)
    for k in set(metrics) - {"loss"}:  # the terms: the same at every stage
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _assert_tree_close(flax_from_state_dict(grads), jgrads, rtol=1e-3, rel_atol=1e-4)


def test_fsm_forward_loss_grads_match_jax(fsm_ref):
    """All six stages: the threshold masks equal outside the 1e-5 band, the
    streams (1e-5), every stage's loss and metrics (rtol 1e-4) and, per
    distinct objective, every parameter's gradient (rtol 1e-3 over a floor
    of 1e-4 of the tree's largest). ``lm_fsm`` / ``dementia_fsm`` get
    exactly zero gradient in both packages (the reference's zero-gradient
    straight-through hack)."""
    params, jout, jmetrics, res = fsm_ref
    for stage in range(1, 7):
        out, loss, metrics, grads = _port_run("fsm", stage, params)
        objective = {2: 1, 6: 1}.get(stage, stage)
        jloss, jgrads = res[objective]
        if stage == 1:
            for m, s, thr in (("lm_mask", "lm_score", 0.5),
                              ("dementia_mask", "dementia_score", 0.5)):
                band = _band(getattr(jout, s), thr)
                print(f"{m}: {int(band.sum())} of {band.size} scores within {BAND} "
                      "of the threshold")
                got = getattr(out, m).numpy()
                assert set(np.unique(got)) <= {0.0, 1.0}
                np.testing.assert_array_equal(got[~band], getattr(jout, m)[~band])
                np.testing.assert_allclose(getattr(out, s).detach().numpy(), getattr(jout, s),
                                           rtol=0, atol=1e-6)
            for k in ("hidden_states", "logits", "logits_r", "dementia_logits",
                      "dementia_logits_r"):
                np.testing.assert_allclose(getattr(out, k).detach().numpy(), getattr(jout, k),
                                           rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg=str(stage))
        assert set(metrics) == set(jmetrics)
        for k in set(metrics) - {"loss"}:
            np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{stage} {k}")
        if stage == objective:
            _assert_tree_close(flax_from_state_dict(grads), jgrads, rtol=1e-3,
                               rel_atol=1e-4)
        for machine in ("lm_fsm", "dementia_fsm"):
            for leaf in ("weight", "bias"):
                assert not grads[f"{machine}.{leaf}"].any(), (stage, machine)
            assert not np.any(jgrads[machine]["kernel"])


def _group(path) -> str:
    """A parameter path's trainable-set group: the head, or the backbone
    split into its conv frontend and the rest."""
    if path[0] != "backbone":
        return path[0]
    return "backbone/frontend" if path[1] == "feature_extractor" else "backbone/encoder"


@pytest.mark.parametrize("method", sorted(RECIPES))
def test_recipe_trainable_sets_match_jax(method):
    """Per stage, the trainable parameter count of each group (every head,
    the conv frontend, the rest of the backbone) equals the JAX recipe's
    over its flax tree (shapes by eval_shape), and ``backbone_trains`` and
    the stages agree."""
    jr, r = jax_recipe(method), get_recipe(method)
    assert r.stages == jr.stages
    jcfg, cfg = _cfgs(method, r.stages[0])
    shapes = jax.eval_shape(lambda: jr.make_model(jcfg).init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(0)},
        jnp.zeros((1, N))))["params"]
    jleaves = [(tuple(k.key for k in p), int(np.prod(s.shape)))
               for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    with torch.device("meta"):
        model = r.make_model(cfg)
    for stage in r.stages:
        jpred, pred = jr.trainable(stage), r.trainable(stage)
        want, got = {}, {}
        for path, n in jleaves:
            want[_group(path)] = want.get(_group(path), 0) + n * jpred(path)
        for name, p in model.named_parameters():
            path = path_of(name)
            got[_group(path)] = got.get(_group(path), 0) + p.numel() * pred(path)
        assert got == want, (method, stage)
        assert r.backbone_trains(stage) == jr.backbone_trains(stage)


def _examples(n=4, seed=0):
    rng = np.random.default_rng(seed)
    exs = [AsrExample(path=f"S{i % 3:03d}_PAR_{i}.wav",
                      array=rng.normal(0, 0.1, 1400 + 300 * i).astype(np.float32),
                      text="THE JAR", dementia_label=i % 2) for i in range(n)]
    return prepare_examples(exs, TOK)


@pytest.mark.parametrize("method,has_lm,has_ad", [
    ("dacs", True, True), ("toggle_more", True, True), ("fsm", True, True),
    ("single_toggle", True, False), ("grl", False, False)])
def test_extraction_row_schema_per_method(method, has_lm, has_ad, tmp_path):
    """The JAX package's schema per method (tests/test_recipes.py): mask
    columns where the method's reference eval script dumps them, in the
    rows and in the pickle; hard 0/1 masks."""
    stage = {"dacs": 2, "toggle_more": 3, "grl": 0, "single_toggle": 2, "fsm": 1}[method]
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), method=method, stage=stage)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    rows = ev.extract_embeddings(cfg, sd, _examples(), TOK, batch_size=2,
                                 time_multiple=3200, device="cpu")
    assert len(rows) == 4
    for r in rows:
        assert r.hidden_states.shape[1] == cfg.hidden_size
        assert (r.lm_mask is not None) == has_lm and (r.dementia_mask is not None) == has_ad
        for m in (r.lm_mask, r.dementia_mask):
            assert m is None or set(np.unique(m)) <= {0.0, 1.0}
        assert r.dementia_logits.shape[1] == 2 and r.pred_AD in (0, 1)
    ev.rows_to_pickle(rows, str(tmp_path / "rows.pkl"))
    cols = set(ev.read_records(str(tmp_path / "rows.pkl"))[0])
    assert ("lm_mask" in cols) == has_lm and ("dementia_mask" in cols) == has_ad


@pytest.mark.parametrize("method", ["single_toggle", "fsm"])
def test_extraction_rows_match_jax(method, st_ref, fsm_ref):
    """``extract_embeddings`` of the reference batch's two utterances (one
    bucket of 2000 samples, injected noise for single-toggle) against the
    JAX model's outputs through the recipe's extract streams: hidden states,
    the mask columns (FSM: outside the 1e-5 band) and the AD logits within
    1e-5, ``pred_AD`` equal."""
    params, jout, _, _ = st_ref if method == "single_toggle" else fsm_ref
    jcfg, cfg = _cfgs(method, 2)
    x, il, *_, noise = _batch()
    draws = 1 if method == "single_toggle" else 0
    exs = [AsrExample(path=f"S00{i}_PAR_{i}.wav", array=x[i, :n], text="THE JAR",
                      dementia_label=i, input_values=x[i, :n],
                      labels=np.asarray(TOK.encode("THE JAR"), np.int32))
           for i, n in enumerate(il)]
    rows = ev.extract_embeddings(cfg, state_dict_from_flax(params, cfg), exs, TOK,
                                 batch_size=2, time_multiple=N, device="cpu",
                                 # the batcher puts the shorter utterance first
                                 gumbel_noise=lambda shape: (noise[::-1].copy(),)[:draws])
    _, dlog, lm, ad = jax_recipe(method).extract_streams(jout, jcfg)
    fl = jout.frame_lengths
    for r in rows:
        i = int(r.path[3])
        n = int(fl[i])
        np.testing.assert_allclose(r.hidden_states, jout.hidden_states[i, :n], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r.dementia_logits, dlog[i, :n], rtol=1e-5, atol=1e-5)
        for got, want, score in ((r.lm_mask, lm, getattr(jout, "lm_score", None)),
                                 (r.dementia_mask, ad, getattr(jout, "dementia_score", None))):
            assert (got is None) == (want is None)
            if got is not None:
                keep = (~_band(score[i, :n], 0.5) if method == "fsm"
                        else np.ones(got.shape, bool))
                np.testing.assert_array_equal(got[keep], want[i, :n][keep])
        assert r.pred_AD == int(jax_ad_vote(dlog, jout.frame_mask)[i])


@pytest.mark.parametrize("method,stage", [("single_toggle", 2), ("fsm", 1)])
def test_train_step_matches_jax_step(method, stage, st_ref, fsm_ref):
    """One AdamW step (lr 1e-3) of the port's full-forward train step against
    the JAX ``make_train_step`` (its freezing, loss and optax chain), the
    JAX forward given the noise the port's step draws from its generator:
    loss and grad norm rtol 1e-4; every param within 1e-2 lr on 99.5% of
    each leaf's elements (Adam's first step moves an element whose gradient
    is at rounding level by up to lr in either package; the key bias, whose
    exact gradient is 0, is exempt). Frozen params
    (single-toggle: the backbone and the heads but the arbitrator; FSM
    stage 1: the conv frontend and four heads) stay bit-equal; FSM's
    machines, at zero gradient, move by the weight decay alone (their
    biases, which take no decay, not at all)."""
    from privacy_preserve_federated_asr_tpu.train import optim as joptim
    from privacy_preserve_federated_asr_tpu.train.steps import DeviceBatch as JaxDeviceBatch
    from privacy_preserve_federated_asr_tpu.train.steps import make_train_step as jmake
    from privacy_preserve_federated_asr_tpu.train.train_state import create_train_state as jcreate
    from privacy_preserve_federated_asr_tpu_torch.ops.gumbel import sample_gumbel

    lr = 1e-3
    params = (st_ref if method == "single_toggle" else fsm_ref)[0]
    jcfg, cfg = _cfgs(method, stage)
    cfg_, model = _port_model(method, stage, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    recipe = get_recipe(method)
    state = create_train_state(model, make_optimizer(model, stage, learning_rate=lr,
                                                     trainable_pred=recipe.trainable(stage)), 0)
    x, il, labels, ll, dem, sm, _ = _batch()
    extra = {}
    if method == "single_toggle":  # the draw the port's step is about to take
        gen = torch.Generator().set_state(state.gumbel.get_state())
        t = feat_extract_output_lengths(cfg.backbone, N)
        extra = dict(gumbel_noise=jnp.asarray(sample_gumbel((2, t, 32, 2), gen, "cpu").numpy()))
    m = make_train_step(cfg)(state, DeviceBatch(*(torch.from_numpy(a) for a in
                                                  (x, il, labels, ll, dem, sm))))

    jr = jax_recipe(method)
    jmodel = jr.make_model(jcfg)
    tx = joptim.make_optimizer(params, stage, learning_rate=lr,
                               trainable_pred=jr.trainable(stage))

    def forward_fn(p, iv, il_, deterministic, backbone_deterministic, rngs):
        return jmodel.apply({"params": p}, iv, il_, deterministic=deterministic,
                            backbone_deterministic=backbone_deterministic, rngs=rngs, **extra)

    jstate, jm = jax.jit(jmake(jmodel, tx, jcfg, forward_fn=forward_fn))(
        jcreate(params, tx, jax.random.PRNGKey(0)),
        JaxDeviceBatch(*(jnp.asarray(a) for a in (x, il, labels, ll, dem, sm))))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    got = flax_from_state_dict(model.state_dict())
    for path, w in _leaves(jax.device_get(jstate.params)):
        diff = np.abs(_get(got, path) - w)
        assert np.isfinite(diff).all(), path
        # the key bias's exact gradient is 0 (softmax ignores a shift shared
        # by all keys): its update is all rounding noise
        if path[-2:] != ("k_proj", "bias"):
            assert (diff > 1e-2 * lr).mean() <= 5e-3, path
    pred = recipe.trainable(stage)
    machines = ("lm_fsm.", "dementia_fsm.")
    for k, v in model.state_dict().items():
        if not k.startswith(machines):
            assert torch.equal(v, before[k]) != pred(path_of(k)), k
    if method == "fsm":  # zero gradient: AdamW's decoupled decay alone (none on biases)
        for m in machines:
            torch.testing.assert_close(model.state_dict()[m + "weight"],
                                       before[m + "weight"] * (1 - lr * 0.005), rtol=0,
                                       atol=1e-9)
            assert torch.equal(model.state_dict()[m + "bias"], before[m + "bias"])


def _tiny_examples(n, seed=0):
    rng = np.random.default_rng(seed)
    exs = [AsrExample(path=f"S{i % 3:03d}_PAR_{i}.wav",
                      array=rng.normal(0, 0.1, int(rng.integers(2400, 4000))).astype(np.float32),
                      text="THE JAR IS OPEN", dementia_label=i % 2) for i in range(n)]
    return prepare_examples(exs, TOK)


def test_trainer_cache_refusals_and_variant_runs():
    """The JAX Trainer's rules: the caches are refused for the variants
    ("DACS"), ``cache_encoder`` where the encoder trains (FSM stage 1), and
    ``cache_frontend`` on a GroupNorm frontend ("padding-invariant"); by
    default the variants run the full forward, and DACS on SEW-D keeps the
    encoder cache at stage 1 but no frontend cache at stage 0. A
    single-toggle Trainer step moves the arbitrator alone."""
    exs = _tiny_examples(2)
    tcfg = dict(batch_size=2, logging_steps=1, learning_rate=1e-3, time_multiple=1600,
                log_dir=".")

    def trainer(method, stage, backbone=None, **kw):
        cfg = DACSConfig(backbone=backbone or BackboneConfig.tiny_for_tests(),
                         method=method, stage=stage)
        sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
        return Trainer(cfg, sd, exs, None, TOK, TrainerConfig(**tcfg, **kw), device="cpu"), sd

    for method, stage, kw, match in (
            ("single_toggle", 2, dict(cache_encoder=True), "DACS"),
            ("fsm", 3, dict(cache_frontend=True), "DACS"),
            ("fsm", 1, dict(cache_encoder=True), "frozen backbone"),
            ("dacs", 0, dict(cache_frontend=True,
                             backbone=BackboneConfig.tiny_for_tests(feat_extract_norm="group")),
             "padding-invariant")):
        with pytest.raises(ValueError, match=match):
            trainer(method, stage, **kw)
    for method, stage in (("single_toggle", 2), ("fsm", 1)):
        tr, sd = trainer(method, stage)
        assert not tr._cache_encoder and not tr._cache_frontend
    tr.train()  # FSM stage 1: the encoder trains, its conv frontend stays
    moved = {k for k, v in tr.state.model.state_dict().items() if not torch.equal(v, sd[k])}
    assert "backbone.encoder.layers.0.attention.q_proj.weight" in moved
    assert not any(k.startswith("backbone.feature_extractor.") for k in moved)
    sewd = BackboneConfig.tiny_for_tests(
        model_type="sew-d", feat_extract_norm="group", squeeze_factor=2, position_buckets=8,
        relative_attention=True, pos_att_type=("p2c", "c2p"), norm_rel_ebd="layer_norm",
        max_position_embeddings=32, pos_conv_type="single", num_conv_pos_embeddings=4)
    assert trainer("dacs", 1, sewd)[0]._cache_encoder
    assert not trainer("dacs", 0, sewd)[0]._cache_frontend
    tr, sd = trainer("single_toggle", 2)
    tr.train()
    assert tr.state.step == 1
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(v, sd[k]) == (not k.startswith("arbitrator.")), k


def test_engine_fsm_matches_jax_engine(fsm_ref):
    """The serving engine with ``method="fsm"`` (stage 2) against the JAX
    InferenceEngine under the same weights: transcripts and AD votes equal,
    ``ad_prob`` within 1e-5 (tests/test_torch_serving.py's setting)."""
    from privacy_preserve_federated_asr_tpu.serving import InferenceEngine as JaxEngine
    from privacy_preserve_federated_asr_tpu.serving import ServingConfig as JaxServingConfig
    from privacy_preserve_federated_asr_tpu_torch.serving import InferenceEngine, ServingConfig

    params = fsm_ref[0]
    jcfg, cfg = _cfgs("fsm", 2)
    scfg = dict(batch_size=4, time_multiple=3200, max_seconds=2.0, compute_dtype="float32")
    jeng = JaxEngine(jcfg, params, scfg=JaxServingConfig(**scfg))
    eng = InferenceEngine(cfg, state_dict_from_flax(params, cfg), scfg=ServingConfig(**scfg),
                          device="cpu")
    rng = np.random.default_rng(4)
    waves = [rng.normal(0, 0.3, n).astype(np.float32) for n in (3200, 2500)]
    for got, want in zip(eng.infer_batch(waves), jeng.infer_batch(waves)):
        assert (got.transcript, got.ad_pred, got.frames) == (want.transcript, want.ad_pred,
                                                             want.frames)
        np.testing.assert_allclose(got.ad_prob, want.ad_prob, rtol=0, atol=1e-5)


def _out(args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    return buf.getvalue()


def test_load_weights_grafts_matching_heads(tmp_path, capsys):
    """A DACS ForCTC export loads into the variants (it raised before:
    ``ValueError`` on the D->4D arbitrator for single-toggle, ``KeyError``
    for FSM, which has none): the encoder and the heads the model has at the
    same shape (``lm_head``, ``dementia_head``, FSM's ``similar_fc``) are
    carried bit-equal; single-toggle's D->2D arbitrator keeps its init and
    the skip is announced; FSM's own heads keep their init. An encoder of
    another shape still raises."""
    model = ["--model_type", "tiny", "--seed", "3", "--device", "cpu"]
    _out(["export-hf", *model, "-st", "2", "--out", str(tmp_path / "dacs.bin")])
    src = torch.load(tmp_path / "dacs.bin", weights_only=True)
    src = {k.replace("data2vec_audio.", "backbone.").replace("criterion_similar.fc",
                                                             "similar_fc"): v
           for k, v in src.items()}
    for method in ("single_toggle", "fsm"):
        cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), method=method, stage=2)
        init = init_dacs_state_dict(cfg, torch.Generator().manual_seed(5))
        sd = cli.load_weights(cfg, str(tmp_path / "dacs.bin"), seed=5)
        assert set(sd) == set(init)
        carried = {k for k in sd if k in src and src[k].shape == init[k].shape}
        assert {k.split(".")[0] for k in carried} == (
            {"backbone", "lm_head", "dementia_head"}
            | ({"similar_fc"} if method == "fsm" else set()))
        for k, v in sd.items():
            assert torch.equal(v, src[k] if k in carried else init[k]), k
        warned = capsys.readouterr().out
        assert ("WARNING: checkpoint head 'arbitrator'" in warned) == (method == "single_toggle")
    wide = DACSConfig(backbone=BackboneConfig.tiny_for_tests(hidden_size=48), method="fsm",
                      stage=2)
    with pytest.raises(ValueError, match="wrong --model_type"):
        cli.load_weights(wide, str(tmp_path / "dacs.bin"))


def test_cli_teacher_matches_jax(tmp_path, monkeypatch, jax_init_by_shapes):
    """``cli teacher`` (the CTC self-training teacher) of a seeded stage-0
    export against the JAX ``cli teacher`` on the same files: the transcript
    JSON and the labeled CSV byte-equal; ``--whisper_hf`` is refused;
    ``load_transcripts`` and ``add_transcripts`` equal JAX's. The
    teacher transcribes the method's extraction stream: ``--method grl``
    (the unmasked stream; DACS's is the lm-masked one, Gumbel noise
    included, whose draws the packages do not share)."""
    from scipy.io import wavfile

    from privacy_preserve_federated_asr_tpu import cli as jax_cli

    monkeypatch.chdir(tmp_path)
    (tmp_path / "clips").mkdir()
    rng = np.random.default_rng(2)
    names = [f"S{i:03d}_PAR_{i}.wav" for i in range(3)]
    for i, name in enumerate(names):
        wavfile.write(tmp_path / "clips" / name, 16000,
                      (rng.normal(0, 0.1, 2400 + 800 * i) * 32767).astype(np.int16))
    (tmp_path / "u.csv").write_text("path\n" + "\n".join(names) + "\n")
    np.save(tmp_path / "spk.npy", {f"S{i:03d}": i % 2 for i in range(3)})
    model = ["--model_type", "tiny", "-st", "0", "--seed", "4", "--method", "grl"]
    _out(["export-hf", *model, "--device", "cpu", "--out", "exp/pytorch_model.bin"])
    args = ["teacher", *model, "-model_in", "exp", "--audio_dir", "clips",
            "--train_csv", "u.csv", "--spk2label", "spk.npy", "--eval_batch_size", "2"]
    trs = cli.main(args + ["--out", "port/u.csv", "--dataset_cache", "c1", "--device", "cpu"])
    assert sorted(trs) == names
    jax_cli.main(args + ["--out", "jax/u.csv", "--dataset_cache", "c2"])
    for f in ("u.csv", "u.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert json.loads((tmp_path / "port/u.json").read_text()) == trs
    with pytest.raises(NotImplementedError, match="not ported yet"):
        cli.main(args + ["--out", "w.csv", "--whisper_hf", "whisper", "--device", "cpu"])

    # the artifacts read back and attached as JAX's data/teacher.py does
    # (a list aligned to the examples, a {path: text} JSON, a CSV; the
    # reference's filter drops short audio and empty text)
    from privacy_preserve_federated_asr_tpu.data import teacher as jteacher
    from privacy_preserve_federated_asr_tpu_torch.data import teacher

    for path in ("port/u.json", "port/u.csv"):
        assert teacher.load_transcripts(path) == jteacher.load_transcripts(path)
    def fresh():  # add_transcripts edits its examples: each call gets its own
        exs = _tiny_examples(3)
        exs[1].array = exs[1].array[:1000]
        return exs

    names = [e.path for e in fresh()]
    for trs in (["a b", "c", " "], {names[0]: "hi", names[2]: ""}):
        got = teacher.add_transcripts(fresh(), trs, TOK)
        want = jteacher.add_transcripts(fresh(), trs, TOK)
        assert [(e.path, e.text, list(e.labels)) for e in got] == [
            (e.path, e.text, list(e.labels)) for e in want] != []
