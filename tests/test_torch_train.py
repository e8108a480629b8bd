"""The port's training path (privacy_preserve_federated_asr_tpu_torch/models/
objectives.py, train/) against the JAX package's on a tiny DACS model at
fp32, with the same weights (carried across with state_dict_from_flax and
back with flax_from_state_dict), dropouts 0 and the same injected Gumbel
noise; and the port's Trainer and ``cli train`` on the CPU."""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from privacy_preserve_federated_asr_tpu.models import (
    BackboneConfig as JaxBackboneConfig,
    DACSConfig as JaxDACSConfig,
    DACSModel as JaxDACSModel,
)
from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.data import (
    AsrExample,
    CTCCharTokenizer,
    prepare_examples,
)
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    DACSModel,
    feat_extract_output_lengths,
    flax_from_state_dict,
    init_dacs_state_dict,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.models.objectives import dacs_loss
from privacy_preserve_federated_asr_tpu_torch.train import (
    DeviceBatch,
    FeatureBatch,
    Trainer,
    TrainerConfig,
    create_train_state,
    frontend_forward_fn,
    make_feature_train_step,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from privacy_preserve_federated_asr_tpu_torch.train.optim import no_decay_names
from test_torch_backbone import TINY, one_torch_thread, random_flax_params  # noqa: F401

FROZEN_AT_STAGE0 = ("backbone.feature_extractor.", "dementia_head.", "arbitrator.",
                    "similar_fc.")


def _cfgs(stage, **kw):
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**TINY), stage=stage, **kw)
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(**TINY), stage=stage, **kw)
    return jcfg, cfg


def _batch(cfg, seed=0):
    """Two utterances (one padded), labels of 5 and 3 ids, AD labels 1 / 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 2000)).astype(np.float32)
    il = np.array([2000, 1300], np.int32)
    labels = np.full((2, 8), -100, np.int32)
    labels[0, :5] = rng.integers(1, 32, 5)
    labels[1, :3] = rng.integers(1, 32, 3)
    ll = np.array([5, 3], np.int32)
    dem = np.array([1, 0], np.int32)
    sm = np.ones(2, np.float32)
    t = feat_extract_output_lengths(cfg.backbone, x.shape[1])
    noise = tuple(rng.gumbel(size=(2, t, cfg.hidden_size, 2)).astype(np.float32)
                  for _ in range(2))
    return x, il, labels, ll, dem, sm, noise


def _jax_params(jcfg, seed=8):
    return random_flax_params(JaxDACSModel(jcfg), (jnp.zeros((1, 2000)),), seed=seed,
                              rng_names=("params", "gumbel", "dropout"))


def _port_model(cfg, params):
    model = DACSModel(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg), strict=True)
    return model


def _assert_tree_close(got: dict, want: dict, rtol: float, rel_atol: float):
    """Leaves of ``got`` against ``want``: rtol over an absolute floor of
    ``rel_atol`` times the largest magnitude in the whole tree (leaves whose
    exact gradient is 0, as the key biases', hold only rounding noise)."""
    leaves = list(_leaves(want))
    floor = rel_atol * max(np.abs(w).max() for _, w in leaves)
    assert sorted(p for p, _ in _leaves(got)) == sorted(p for p, _ in leaves)
    for path, w in leaves:
        np.testing.assert_allclose(_get(got, path), w, rtol=rtol, atol=floor,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_dacs_loss_and_param_grads_match_jax(stage):
    """The stage's loss, every metric and the gradient of every parameter
    (none frozen here) against jax.value_and_grad. Tolerances: metrics rtol
    1e-4; gradients rtol 1e-3 over a floor of 1e-4 of each leaf's largest
    value (fp32 through two encoders that sum in another order)."""
    from privacy_preserve_federated_asr_tpu.models.objectives import dacs_loss as jdacs_loss

    jcfg, cfg = _cfgs(stage, ad_loss="recall", lambda_grl=0.3)
    x, il, labels, ll, dem, sm, noise = _batch(cfg)
    params = _jax_params(jcfg)
    jmodel = JaxDACSModel(jcfg)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(il),
                           deterministic=False, backbone_deterministic=stage != 0,
                           gumbel_noise=tuple(jnp.asarray(n) for n in noise))
        return jdacs_loss(out, jnp.asarray(labels), jnp.asarray(ll), jnp.asarray(dem),
                          jcfg, p["similar_fc"]["kernel"], jnp.asarray(sm))

    (ref, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = _port_model(cfg, params)
    model.train()
    if stage != 0:
        model.backbone.eval()
    out = model(torch.from_numpy(x), torch.from_numpy(il),
                gumbel_noise=tuple(torch.from_numpy(n) for n in noise))
    loss, metrics = dacs_loss(out, *(torch.from_numpy(a) for a in (labels, ll, dem)),
                              cfg, model.similar_fc.weight, torch.from_numpy(sm))
    loss.backward()
    assert set(metrics) == set(ref_metrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(ref_metrics[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    # params the stage's loss does not reach get no grad here, zeros in JAX
    grads = flax_from_state_dict({n: torch.zeros_like(p) if p.grad is None else p.grad
                                  for n, p in model.named_parameters()})
    _assert_tree_close(grads, jax.device_get(ref_grads), rtol=1e-3, rel_atol=1e-4)
    assert loss.item() > 0 and np.isfinite(loss.item())
    if stage == 0:  # the pruned loss of the train step gives the same value
        out2 = model(torch.from_numpy(x), torch.from_numpy(il), need_masks=False)
        pruned, _ = dacs_loss(out2, *(torch.from_numpy(a) for a in (labels, ll, dem)),
                              cfg, model.similar_fc.weight, torch.from_numpy(sm),
                              aux_metrics=False)
        np.testing.assert_allclose(pruned.item(), loss.item(), rtol=1e-6)


def _feature_batch(feats, fl, labels, ll, dem, sm):
    return FeatureBatch(*(torch.as_tensor(np.array(a)) for a in
                          (feats, fl, labels, ll, dem, sm)))


def test_param_trajectory_matches_jax_feature_step():
    """Three stage-0 AdamW steps of make_feature_train_step (lr schedule:
    warmup 1, peak 1e-3, so step 1 moves nothing) against the JAX step on
    the same cached features: loss and grad norm per step (rtol 1e-4) and
    the parameters after each step (tolerances stated against the peak lr
    below). Frozen params stay bit-equal and every trainable one moves."""
    from privacy_preserve_federated_asr_tpu.train import optim as joptim
    from privacy_preserve_federated_asr_tpu.train.steps import FeatureBatch as JFB
    from privacy_preserve_federated_asr_tpu.train.steps import (
        frontend_forward_fn as jfrontend,
        make_feature_train_step as jmake,
    )
    from privacy_preserve_federated_asr_tpu.train.train_state import create_train_state as jcreate

    peak = 1e-3
    jcfg, cfg = _cfgs(0)
    x, il, labels, ll, dem, sm, _ = _batch(cfg, seed=3)
    params = _jax_params(jcfg, seed=11)
    jmodel = JaxDACSModel(jcfg)
    feats, fl = jax.jit(jfrontend(jmodel))(params, jnp.asarray(x), jnp.asarray(il))
    feats, fl = np.asarray(feats), np.asarray(fl)
    tx = joptim.make_optimizer(params, stage=0,
                               learning_rate=joptim.make_lr_schedule(peak, 1, 4))
    jstate = jcreate(params, tx, jax.random.PRNGKey(0))
    jstep = jax.jit(jmake(jmodel, tx, jcfg))
    jbatch = JFB(*(jnp.asarray(a) for a in (feats, fl, labels, ll, dem, sm)))

    model = _port_model(cfg, params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(
        model, make_optimizer(model, 0, learning_rate=make_lr_schedule(peak, 1, 4)), 0)
    step = make_feature_train_step(cfg)
    batch = _feature_batch(feats, fl, labels, ll, dem, sm)
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        m = step(state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
        got = flax_from_state_dict(model.state_dict())
        for path, w in _leaves(jax.device_get(jstate.params)):
            # Adam divides by |g|: an element whose gradient is at rounding
            # level moves by up to lr in either framework, so no bound on
            # the largest difference could fail. All but 0.5% of each leaf's
            # elements are held to 1e-2 lr instead. The key bias is exempt:
            # its exact gradient is 0 (softmax ignores a shift shared by all
            # keys), so it is all noise. Step 1 has lr 0: nothing moves.
            diff = np.abs(_get(got, path) - w)
            where = f"step {i + 1} {'/'.join(path)}"
            assert np.isfinite(diff).all(), where
            if i == 0:
                assert diff.max() <= 1e-6, where
            elif path[-2:] != ("k_proj", "bias"):
                assert (diff > 1e-2 * peak).mean() <= 5e-3, where
    assert state.step == 3
    moved = 0
    for k, v in model.state_dict().items():
        if k.startswith(FROZEN_AT_STAGE0):
            assert torch.equal(v, before[k]), k
        else:
            moved += not torch.equal(v, before[k])
    assert moved == sum(not k.startswith(FROZEN_AT_STAGE0) for k in before)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_feature_step_equals_full_step():
    """The cached-frontend step against the full-forward step from
    waveforms, dropouts live (0.1): same random streams, same loss, grad
    norm and updated params (rtol 1e-5)."""
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=0)
    x, il, labels, ll, dem, sm, _ = _batch(cfg, seed=4)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(2))
    outs = []
    for cached in (False, True):
        model = DACSModel(cfg)
        model.load_state_dict(sd)
        state = create_train_state(model, make_optimizer(model, 0, learning_rate=1e-3), 5)
        if cached:
            feats, fl = frontend_forward_fn(model)(torch.from_numpy(x), torch.from_numpy(il))
            batch = _feature_batch(feats, fl, labels, ll, dem, sm)
            metrics = [make_feature_train_step(cfg)(state, batch) for _ in range(2)]
        else:
            batch = DeviceBatch(*(torch.from_numpy(a) for a in (x, il, labels, ll, dem, sm)))
            metrics = [make_train_step(cfg)(state, batch) for _ in range(2)]
        outs.append((metrics, model.state_dict()))
    (m_full, sd_full), (m_feat, sd_feat) = outs
    for a, b in zip(m_full, m_feat):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-5, err_msg=k)
    for k in sd_full:
        torch.testing.assert_close(sd_feat[k], sd_full[k], rtol=1e-5, atol=1e-7, msg=k)


def test_weight_decay_groups_match_jax_mask():
    """Biases and LayerNorm / GroupNorm weights (flax ``scale``) are in the
    no-decay group; every other trainable param, masked_spec_embed
    included, decays."""
    from privacy_preserve_federated_asr_tpu.train.optim import _no_weight_decay

    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(mask_time_prob=0.05,
                                                            feat_extract_norm="group"),
                     stage=0)
    model = DACSModel(cfg)
    skip = no_decay_names(model)
    flax_keys = dict(zip(model.state_dict(),
                         _leaves(flax_from_state_dict(model.state_dict()))))
    assert "backbone.masked_spec_embed" in flax_keys
    for name, (path, _) in flax_keys.items():
        assert (name in skip) == _no_weight_decay(path), name
    tx = make_optimizer(model, 0)
    decay, no_decay = tx.adamw.param_groups
    assert decay["weight_decay"] == 0.005 and no_decay["weight_decay"] == 0.0
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable == {n for n in flax_keys if not n.startswith(FROZEN_AT_STAGE0)}
    assert len(no_decay["params"]) == len(trainable & skip)


def test_lr_schedule_matches_optax():
    from privacy_preserve_federated_asr_tpu.train.optim import make_lr_schedule as jsched

    for warmup, total in ((0, 7), (3, 10), (5, 5)):
        ours, ref = make_lr_schedule(2e-3, warmup, total), jsched(2e-3, warmup, total)
        for count in range(total + 3):
            np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6,
                                       atol=1e-12)


# ---------------------------------------------------------------------------
# Trainer and cli train on the CPU (short synthetic audio)
# ---------------------------------------------------------------------------

SENTENCES = ["THE BOY IS ON A STOOL", "THE JAR IS OPEN", "SHE DRIES DISHES",
             "WATER IS ON THE FLOOR"]


def _examples(n, seed=0):
    rng = np.random.default_rng(seed)
    exs = []
    for i in range(n):
        wav = rng.normal(0, 0.1, int(rng.integers(2400, 4000))).astype(np.float32)
        exs.append(AsrExample(path=f"S{i % 3:03d}_PAR_{i}.wav", array=wav,
                              text=SENTENCES[i % len(SENTENCES)], dementia_label=i % 2))
    return prepare_examples(exs, CTCCharTokenizer())


@pytest.fixture
def no_tensorboard(monkeypatch):
    """record_result's TensorBoard sink imports TensorFlow (~10 s) where it
    is installed: blocked, the sink returns None as without TensorBoard."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_trainer_train_evaluate_save_resume(tmp_path, no_tensorboard, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=0)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    tcfg = TrainerConfig(num_epochs=2, batch_size=3, eval_batch_size=2, logging_steps=1,
                         eval_steps=4, save_steps=2, learning_rate=1e-3, time_multiple=1600,
                         save_dir=str(tmp_path / "model"), log_file="log.txt",
                         log_dir=str(tmp_path / "log"))
    tr = Trainer(cfg, sd, _examples(5), _examples(3, seed=1), CTCCharTokenizer(), tcfg,
                 device="cpu")
    assert tr._cache_frontend
    tr.train()
    assert tr.state.step == 4
    rows = [r for r in tr.logger.history if "loss" in r]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in rows)
    assert any("eval_wer" in r for r in tr.logger.history)
    ev = tr.evaluate()
    assert set(ev) == {"eval_loss", "eval_wer", "eval_ad_acc"} and np.isfinite(ev["eval_loss"])
    final = torch.load(tmp_path / "model/final/model.pt", weights_only=True)
    for k, v in final.items():
        if k.startswith(FROZEN_AT_STAGE0):
            assert torch.equal(v, sd[k]), k
    assert not torch.equal(final["lm_head.weight"], sd["lm_head.weight"])
    assert sorted(p.name for p in (tmp_path / "model").iterdir()) == [
        "checkpoint-2", "checkpoint-4", "final"]

    # resume from step 2 for one epoch: the full state (moments, schedule,
    # random streams) continues to the same step-4 params (a constant lr, as
    # the schedule's length follows num_epochs; the epoch-0 and epoch-1
    # batch orders of seed 0 coincide here)
    resumed = Trainer(cfg, sd, _examples(5), None, CTCCharTokenizer(),
                      dataclasses.replace(tcfg, num_epochs=1, save_dir=None,
                                          resume_from=str(tmp_path / "model/checkpoint-2")),
                      device="cpu")
    assert resumed.state.step == 2
    resumed.train()
    for k, v in resumed.state.model.state_dict().items():
        torch.testing.assert_close(v, final[k], rtol=1e-5, atol=1e-7, msg=k)


@pytest.mark.parametrize("method,stage", [("dacs", 1), ("dacs", 2), ("grl", 0),
                                          ("toggle_more", 3)])
def test_trainer_full_forward_recipes(method, stage):
    """The full-forward step (no frontend cache) for the other stages and
    recipes: finite loss, exactly the recipe's trainable params move."""
    from privacy_preserve_federated_asr_tpu_torch.models.recipes import get_recipe
    from privacy_preserve_federated_asr_tpu_torch.train.optim import path_of

    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=stage, method=method)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    tcfg = TrainerConfig(batch_size=2, logging_steps=1, learning_rate=1e-3,
                         time_multiple=1600, log_dir=".", cache_encoder=False)
    tr = Trainer(cfg, sd, _examples(2), None, CTCCharTokenizer(), tcfg, device="cpu")
    assert not tr._cache_frontend and not tr._cache_encoder
    tr.train()
    assert tr.state.step == 1 and np.isfinite(tr.logger.history[0]["loss"])
    pred = get_recipe(method).trainable(stage)
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(v, sd[k]) != pred(path_of(k)), k


@pytest.mark.parametrize("option", [dict(dp=2), dict(tp=2), dict(pp=2), dict(sp=2),
                                    dict(zero1=True), dict(pp=2, scan_layers=True),
                                    dict(tp=2, remat=True), dict(dp=2, grad_accum=2),
                                    dict(sp=2, scan_layers=True), dict(zero1=True, prefetch=2)])
def test_options_not_ported_raise(option):
    """The parallel options run one rank per device (tests/test_torch_parallel.py);
    in one process each is refused with JAX's message, alone or beside the
    options that run (scan_layers, remat, grad_accum, prefetch): a layout
    JAX refuses (pp/sp without scan_layers, zero1 without dp >= 2), or a
    valid one that needs more devices than the one this process has."""
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(), stage=0)
    t = TrainerConfig(**option)
    if t.zero1:
        match = "zero1 shards optimizer state over the 'data' axis: it requires dp >= 2"
    elif (t.pp > 1 or t.sp > 1) and not t.scan_layers:
        match = f"{'pp' if t.pp > 1 else 'sp'} > 1 requires scan_layers=True"
    else:
        second = "tp" if t.pp == t.sp == 1 else "pp" if t.pp > 1 else "sp"
        n = t.dp * t.tp * t.pp * t.sp
        match = f"dp={t.dp} x {second}={getattr(t, second)} needs {n} devices, have 1"
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, {}, [], None, CTCCharTokenizer(), t, device="cpu")


def _write_corpus(root, n_train=4, n_test=2):
    rng = np.random.default_rng(0)
    (root / "clips").mkdir(parents=True)
    rows = {"train": [], "test": []}
    for i in range(n_train + n_test):
        name = f"S{i:03d}_PAR_0_0_250.wav"
        wav = (rng.normal(0, 0.1, int(rng.integers(2400, 4000))) * 32767).astype(np.int16)
        wavfile.write(root / "clips" / name, 16000, wav)
        rows["train" if i < n_train else "test"].append(f"{name},{SENTENCES[i % 4].lower()}")
    for split, r in rows.items():
        (root / f"{split}.csv").write_text("path,sentence\n" + "\n".join(r) + "\n")
    np.save(root / "spk2label.npy", {f"S{i:03d}": i % 2 for i in range(n_train + n_test)})


def test_cli_train_on_cpu(tmp_path, no_tensorboard, monkeypatch, capsys):
    """Two utterances (one step at batch 2) padded to the CLI's 1 s bucket."""
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path / "data", n_train=2, n_test=1)
    args = ["train", "--model_type", "tiny", "--audio_dir", "data/clips",
            "--train_csv", "data/train.csv", "--test_csv", "data/test.csv",
            "--spk2label", "data/spk2label.npy", "--dataset_cache", "cache",
            "--compute_dtype", "float32", "--train_batch_size", "2",
            "--eval_batch_size", "2", "--epochs", "1", "-st", "0",
            "-model_out", "out", "--device", "cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args[:-2])  # the default device is cuda
    tr = cli.main(args)
    assert tr.state.step == 1
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ev) == {"eval_loss", "eval_wer", "eval_ad_acc"}
    # the export loads back through --model_in, as serve takes it
    cfg = tr.cfg
    sd = cli.load_weights(cfg, "out/final")
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
