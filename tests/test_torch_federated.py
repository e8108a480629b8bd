"""The port's federated path (privacy_preserve_federated_asr_tpu_torch/
parallel/fed.py, federated/, the Trainer's cache_encoder, ``cli federated``)
against the JAX package's on a tiny DACS model at fp32 with zero dropouts,
the same weights (carried across with state_dict_from_flax) and the same
speaker-partitioned clients of 4 and 6 utterances (so one client runs a
padding step). JAX is imported inside the tests and fixtures that use it, so
the card-only test also runs where JAX is not installed:
``python -m pytest tests/test_torch_federated.py -m cuda --noconftest``."""

import functools
import json

import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.data import AsrExample, CTCCharTokenizer
from privacy_preserve_federated_asr_tpu_torch.federated import (
    FederatedConfig,
    FederatedEngine,
)
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    DACSModel,
    flax_from_state_dict,
    init_dacs_state_dict,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.parallel import (
    average_weights,
    dp_fedavg,
    graft_network,
    network_mask,
    select_network,
)
from privacy_preserve_federated_asr_tpu_torch.train import (
    DeviceBatch,
    Trainer,
    TrainerConfig,
    backbone_forward_fn,
    create_train_state,
    gather_hidden,
    make_hidden_train_step,
    make_optimizer,
    make_train_step,
)

TOK = CTCCharTokenizer()
LR = 1e-3          # a constant learning rate: every step moves the params
DROPOUTS = dict(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                final_dropout=0.0)
TEXTS = ["HI", "YES", "NO WAY", "OK GO"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread avoids oversubscribing the cores the
    parallel test workers share (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(stage=0, **kw):
    return DACSConfig(backbone=BackboneConfig.tiny_for_tests(**DROPOUTS), stage=stage,
                      ad_loss="cel", **kw)


def _arrays(n, seed):
    """``n`` utterances of 0.2-0.4 s with their texts and AD labels."""
    rng = np.random.default_rng(seed)
    return [(f"S{seed}{i:02d}_PAR_0_0.wav",
             rng.normal(0, 1, [3200, 6400, 3200, 4800][i % 4]).astype(np.float32),
             TEXTS[i % 4], i % 2) for i in range(n)]


def _examples(n, seed, cls=AsrExample):
    return [cls(path=p, array=a, text=t, dementia_label=d, input_values=a,
                labels=np.asarray(TOK.encode(t), np.int32)) for p, a, t, d in _arrays(n, seed)]


def _clients(cls=AsrExample):
    return {0: _examples(4, 1, cls), 1: _examples(6, 2, cls)}


def _fcfg(cls=FederatedConfig, **kw):
    base = dict(num_rounds=1, num_clients=2, local_ep=1, global_ep=1, batch_size=2,
                eval_batch_size=2, time_multiple=3200, seed=0, warmup_steps=1,
                learning_rate=LR)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX config and seeded numpy flax params of its shapes (made once
    per process: the other port test files take this fixture too)."""
    return _jax_init()


@functools.lru_cache(maxsize=None)
def _jax_init():
    import jax.numpy as jnp

    from privacy_preserve_federated_asr_tpu.models import (
        BackboneConfig as JaxBackboneConfig,
        DACSConfig as JaxDACSConfig,
        DACSModel as JaxDACSModel,
    )
    from test_torch_backbone import random_flax_params

    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(**DROPOUTS), stage=0,
                         ad_loss="cel")
    return jcfg, random_flax_params(JaxDACSModel(jcfg), (jnp.zeros((1, 3200)),), seed=42,
                                    rng_names=("params", "gumbel", "dropout"))


def _jax_engine(jax_init, stage, **kw):
    from privacy_preserve_federated_asr_tpu.data.dataset import AsrExample as JaxExample
    from privacy_preserve_federated_asr_tpu.federated import (
        FederatedConfig as JaxFederatedConfig,
        FederatedEngine as JaxFederatedEngine,
    )

    jcfg, params = jax_init
    return JaxFederatedEngine(jcfg.replace(stage=stage), _fcfg(JaxFederatedConfig, **kw),
                              _clients(JaxExample), _examples(4, 3, JaxExample), None,
                              _jax_tok(), params)


def _jax_tok():
    from privacy_preserve_federated_asr_tpu.data.tokenizer import CTCCharTokenizer as JaxTok

    return JaxTok()


def _port_engine(jax_init, stage, **kw):
    return FederatedEngine(_cfg(stage), _fcfg(**kw), _clients(), _examples(4, 3), None, TOK,
                           state_dict_from_flax(jax_init[1], _cfg()), device="cpu")


def _run_jax(eng, stage, rounds=1):
    import jax

    eng.run_rounds(stage=stage, num_rounds=rounds)
    rows = [r for r in eng.logger.history if "fl_round" in r]
    return jax.device_get(eng.global_params), rows


# the engine comparisons run at batch 4: client 0 takes one step and one
# padding step, client 1 two steps
ROUND = dict(batch_size=4)


@pytest.fixture(scope="module", params=[0, 1])
def jax_round(request):
    """One JAX engine round at stage 0 (full forwards) or 1 (cached encoder)."""
    return request.param, _jax_round(request.param)


@functools.lru_cache(maxsize=None)
def _jax_round(stage):
    """The round of ``jax_round``, once per process (test_torch_parallel.py
    holds the port's meshes to it too)."""
    return _run_jax(_jax_engine(_jax_init(), stage, **ROUND), stage)


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


def _assert_params_match(got_sd, want_tree, network_prefixes):
    """Stage-network leaves: at least 99.5% of each leaf's elements within
    1e-2 lr (Adam divides by |g|: an element whose gradient is at rounding
    level moves by up to lr in either framework; the key bias, whose exact
    gradient is 0, is exempt); every other leaf bit-equal."""
    got = flax_from_state_dict(got_sd)
    for path, w in _leaves(want_tree):
        g = _get(got, path)
        where = "/".join(path)
        if path[0].startswith(network_prefixes):
            diff = np.abs(g - w)
            assert np.isfinite(g).all(), where
            if path[-2:] != ("k_proj", "bias"):
                assert (diff > 1e-2 * LR).mean() <= 5e-3, (where, diff.max())
        else:
            np.testing.assert_array_equal(g, w, err_msg=where)


# ---------------------------------------------------------------------------
# parallel/fed.py
# ---------------------------------------------------------------------------

def _random_sds(k, seed=0):
    cfg = _cfg()
    return [init_dacs_state_dict(cfg, torch.Generator().manual_seed(seed + i))
            for i in range(k)]


def _stacked(sds):
    """The JAX engine's layout: flax params stacked over a client axis (host
    arrays: the jitted reference takes them as they are)."""
    trees = [flax_from_state_dict(sd) for sd in sds]

    def stack(*xs):
        return np.stack(xs) if not isinstance(xs[0], dict) else {
            k: stack(*(x[k] for x in xs)) for k in xs[0]}

    return stack(*trees)


def test_select_graft_mask_match_jax():
    from privacy_preserve_federated_asr_tpu.parallel import fed as jfed

    a, b = _random_sds(2)
    ta, tb = flax_from_state_dict(a), flax_from_state_dict(b)
    path_of = {k: next(_leaves(flax_from_state_dict({k: v})))[0] for k, v in a.items()}
    for network in jfed.NETWORKS:
        jmask = dict(_leaves(jfed.network_mask(ta, network)))
        assert {path_of[k]: m for k, m in network_mask(a, network).items()} == {
            p: bool(m) for p, m in jmask.items()}
        assert set(flax_from_state_dict(select_network(a, network))) == set(
            jfed.select_network(ta, network))
        got = flax_from_state_dict(graft_network(a, b, network))
        for path, w in _leaves(jfed.graft_network(ta, tb, network)):
            np.testing.assert_array_equal(_get(got, path), w, err_msg="/".join(path))


@pytest.mark.parametrize("weighted", [False, True])
def test_fedavg_matches_fedavg_stacked(weighted):
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.parallel.fed import fedavg_stacked

    sds = _random_sds(3, seed=5)
    w = [1.0, 2.0, 4.0] if weighted else None
    want = jax.jit(fedavg_stacked)(_stacked(sds), None if w is None else jnp.asarray(w))
    got = flax_from_state_dict(average_weights(sds, w))
    for path, v in _leaves(want):
        np.testing.assert_allclose(_get(got, path), v, rtol=1e-6, atol=1e-7,
                                   err_msg="/".join(path))


def test_dp_fedavg_matches_jax_and_noise_std():
    """Multiplier 0: the clipped mean equals ``dp_fedavg_stacked`` (one
    client's delta over the clip, one under; the norm over every entry).
    Multiplier 1: the noise on a large leaf has std clip / K within 5%."""
    import jax
    from privacy_preserve_federated_asr_tpu.parallel.fed import dp_fedavg_stacked

    rng = np.random.default_rng(9)
    shapes = {"w": (6, 5), "b": (5,), "v": (3, 4, 2)}
    g = {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)) for k, s in shapes.items()}
    clients = [{k: v + torch.from_numpy(rng.normal(0, s, v.shape).astype(np.float32))
                for k, v in g.items()} for s in (0.5, 1e-3)]
    norms = [sum(float((c[k] - g[k]).square().sum()) for k in g) ** 0.5 for c in clients]
    clip = float(np.mean(norms))
    assert norms[0] > clip > norms[1]
    want = jax.jit(dp_fedavg_stacked, static_argnums=(2, 3))(
        {k: np.stack([c[k].numpy() for c in clients]) for k in g},
        {k: v.numpy() for k, v in g.items()}, clip, 0.0, jax.random.PRNGKey(0))
    got = dp_fedavg(clients, g, clip, 0.0)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7,
                                   err_msg=k)

    big = {"w": torch.zeros(400, 250)}
    noised = dp_fedavg([big, big], big, 0.8, 1.0, torch.Generator().manual_seed(1))
    std = float(noised["w"].std())
    assert abs(std - 0.8 / 2) <= 0.05 * 0.8 / 2, std


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def test_round_matches_jax_engine(jax_round, jax_init):
    """One round at stage 0 (full forwards from waveforms) and stage 1 (heads
    on the cached encoder output): client losses rtol 1e-4, the stage
    network's params by the rule of ``_assert_params_match``, every other
    param bit-equal; client 0 (4 utterances, batch 4) runs a padding step
    beside client 1's two."""
    from privacy_preserve_federated_asr_tpu.federated.engine import STAGE_NETWORK
    from privacy_preserve_federated_asr_tpu.parallel.fed import NETWORKS

    stage, (want, jrows) = jax_round
    eng = _port_engine(jax_init, stage, **ROUND)
    got = eng.run_rounds(stage=stage, num_rounds=1)
    rows = [r for r in eng.logger.history if "fl_round" in r]
    assert rows[0]["phase"] == ("res" if stage == 0 else "res_h")
    assert rows[0]["dead_step_frac"] == jrows[0]["dead_step_frac"] == 0.25
    assert rows[0]["local_steps"] == 4
    for c in (0, 1):
        np.testing.assert_allclose(rows[0][f"client{c}_loss"], jrows[0][f"client{c}_loss"],
                                   rtol=1e-4, err_msg=f"client {c}")
    _assert_params_match(got, want, NETWORKS[STAGE_NETWORK[stage]])


def test_stage2_hidden_step_matches_jax_loss_and_grad(jax_init, monkeypatch):
    """The stage-2 hidden step under the same injected Gumbel noise: loss and
    grad norm against a JAX loss-and-grad over ``apply_heads``, and the
    port's arbitrator gradient against JAX's (rtol 1e-4 over a floor of 1e-5
    of its largest value)."""
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.models.dacs import DACSModel as JaxDACSModel
    from privacy_preserve_federated_asr_tpu.models.objectives import dacs_loss

    from privacy_preserve_federated_asr_tpu_torch.models import dacs as port_dacs

    jcfg, params = jax_init
    jcfg = jcfg.replace(stage=2)
    rng = np.random.default_rng(4)
    b, t, d = 2, 31, jcfg.hidden_size
    h = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    fl = np.array([31, 20])
    labels = np.full((b, 8), -100, np.int32)
    labels[0, :5], labels[1, :3] = rng.integers(1, 32, 5), rng.integers(1, 32, 3)
    ll, dem, sm = np.array([5, 3]), np.array([1, 0]), np.ones(b, np.float32)
    noise = [rng.gumbel(size=(b, t, d, 2)).astype(np.float32) for _ in range(2)]
    fm = (np.arange(t)[None] < fl[:, None]).astype(np.int32)
    jmodel = JaxDACSModel(jcfg)

    def loss_fn(arb):
        p = dict(params, arbitrator=arb)
        out = jmodel.apply({"params": p}, jnp.asarray(h), jnp.asarray(fm), jnp.asarray(fl),
                           False, tuple(jnp.asarray(n) for n in noise),
                           method=JaxDACSModel.apply_heads)
        return dacs_loss(out, jnp.asarray(labels), jnp.asarray(ll), jnp.asarray(dem), jcfg,
                         p["similar_fc"]["kernel"], jnp.asarray(sm))

    (ref, _), ref_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["arbitrator"])

    cfg = _cfg(2)
    model = DACSModel(cfg)
    model.load_state_dict(state_dict_from_flax(params, cfg))
    draws = iter(torch.from_numpy(n) for n in noise)
    monkeypatch.setattr(port_dacs, "sample_gumbel", lambda shape, gen, dev: next(draws))
    grads = {}
    tx = make_optimizer(model, 2, learning_rate=LR, max_grad_norm=float("inf"))
    monkeypatch.setattr(tx.adamw, "step", lambda: grads.update(
        {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}))
    state = create_train_state(model, tx, 0)
    batch = gather_hidden(*(torch.from_numpy(np.asarray(x)) for x in
                            (h, fl, labels, ll, dem, np.arange(b))))
    metrics = make_hidden_train_step(cfg)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(ref), rtol=1e-4)
    jg = jax.device_get(ref_grad)
    np.testing.assert_allclose(
        float(metrics["grad_norm"]),
        float(np.sqrt(sum((np.asarray(x) ** 2).sum() for x in jax.tree.leaves(jg)))),
        rtol=1e-4)
    assert set(grads) == {"arbitrator.weight", "arbitrator.bias"}
    floor = 1e-5 * np.abs(jg["kernel"]).max()
    np.testing.assert_allclose(grads["arbitrator.weight"].numpy().T, jg["kernel"],
                               rtol=1e-4, atol=floor)
    np.testing.assert_allclose(grads["arbitrator.bias"].numpy(), jg["bias"],
                               rtol=1e-4, atol=floor)


def test_stage2_round_equals_client_by_client_reconstruction():
    """A stage-2 round is exactly its own hidden steps run client by client
    (fresh AdamW per client, each client's seed) plus FedAvg plus graft:
    only ``arbitrator.*`` changes."""
    cfg = _cfg(2)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(3))
    eng = FederatedEngine(cfg, _fcfg(), _clients(), _examples(4, 3), None, TOK, sd,
                          device="cpu")
    got = eng.run_rounds(stage=2, num_rounds=1)

    h_all, fl_all = next(iter(eng._round_hidden.values()))
    cids = [eng.client_ids[i] for i in np.random.default_rng(0).choice(2, 2, replace=False)]
    data_all, rows, idx = eng._client_round_indices(cids, 0, eng.client_examples)
    clients = []
    for ki, r in enumerate(rows):
        model = DACSModel(cfg)
        model.load_state_dict(sd)
        tx = make_optimizer(model, 2, LR, warmup_steps=1, total_steps=idx.shape[1])
        state = create_train_state(model, tx, eng._client_seed(0, ki, 0))
        step = make_hidden_train_step(cfg)
        for i in idx[ki]:
            step(state, gather_hidden(h_all[r], fl_all[r], data_all.labels[r],
                                      data_all.label_lengths[r], data_all.dementia_labels[r],
                                      i, row_mask=data_all.sample_mask[r]))
        clients.append(model.state_dict())
    want = graft_network(sd, average_weights(clients), "toggling_network")
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(v, sd[k]) != k.startswith("arbitrator."), k


@pytest.fixture(scope="module")
def cached_stage1_round():
    """The reference of ``test_stage1_round_paths_agree``: one stage-1 round
    on the cached encoder output (its params and log row)."""
    cfg = _cfg(1)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(8))
    eng = FederatedEngine(cfg, _fcfg(**ROUND), _clients(), [], None, TOK, sd, device="cpu")
    params = eng.run_rounds(stage=1, num_rounds=1)
    return sd, params, [r for r in eng.logger.history if "local_steps" in r][0]


@pytest.mark.parametrize("mode,phase", [(dict(resident_client_data=False), "sup"),
                                        (dict(cache_budget_bytes=64), "res")])
def test_stage1_round_paths_agree(mode, phase, cached_stage1_round):
    """A stage-1 round staged per round (full forwards at the round's
    padding) or resident past the cache budget (full forwards) against the
    round on the cached encoder output: rtol 2e-4, as the JAX package holds
    its own paths (tests/test_federated.py)."""
    sd, cached, row = cached_stage1_round
    assert row["phase"] == "res_h"
    eng = FederatedEngine(_cfg(1), _fcfg(**ROUND, **mode), _clients(), [], None, TOK, sd,
                          device="cpu")
    params = eng.run_rounds(stage=1, num_rounds=1)
    assert [r for r in eng.logger.history if "local_steps" in r][0]["phase"] == phase
    for k, v in cached.items():
        torch.testing.assert_close(params[k], v, rtol=2e-4, atol=1e-6, msg=k)


def test_hidden_step_equals_full_step():
    """The cached-encoder step against the full step from waveforms on the
    same rows, the same seeds and live final dropout (0.1): loss, grad norm
    and updated params (rtol 1e-5)."""
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(final_dropout=0.1), stage=2)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(6))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0, 1, (2, 3200)).astype(np.float32))
    il = torch.tensor([3200, 2100], dtype=torch.int32)
    labels = torch.full((2, 8), -100, dtype=torch.int32)
    labels[0, :4], labels[1, :2] = torch.tensor([5, 6, 7, 8]), torch.tensor([9, 10])
    ll, dem, sm = torch.tensor([4, 2]), torch.tensor([0, 1]), torch.ones(2)
    outs = []
    for cached in (False, True):
        model = DACSModel(cfg)
        model.load_state_dict(sd)
        state = create_train_state(model, make_optimizer(model, 2, learning_rate=LR), 7)
        if cached:
            h, fl = backbone_forward_fn(model)(x, il)
            batch = gather_hidden(h, fl, labels, ll, dem, torch.arange(2))
            step = make_hidden_train_step(cfg)
        else:
            batch, step = DeviceBatch(x, il, labels, ll, dem, sm), make_train_step(cfg)
        outs.append(([step(state, batch) for _ in range(2)], model.state_dict()))
    (m_full, sd_full), (m_hid, sd_hid) = outs
    for a, b in zip(m_full, m_hid):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=1e-5, err_msg=k)
    for k in sd_full:
        torch.testing.assert_close(sd_hid[k], sd_full[k], rtol=1e-5, atol=1e-7, msg=k)


def test_trainer_cache_encoder_on_off_and_jax(jax_init):
    """The stage-1 Trainer with ``cache_encoder`` on (auto) and off gives the
    same params (rtol 1e-5), and after one epoch matches the JAX Trainer's
    (``_assert_params_match``: dementia_head held, the rest bit-equal)."""
    import jax
    from privacy_preserve_federated_asr_tpu.data.dataset import AsrExample as JaxExample
    from privacy_preserve_federated_asr_tpu.train.trainer import (
        Trainer as JaxTrainer,
        TrainerConfig as JaxTrainerConfig,
    )

    jcfg, params = jax_init
    kw = dict(num_epochs=1, batch_size=2, learning_rate=LR, time_multiple=3200,
              logging_steps=1, log_dir=".")
    jtr = JaxTrainer(jcfg.replace(stage=1), params, _examples(6, 2, JaxExample), None,
                     _jax_tok(), JaxTrainerConfig(**kw, prefetch=0))
    assert jtr._cache_encoder
    want = jax.device_get(jtr.train().params)

    got = {}
    for cache in (None, False):
        tr = Trainer(_cfg(1), state_dict_from_flax(params, _cfg()), _examples(6, 2), None,
                     TOK, TrainerConfig(**kw, cache_encoder=cache), device="cpu")
        assert tr._cache_encoder == (cache is None) and not tr._cache_frontend
        tr.train()
        got[cache] = tr.state.model.state_dict()
    for k, v in got[None].items():
        torch.testing.assert_close(v, got[False][k], rtol=1e-5, atol=1e-7, msg=k)
    _assert_params_match(got[None], want, ("dementia_head",))
    with pytest.raises(ValueError, match="frozen backbone"):
        Trainer(_cfg(0), got[None], [], None, TOK, TrainerConfig(cache_encoder=True),
                device="cpu")


def test_hidden_cache_rebuilt_after_stage0(jax_init):
    """The encoder-output cache survives consecutive stage-1 rounds and the
    eval Trainer's hidden eval cache is reused; stage-0 training drops both,
    and the next stage-1 rounds rebuild them from the new backbone."""
    eng = _port_engine(jax_init, 1, **ROUND)
    eng.eval_examples = _examples(2, 4)
    eng.run_rounds(stage=1, num_rounds=1)
    (key, (h0, _)), = eng._round_hidden.items()
    ev = eng._eval_trainers[1]
    e0 = ev._hidden_eval[0][1].hidden_states
    eng.run_rounds(stage=1, num_rounds=1)
    assert eng._round_hidden[key][0] is h0, "the cache must persist across calls"
    assert ev._hidden_eval[0][1].hidden_states is e0
    eng.run_rounds(stage=0, num_rounds=1)  # trains the backbone
    assert not eng._round_hidden and ev._hidden_eval is None
    eng.run_rounds(stage=1, num_rounds=1)
    h1 = eng._round_hidden[key][0]
    assert not torch.allclose(h0, h1), "the rebuilt cache must see the new backbone"
    assert eng._eval_trainers[1] is ev
    assert not torch.allclose(ev._hidden_eval[0][1].hidden_states, e0)


# ---------------------------------------------------------------------------
# DP-FedAvg accounting and round checkpoints
# ---------------------------------------------------------------------------

DP = dict(dp_clip_norm=1.0, dp_noise_multiplier=1.0)


@pytest.fixture(scope="module")
def dp_run(jax_init, tmp_path_factory):
    """Three DP-FedAvg stage-1 rounds of the port with round checkpoints."""
    d = tmp_path_factory.mktemp("rounds")
    eng = _port_engine(jax_init, 1, round_save_dir=str(d), **DP)
    eng.run_rounds(stage=1, num_rounds=3)
    return eng, d


def test_dp_epsilon_matches_jax_engine(dp_run, jax_init):
    eng, _ = dp_run
    _, jrows = _run_jax(_jax_engine(jax_init, 1, **DP), 1, rounds=3)
    rows = [r for r in eng.logger.history if "fl_round" in r]
    eps = [r["dp_epsilon"] for r in rows]
    assert eps == [r["dp_epsilon"] for r in jrows]
    assert all(np.isfinite(eps)) and eps[0] < eps[1] < eps[2]
    assert all(r["dp_delta"] == 1e-5 for r in rows)


def test_round_checkpoints_save_resume_prune(dp_run, jax_init, tmp_path):
    import shutil

    eng, d = dp_run
    assert sorted(p.name for p in d.iterdir()) == [
        "stage1-round-2", "stage1-round-2-dp.json", "stage1-round-3",
        "stage1-round-3-dp.json"]
    # every round already done: a new engine on a copy of the checkpoints
    # loads round 3 and stops
    d2 = shutil.copytree(d, tmp_path / "rounds")
    again = _port_engine(jax_init, 1, round_save_dir=str(d2), **DP)
    for k, v in again.run_rounds(stage=1, num_rounds=3).items():
        assert torch.equal(v, eng.global_params[k]), k
    assert [r for r in again.logger.history if "fl_resume_round" in r] == [
        {"fl_resume_round": 3, "stage": 1}]
    assert not [r for r in again.logger.history if "fl_round" in r]
    # one more round: only round 4 runs, on the restored privacy spend, and
    # gives what the first engine's own fourth round gives
    again.run_rounds(stage=1, num_rounds=4)
    eng.run_rounds(stage=1, num_rounds=4)

    def rounds(e):
        return [{k: v for k, v in r.items() if k != "round_s"}
                for r in e.logger.history if "fl_round" in r]

    assert [r["fl_round"] for r in rounds(again)] == [4]
    assert rounds(eng)[-1] == rounds(again)[0]
    for k, v in again.global_params.items():
        assert torch.equal(v, eng.global_params[k]), k
    for where in (d, d2):
        assert sorted(p.name for p in where.iterdir()) == [
            "stage1-round-3", "stage1-round-3-dp.json", "stage1-round-4",
            "stage1-round-4-dp.json"]


# ---------------------------------------------------------------------------
# cli federated, devices and the options not ported
# ---------------------------------------------------------------------------

def _write_corpus(root, n_train=1, n_test=1):
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    (root / "clips").mkdir(parents=True)
    rows = {"train": [], "test": []}
    for i in range(n_train + n_test):
        name = f"S{i:03d}_PAR_0_0_250.wav"
        wav = (rng.normal(0, 0.1, int(rng.integers(2400, 4000))) * 32767).astype(np.int16)
        wavfile.write(root / "clips" / name, 16000, wav)
        rows["train" if i < n_train else "test"].append(f"{name},{TEXTS[i % 4].lower()}")
    for split, r in rows.items():
        (root / f"{split}.csv").write_text("path,sentence\n" + "\n".join(r) + "\n")
    np.save(root / "spk2label.npy", {f"S{i:03d}": i % 2 for i in range(n_train + n_test)})


CLI = ["federated", "--model_type", "tiny", "--audio_dir", "data/clips",
       "--train_csv", "data/train.csv", "--test_csv", "data/test.csv",
       "--spk2label", "data/spk2label.npy", "--dataset_cache", "cache",
       "--compute_dtype", "float32", "--train_batch_size", "1", "--eval_batch_size", "1",
       "--epochs", "1", "--local_ep", "1", "--global_ep", "0", "--num_users", "1",
       "-lr", "1e-3",
       "-model_out", "out/m", "--device", "cpu"]


def test_cli_federated_on_cpu(tmp_path, monkeypatch, capsys):
    """The full pipeline (-fl_st 0) on one client's 0.15-0.25 s utterance in
    the CLI's 1 s bucket, without warm-starts: three finals that
    ``cli.load_weights`` reads back, each stage moving only its network, and
    a finite final evaluation."""
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path / "data")
    eng = cli.main(CLI)
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ev) == {"eval_loss", "eval_wer", "eval_ad_acc"}
    assert np.isfinite(ev["eval_loss"])
    cfg = _cfg()
    init = cli.load_weights(cfg, None)  # cmd_federated's own seeded init
    finals = [cli.load_weights(cfg, f"out/m_{n}_global/final") for n in ("FLASR", "FLAD",
                                                                          "final")]
    for k, v in finals[-1].items():
        assert torch.equal(v, eng.global_params[k]), k
    moved = [{k for k in a if not torch.equal(a[k], b[k])}
             for a, b in zip([init] + finals, finals)]
    assert "lm_head.weight" in moved[0] and all(
        k.startswith(("backbone.", "lm_head.")) and "feature_extractor" not in k
        for k in moved[0])
    assert moved[1] == {"dementia_head.weight", "dementia_head.bias"}
    assert moved[2] == {"arbitrator.weight", "arbitrator.bias"}


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedEngine(_cfg(), FederatedConfig(), {0: []}, [], None, TOK, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(CLI[:-2])


@pytest.mark.parametrize("option", [
    dict(mesh=(2, 1, 1)), dict(zero1=True), dict(tp=True), dict(mesh=(1, 2, 1), remat=True),
    dict(zero1=True, fedprox_mu=0.01), dict(tp=True, server_optimizer="adam"),
    ["--client_mesh", "2"], ["--data_mesh", "2"], ["--model_mesh", "2"],
    ["--fl_zero1"], ["--client_mesh", "2", "--num_lms", "2", "--num_slices", "2"]])
def test_options_not_ported_raise(option):
    """The meshes, zero1 and tp run one rank per device
    (tests/test_torch_parallel.py). In one process each is refused with JAX's
    ValueError, alone, beside options that run (remat, FedProx, FedOpt) and
    from the CLI: zero1 without a data axis, tp without a model axis, and a
    mesh of more devices (or slices) than the one this process has."""
    from privacy_preserve_federated_asr_tpu_torch.parallel import make_mesh

    match = ("needs 2 devices, have 1|do not split into 2 slices|zero1 shards per-client "
             "Adam moments over the 'data' mesh axis|tp Megatron-shards each client's")
    with pytest.raises(ValueError, match=match):
        if isinstance(option, list):
            cli.main(CLI + option)
        else:
            if "mesh" in option:
                option = {**option, "mesh": make_mesh(*option["mesh"][:2],
                                                      model=option["mesh"][2])}
            FederatedConfig(**option)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_stage1_round_matches_cpu():
    """One stage-1 round of the tiny model (widened to heads of 64, the
    kernels' head size) on the card, the cache built through kernel B1,
    against the CPU: client losses rtol 1e-4, at most 0.5% of the elements
    further apart than 1e-2 lr, and only dementia_head moved."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(
        hidden_size=128, num_attention_heads=2, intermediate_size=128, **DROPOUTS),
        stage=1)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cuda", "cpu"):
        eng = FederatedEngine(cfg, _fcfg(), _clients(), [], None, TOK, sd, device=dev)
        params = eng.run_rounds(stage=1, num_rounds=1)
        row = [r for r in eng.logger.history if "fl_round" in r][0]
        assert row["phase"] == "res_h"
        out[dev] = (row, {k: v.cpu() for k, v in params.items()})
    (rg, pg), (rc, pc) = out["cuda"], out["cpu"]
    for c in (0, 1):
        np.testing.assert_allclose(rg[f"client{c}_loss"], rc[f"client{c}_loss"], rtol=1e-4)
    off = sum(int(((pg[k] - v).abs() > 1e-2 * LR).sum()) for k, v in pc.items())
    assert off <= 5e-3 * sum(v.numel() for v in pc.values())
    for k, v in pc.items():
        assert torch.isfinite(pg[k]).all() and (torch.equal(pg[k], v)
                                                 or k.startswith("dementia_head.")), k
