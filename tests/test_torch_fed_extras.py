"""The rest of the port's federated engine against the JAX package's: the
aggregators of ``parallel/fed.py`` (compressed, secure, top-k), FedProx and
the FedOpt server optimizer against their optax chains, the multitask
pieces of ``federated/multitask.py``, the client partitions of
``parallel/sampling.py``, the weight bridge's scan layout and N-best heads,
one two-round engine run with FedProx, FedAdam, top-k and a semi-supervised
phase against the JAX engine (heads only, on the encoder cache), the round
sidecars' resume, and port-side rules that mirror the JAX package's own
tests where a JAX random stream cannot be carried across (secure
aggregation's masks, the N-best round's Gumbel passes). Tiny shapes, fp32,
seeded numpy inputs; every tolerance is stated at its assert."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.federated import FederatedConfig, FederatedEngine
from privacy_preserve_federated_asr_tpu_torch.federated import multitask as mt
from privacy_preserve_federated_asr_tpu_torch.federated.engine import ServerOptimizer
from privacy_preserve_federated_asr_tpu_torch.models import (
    DACSOutputs,
    flax_from_state_dict,
    state_dict_from_flax,
    state_dict_from_hf,
)
from privacy_preserve_federated_asr_tpu_torch.parallel import fed, sampling
from privacy_preserve_federated_asr_tpu_torch.train.optim import Optimizer
from test_torch_federated import (  # noqa: F401
    CLI,
    LR,
    TOK,
    _assert_params_match,
    _cfg,
    _clients,
    _examples,
    _fcfg,
    _get,
    _jax_tok,
    _leaves,
    _write_corpus,
    jax_init,
    one_torch_thread,
)


def _np_tree(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _client_sds(g, k, scales, seed):
    rng = np.random.default_rng(seed)
    return [{n: v + torch.from_numpy(rng.normal(0, s, v.shape).astype(np.float32))
             for n, v in g.items()} for s in scales[:k]]


def _flat_params(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "v": (3, 4, 2)}
    return {k: torch.from_numpy(rng.normal(0, 1, s).astype(np.float32))
            for k, s in shapes.items()}


def _jstack(sds):
    import jax.numpy as jnp

    return {k: jnp.stack([sd[k].numpy() for sd in sds]) for k in sds[0]}


# ---------------------------------------------------------------------------
# optimizer: FedProx and grad accumulation in the chain; the server optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_fedprox_chain_matches_optax(grad_accum):
    """``Optimizer`` with ``fedprox_mu`` (and ``grad_accum``) against optax
    ``chain(proximal_term, clip_by_global_norm, adamw)`` (under
    ``MultiSteps(use_grad_mean=False)``) on the same gradients, 4 calls with
    the clip binding: params rtol 1e-5 over atol 1e-7."""
    import jax
    import optax
    from privacy_preserve_federated_asr_tpu.train.optim import proximal_term

    mu, lr, wd, clip = 0.3, 1e-2, 0.05, 1.0
    rng = np.random.default_rng(3)
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.normal(0, 1, (3, 4)).astype(np.float32)))
        lin.bias.copy_(torch.from_numpy(rng.normal(0, 1, 3).astype(np.float32)))
    params = {"kernel": lin.weight.detach().numpy().T.copy(),
              "bias": lin.bias.detach().numpy().copy()}
    tx = optax.chain(proximal_term(mu), optax.clip_by_global_norm(clip),
                     optax.adamw(lr, weight_decay=wd,
                                 mask=lambda p: {"kernel": True, "bias": False}))
    if grad_accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=grad_accum, use_grad_mean=False)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    port = Optimizer(lin, lambda c: lr, wd, clip, fedprox_mu=mu, grad_accum=grad_accum)
    for i in range(4):
        gk, gb = rng.normal(0, 2, (4, 3)).astype(np.float32), rng.normal(0, 2, 3).astype(
            np.float32)
        params, state = update({"kernel": gk, "bias": gb}, state, params)
        lin.weight.grad, lin.bias.grad = torch.from_numpy(gk.T.copy()), torch.from_numpy(gb)
        port.step()
        np.testing.assert_allclose(lin.weight.detach().numpy().T, params["kernel"],
                                   rtol=1e-5, atol=1e-7, err_msg=f"call {i}")
        np.testing.assert_allclose(lin.bias.detach().numpy(), params["bias"], rtol=1e-5,
                                   atol=1e-7, err_msg=f"call {i}")
    assert port.schedule.last_epoch == 4 // grad_accum


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_server_optimizer_matches_optax_masked(kind):
    """``ServerOptimizer`` against optax ``masked(sgd(1.0, momentum=0.9) |
    adam(1e-2), network mask)`` on the negated round delta over 3 rounds:
    rtol 1e-5 over atol 1e-7; entries outside the network are untouched."""
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(5)
    g = {"dementia_head.weight": rng.normal(0, 1, (2, 6)), "dementia_head.bias":
         rng.normal(0, 1, 2), "arbitrator.weight": rng.normal(0, 1, (8, 6))}
    g = {k: torch.from_numpy(v.astype(np.float32)) for k, v in g.items()}
    mask = {k: k.startswith("dementia_head") for k in g}
    inner = optax.sgd(1.0, momentum=0.9) if kind == "momentum" else optax.adam(1e-2)
    tx = optax.masked(inner, mask)
    jg = _np_tree(g)
    state = tx.init(jg)

    @jax.jit
    def jstep(old, new, state):
        delta = jax.tree.map(lambda c, o: c - o, new, old)
        updates, state = tx.update(jax.tree.map(jnp.negative, delta), state)
        return optax.apply_updates(old, updates), state

    opt = ServerOptimizer(kind, 1.0 if kind == "momentum" else 1e-2, 0.9,
                          [k for k in g if mask[k]])
    for r in range(3):
        new = {k: v + (torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
                       if mask[k] else 0) for k, v in g.items()}
        jg, state = jstep(jg, _np_tree(new), state)
        g = opt.step(g, new)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"round {r} {k}")
        assert torch.equal(g["arbitrator.weight"], new["arbitrator.weight"])


# ---------------------------------------------------------------------------
# parallel/fed.py aggregators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_compressed_delta_fedavg_matches_jax(weighted):
    """Nearest rounding, 8 and 4 bits (8 weighted): rtol 1e-6 over atol 1e-7
    (the same per-client abs-max grid; sums in another order); stochastic
    rounding unbiased over 400 draws."""
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.parallel.fed import compressed_delta_fedavg

    g = _flat_params(1)
    sds = _client_sds(g, 3, (0.5, 0.1, 1e-3), seed=2)
    w = [1.0, 2.0, 5.0] if weighted else None
    for bits in (8, 4) if not weighted else (8,):
        want = jax.jit(lambda s, gg, ww: compressed_delta_fedavg(s, gg, bits=bits,
                                                                 weights=ww))(
            _jstack(sds), _np_tree(g), None if w is None else jnp.asarray(w))
        got = fed.compressed_delta_fedavg(sds, g, bits=bits, weights=w)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{bits} bits {k}")
    # stochastic rounding is unbiased: the mean over draws nears the delta
    one = [sds[0]]
    draws = torch.stack([fed.compressed_delta_fedavg(
        one, g, bits=4, generator=torch.Generator().manual_seed(s))["w"] for s in range(400)])
    d = sds[0]["w"] - g["w"]
    step = d.abs().max() / 7
    # 400 draws: the mean's error has a std of at most step / 40
    assert (draws.mean(0) - sds[0]["w"]).abs().max() <= 0.2 * step


def test_secure_aggregate_fedavg_matches_jax():
    """The masks cancel: with no client over the clip the aggregate equals
    JAX's ``secure_aggregate_fedavg`` on the same fixed-point grid (within a
    quarter of a grid step: every integer sum equal, the final fp32
    ``global + sum * s / K`` rounded in another order); with the clip
    binding on one client, within one grid step per element (its clip
    scale comes from a sum in another order). The
    payloads are masked (not the bare quantized deltas) and their
    wrap-around sum is the sum of those deltas; the int32 headroom check is
    JAX's."""
    import jax
    from privacy_preserve_federated_asr_tpu.parallel.fed import secure_aggregate_fedavg

    g = _flat_params(3)
    sds = _client_sds(g, 3, (0.05, 0.02, 0.01), seed=4)
    norms = [sum(float((sd[k] - g[k]).square().sum()) for k in g) ** 0.5 for sd in sds]
    for clip, exact in ((2.0 * max(norms), True), (0.5 * (norms[0] + norms[1]), False)):
        want = jax.jit(lambda s, gg: secure_aggregate_fedavg(
            s, gg, clip, jax.random.PRNGKey(0)))(_jstack(sds), _np_tree(g))
        got = fed.secure_aggregate_fedavg(sds, g, clip, seed=7)
        grid = clip / (2 ** 19 - 1) / 3
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                       atol=(0.25 if exact else 1.01) * grid, err_msg=k)

    clip = 2.0 * max(norms)
    acc = fed.SecAggAccumulator(list(g), 3, g, clip, seed=7, keep_payloads=True)
    for sd in sds:
        acc.add(sd)
    scale = clip / (2 ** 19 - 1)
    for k in g:
        q = [torch.round((sd[k] - g[k]) / scale).to(torch.int64) for sd in sds]
        pay = [p[k].to(torch.int64) for p in acc.payloads]
        assert not any(torch.equal(p, qq) for p, qq in zip(pay, q)), k
        assert torch.equal(fed._wrap32(sum(pay)), sum(q)), k
    with pytest.raises(ValueError, match="headroom"):
        fed.SecAggAccumulator(list(g), 5000, g, 1.0, bits=20)


def test_topk_delta_fedavg_matches_jax_over_rounds():
    """Three rounds with the error-feedback residuals carried: the new
    global and every client's residual rtol 1e-6 over atol 1e-7."""
    import jax
    from privacy_preserve_federated_asr_tpu.parallel.fed import topk_delta_fedavg

    g = _flat_params(6)
    jtopk = jax.jit(lambda s, gg, r: topk_delta_fedavg(s, gg, 0.3, residuals=r))
    res, jres = None, {k: np.zeros((3, *v.shape), np.float32) for k, v in g.items()}
    jg = _np_tree(g)
    for r in range(3):
        sds = _client_sds(g, 3, (0.3, 0.2, 0.1), seed=10 + r)
        jg, jres = jtopk(_jstack(sds), jg, jres)
        g, res = fed.topk_delta_fedavg(sds, g, 0.3, residuals=res)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(jg[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"round {r} {k}")
            np.testing.assert_allclose(torch.stack([x[k] for x in res]).numpy(),
                                       np.asarray(jres[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"round {r} residual {k}")
            assert (torch.stack([x[k] for x in res]) != 0).any()


# ---------------------------------------------------------------------------
# federated/multitask.py, parallel/sampling.py, the weight bridge
# ---------------------------------------------------------------------------

def test_multitask_loss_matches_jax():
    """Every metric of ``multitask_loss`` on the same random outputs with 2
    N-best heads against JAX's at stage 2 (every term live): rtol 1e-5 over
    atol 1e-5. Stages 0 and 1 route the final loss to the unmasked CTC and
    AD terms, with every metric the same; with ``aux_metrics=False`` a stage
    computes only its own terms (the rest 0) and the same loss."""
    import jax
    import jax.numpy as jnp
    from privacy_preserve_federated_asr_tpu.federated.multitask import (
        multitask_loss as jloss)
    from privacy_preserve_federated_asr_tpu.models.dacs import DACSOutputs as JOut

    jcfg, _ = jax_cfg_pair()
    rng = np.random.default_rng(8)
    b, t, d, v = 2, 14, jcfg.hidden_size, 32
    fl = np.array([14, 9])
    fm = (np.arange(t)[None] < fl[:, None]).astype(np.int32)
    arr = {n: rng.normal(0, 1, s).astype(np.float32) for n, s in (
        ("hidden_states", (b, t, d)), ("dementia_logits_unmask", (b, t, 2)),
        ("dementia_logits_lm", (b, t, 2)), ("dementia_logits_ad", (b, t, 2)))}
    masks = {n: (rng.random((b, t, d)) > 0.5).astype(np.float32)
             for n in ("lm_mask", "ad_mask")}
    extra = [tuple(rng.normal(0, 2, (b, t, v)).astype(np.float32) for _ in range(3))
             for _ in range(2)]
    labels = np.full((2, b, 6), -100, np.int32)
    lls = np.array([[5, 3], [4, 2]], np.int32)
    for i in range(2):
        for j in range(b):
            labels[i, j, : lls[i, j]] = rng.integers(1, v, lls[i, j])
    dem, sm = np.array([1, 0]), np.ones(b, np.float32)
    w_sim = rng.normal(0, 1, (2, d)).astype(np.float32)

    def outputs(lib, cls, **kw):
        return cls(logits_unmask=None, logits=None, logits_r=None, lm_score=None,
                   ad_score=None, frame_mask=lib(fm), frame_lengths=lib(fl),
                   extra_logits=tuple(tuple(lib(x) for x in e) for e in extra),
                   **{k: lib(x) for k, x in {**arr, **masks}.items()}, **kw)

    ref = jax.jit(lambda o, la, ll: jloss(o, la, ll, jnp.asarray(dem), jcfg,
                                          jnp.asarray(w_sim.T), jnp.asarray(sm)))(
        outputs(jnp.asarray, JOut), jnp.asarray(labels), jnp.asarray(lls))[1]
    args = (outputs(torch.from_numpy, DACSOutputs), torch.from_numpy(labels),
            torch.from_numpy(lls), torch.from_numpy(dem))
    final = {0: "ctc_unmask", 1: "ad_unmask", 2: None}
    for stage in (0, 1, 2):
        got = mt.multitask_loss(*args, _cfg(stage), torch.from_numpy(w_sim),
                                torch.from_numpy(sm))[1]
        assert set(got) == set(ref)
        for k in ref:
            want = ref[final[stage]] if k == "loss" and final[stage] else ref[k]
            np.testing.assert_allclose(float(got[k]), float(want), rtol=1e-5, atol=1e-5,
                                       err_msg=f"stage {stage} {k}")
        pruned = mt.multitask_loss(*args, _cfg(stage), torch.from_numpy(w_sim),
                                   torch.from_numpy(sm), aux_metrics=False)[1]
        assert float(pruned["loss"]) == float(got["loss"])
        assert sum(float(x) == 0.0 for k, x in pruned.items()) == {0: 6, 1: 6, 2: 2}[stage]


def jax_cfg_pair():
    from privacy_preserve_federated_asr_tpu.models import (
        BackboneConfig as JB,
        DACSConfig as JD,
    )
    from test_torch_federated import DROPOUTS

    return JD(backbone=JB.tiny_for_tests(**DROPOUTS), stage=2, ad_loss="cel"), _cfg(2)


def _fake_decode(input_values, pass_id, v=32):
    """A deterministic stand-in for the stochastic decode pass: ids from the
    audio and the pass, confidence from both."""
    x = np.abs(np.asarray(input_values))
    t = x.shape[1] // 400
    ids = ((x[:, : t * 400 : 400] * 97).astype(np.int64) + pass_id) % v
    ids[:, ::3] = 0  # blanks, so the CTC collapse has work to do
    conf = (x.mean(1) + 0.1 * pass_id).astype(np.float32)
    return ids, conf


def test_generate_pseudo_labels_matches_jax_injected_forward():
    """The same deterministic forward injected into both (it reads the pass
    from the key / generator seed, ``seed * 1000 + j``): the N-best
    (transcript, ids, confidence) per path equal; 1-best attached as JAX."""
    import jax
    from privacy_preserve_federated_asr_tpu.data.dataset import AsrExample as JEx
    from privacy_preserve_federated_asr_tpu.federated.multitask import (
        attach_pseudo_labels as jattach,
        generate_pseudo_labels as jgen,
    )

    seed = 4

    def jfwd(params, batch, rng):
        return _fake_decode(batch.input_values, int(np.asarray(rng)[-1]) - seed * 1000)

    def pfwd(model, batch, gen):
        ids, conf = _fake_decode(batch.input_values.numpy(), gen.initial_seed() - seed * 1000)
        return torch.from_numpy(ids), torch.from_numpy(conf)

    want = jgen(None, None, _examples(5, 7, JEx), _jax_tok(), 3, batch_size=2,
                time_multiple=3200, seed=seed, forward_fn=jfwd)
    got = mt.generate_pseudo_labels(_cfg(), torch.nn.Linear(1, 1), _examples(5, 7), TOK, 3,
                                    batch_size=2,
                                    time_multiple=3200, seed=seed, forward_fn=pfwd)
    assert got == want and all(len(v) == 3 for v in got.values())
    a = mt.attach_pseudo_labels(_examples(5, 7), got)
    b = jattach(_examples(5, 7, JEx), want)
    assert [(e.path, e.text, list(e.labels)) for e in a] == [
        (e.path, e.text, list(e.labels)) for e in b]


@pytest.mark.parametrize("fn", ["iid_partition", "noniid_shard_partition",
                                "noniid_unequal_partition"])
def test_partitions_match_jax(fn):
    from privacy_preserve_federated_asr_tpu.parallel import sampling as jsampling

    labels = np.random.default_rng(1).integers(0, 5, 97)
    arg = 97 if fn == "iid_partition" else labels
    for seed in (0, 3):
        got = getattr(sampling, fn)(arg, 6, seed=seed)
        want = getattr(jsampling, fn)(arg, 6, seed=seed)
        assert got.keys() == want.keys()
        for c in want:
            np.testing.assert_array_equal(got[c], want[c])


def test_scan_layout_and_nbest_heads_through_the_bridge(jax_init):
    """``stack_scan_layers`` / ``unstack_scan_layers`` round trips: the JAX
    scan tree reads as the per-layer state dict, and the port writes the
    JAX scan tree bit for bit; the N-best heads map as ``lm_heads_{i}`` <->
    ``lm_heads.{i}`` and, from a ForCTC dict, as JAX ``port_dacs_heads``."""
    from privacy_preserve_federated_asr_tpu.federated.multitask import (
        init_lm_heads_from_lm_head as jinit)
    from privacy_preserve_federated_asr_tpu.models.port import (
        port_dacs_heads,
        stack_scan_layers,
        unstack_scan_layers,
    )

    jcfg, params = jax_init
    cfg = _cfg()
    n = cfg.backbone.num_hidden_layers
    scan = dict(params, backbone=stack_scan_layers(params["backbone"], n))
    sd = state_dict_from_flax(params, cfg)
    sd_scan = state_dict_from_flax(scan, cfg)
    assert sd.keys() == sd_scan.keys()
    assert all(torch.equal(sd[k], sd_scan[k]) for k in sd)
    mine = flax_from_state_dict(sd, scan_layers=True)
    for path, w in _leaves(scan):
        np.testing.assert_array_equal(_get(mine, path), w, err_msg="/".join(path))
    back = unstack_scan_layers(mine["backbone"])
    for path, w in _leaves(params["backbone"]):
        np.testing.assert_array_equal(_get(back, path), w, err_msg="/".join(path))

    cfg3 = dataclasses.replace(cfg, num_lms=3)
    sd3 = state_dict_from_flax(jinit(params, 3), cfg3)
    assert torch.equal(sd3["lm_heads.2.weight"], sd["lm_head.weight"])
    assert mt.init_lm_heads_from_lm_head(sd, 3).keys() == sd3.keys()
    hf = {"data2vec_audio." + k[len("backbone."):]: v for k, v in sd.items()
          if k.startswith("backbone.")}
    rng = np.random.default_rng(2)
    for i in range(3):
        hf[f"lm_heads.{i}.weight"] = torch.from_numpy(rng.normal(0, 1, (32, 32)).astype(
            np.float32))
        hf[f"lm_heads.{i}.bias"] = torch.zeros(32)
    got = state_dict_from_hf(hf, cfg3)
    want = port_dacs_heads({k: v.numpy() for k, v in hf.items()})
    for i in range(3):
        np.testing.assert_array_equal(got[f"lm_heads.{i}.weight"].numpy().T,
                                      want[f"lm_heads_{i}"]["kernel"])


# ---------------------------------------------------------------------------
# the engine against the JAX engine, and the round sidecars
# ---------------------------------------------------------------------------

# top-k 0.75: the two AD classes get opposite gradients, so magnitudes come in
# near-tied pairs; 48 of the 64 weights and both biases keep every pair whole
ENGINE_OPTS = dict(fedprox_mu=0.01, server_optimizer="adam", topk_fraction=0.75,
                   supervised_level=0.5, batch_size=4)


def _unsup(cls=None):
    """Two clients' unlabeled data with their teacher transcripts."""
    kw = {} if cls is None else {"cls": cls}
    return {0: _examples(3, 5, **kw), 1: _examples(4, 6, **kw)}


@pytest.fixture(scope="module")
def jax_options_rounds(jax_init):
    """Two stage-1 rounds of the JAX engine with FedProx, FedAdam, top-k and
    a semi-supervised phase (num_lms 1: CTC-free AD heads on the encoder
    caches of both sources): the global params after each."""
    import jax
    from privacy_preserve_federated_asr_tpu.data.dataset import AsrExample as JEx
    from privacy_preserve_federated_asr_tpu.federated import (
        FederatedConfig as JFC,
        FederatedEngine as JFE,
    )

    jcfg, params = jax_init
    eng = JFE(jcfg.replace(stage=1), _fcfg(JFC, **ENGINE_OPTS), _clients(JEx),
              _examples(4, 3, JEx), None, _jax_tok(), params,
              client_unsup_examples=_unsup(JEx))
    out = []
    for _ in range(2):
        eng.run_rounds(stage=1, num_rounds=1)
        out.append(jax.device_get(eng.global_params))
    return out


def _port_options_engine(jax_init, **kw):
    return FederatedEngine(_cfg(1), _fcfg(**{**ENGINE_OPTS, **kw}), _clients(),
                           _examples(4, 3), None, TOK,
                           state_dict_from_flax(jax_init[1], _cfg()), device="cpu",
                           client_unsup_examples=_unsup())


def test_engine_options_match_jax_engine(jax_options_rounds, jax_init):
    """Each round (two calls, so the FedAdam state and the top-k residuals
    carry over) against the JAX engine: dementia_head by
    ``_assert_params_match``'s rule (99.5% of elements within 1e-2 lr),
    every other param bit-equal; both phases ran on the encoder caches."""
    eng = _port_options_engine(jax_init)
    for r, want in enumerate(jax_options_rounds):
        got = eng.run_rounds(stage=1, num_rounds=1)
        _assert_params_match(got, want, ("dementia_head",))
    rows = [r for r in eng.logger.history if "fl_round" in r and "phase" in r]
    assert [r["phase"] for r in rows] == ["res_h+res_h"] * 2
    assert len(eng._round_hidden) == 2 and eng._server_opts[1].count == 2
    assert (eng._topk_residuals[1]["dementia_head.weight"] != 0).any()


def test_round_sidecars_resume_exactly(jax_init, tmp_path, capsys):
    """A run stopped after round 1 and resumed from its round checkpoint and
    its ``-server`` and ``-topk`` sidecars gives round 2 bit for bit as the
    run that did not stop; without a sidecar the resume says so, in print
    and in the log, as the JAX engine does."""
    d = tmp_path / "rounds"
    _port_options_engine(jax_init, round_save_dir=str(d)).run_rounds(stage=1, num_rounds=1)
    assert sorted(p.name for p in d.iterdir()) == [
        "stage1-round-1", "stage1-round-1-server", "stage1-round-1-topk"]
    straight = _port_options_engine(jax_init).run_rounds(stage=1, num_rounds=2)
    shutil.copytree(d, tmp_path / "bare")
    resumed = _port_options_engine(jax_init, round_save_dir=str(d))
    got = resumed.run_rounds(stage=1, num_rounds=2)
    assert [r["fl_round"] for r in resumed.logger.history if "phase" in r] == [2]
    for k, v in straight.items():
        assert torch.equal(got[k], v), k
    for sidecar, key in (("-server", "fl_resume_server_state_missing"),
                         ("-topk", "fl_resume_topk_residuals_missing")):
        bare = tmp_path / f"bare{sidecar}"
        shutil.copytree(tmp_path / "bare", bare)
        shutil.rmtree(bare / f"stage1-round-1{sidecar}")
        eng = _port_options_engine(jax_init, round_save_dir=str(bare))
        eng._maybe_resume_rounds(1)
        assert f"no '{sidecar}' sibling" in capsys.readouterr().out
        assert {key: 1.0, "stage": 1} in eng.logger.history


def test_secagg_and_compressed_rounds_close_to_fedavg_and_deterministic(monkeypatch):
    """The port-side rule of the JAX package's
    ``test_engine_secagg_round_close_to_vanilla_and_deterministic``: a
    secure-aggregation round (stage 1 here, clip 100, 24 bits) equals itself run
    again bit for bit and the plain FedAvg round within two grid steps
    (atol 2 * 100 / (2^23 - 1), rtol 2e-5); an 8-bit nearest compressed
    round is within half of the clients' largest grid step of it."""
    from privacy_preserve_federated_asr_tpu_torch.models import init_dacs_state_dict

    cfg = _cfg(1)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(3))
    eng = FederatedEngine(cfg, _fcfg(), _clients(), [], None, TOK, sd, device="cpu")

    def run(**kw):
        # one engine: its encoder cache serves every round
        eng.fcfg, eng.global_params = _fcfg(**kw), dict(sd)
        return eng.run_rounds(stage=1, num_rounds=1)

    vanilla = run()
    sa, sa2 = run(secagg_clip_norm=100.0, secagg_bits=24), run(secagg_clip_norm=100.0,
                                                               secagg_bits=24)
    step = 100.0 / (2 ** 23 - 1)
    for k, v in vanilla.items():
        assert torch.equal(sa[k], sa2[k]), k
        torch.testing.assert_close(sa[k], v, atol=2 * step, rtol=2e-5, msg=k)
    amax: dict = {}
    term = fed.CompressedDeltaAccumulator._term

    def recording(self, ki, deltas, client_params):
        for k, d in deltas.items():
            amax[k] = max(amax.get(k, 0.0), d.abs().max().item())
        return term(self, ki, deltas, client_params)

    monkeypatch.setattr(fed.CompressedDeltaAccumulator, "_term", recording)
    comp = run(compress_bits=8, compress_stochastic_rounding=False)
    assert set(amax) == {"dementia_head.weight", "dementia_head.bias"}
    for k, v in vanilla.items():
        bound = amax[k] / 127 / 2 + 1e-7 if k in amax else 0.0
        assert (comp[k] - v).abs().max().item() <= bound, k
    assert not torch.equal(comp["dementia_head.weight"], vanilla["dementia_head.weight"])


def _uniform(n, seed):
    """``n`` utterances of 0.2 s (one time bucket: the staged round and the
    standalone update pad them alike)."""
    return [dataclasses.replace(e, array=e.array[:3200], input_values=e.input_values[:3200])
            for e in _examples(n, seed)]


def test_nbest_round_keeps_structure_and_matches_local_update():
    """The port-side rule of the JAX package's
    ``test_engine_multitask_matches_standalone_local_update``: with one
    client and ``supervised_level`` 0 a stage-0 N-best round equals
    ``multitask_local_update`` with the engine's seeds (rtol 2e-5, atol
    2e-6, as JAX's test; the key biases are exempt, as in
    ``_assert_params_match``: their exact gradient is 0, so Adam turns
    rounding noise into steps of up to lr) and keeps the single-head keys
    (``test_engine_multitask_round_smoke``; the structure with a supervised
    phase as well is ``test_cli_federated_nbest_semi_supervised``'s)."""
    from privacy_preserve_federated_asr_tpu_torch.models import init_dacs_state_dict

    sd = init_dacs_state_dict(_cfg(), torch.Generator().manual_seed(7))
    cfg, seed, data = _cfg(0, num_lms=2), 3, _uniform(4, 11)
    one = FederatedEngine(cfg, _fcfg(num_clients=1, seed=seed, supervised_level=0.0),
                          {0: _uniform(2, 1)}, [], None, TOK, sd, device="cpu",
                          client_unsup_examples={0: data})
    got = one.run_rounds(stage=0, num_rounds=1)
    assert got.keys() == sd.keys()
    assert [r["phase"] for r in one.logger.history if "phase" in r] == ["mt"]
    assert not torch.equal(got["lm_head.weight"], sd["lm_head.weight"])
    want, losses = mt.multitask_local_update(
        cfg, sd, data, TOK, batch_size=2, time_multiple=3200, learning_rate=LR,
        warmup_steps=1, seed=seed, rng_seed=one._client_seed(0, 0, 0))
    assert losses
    for k, v in got.items():
        assert torch.isfinite(v).all(), k
        if not k.endswith("attention.k_proj.bias"):
            torch.testing.assert_close(v, want[k], rtol=2e-5, atol=2e-6, msg=k)


def test_cli_federated_nbest_semi_supervised(tmp_path, monkeypatch, capsys):
    """``cli federated -fl_st 1 --num_lms 2 -sl 0.5 --unsup_train_csv`` with
    FedProx, FedAdam and top-k: the stage-0 round runs the N-best phase
    then the supervised one, moves only the ASR network (the frozen
    frontend and the heads bit-equal), and writes its sidecars."""
    monkeypatch.chdir(tmp_path)
    _write_corpus(tmp_path / "data", n_train=2, n_test=1)
    (tmp_path / "data/unsup.csv").write_text(
        (tmp_path / "data/train.csv").read_text())
    eng = cli.main([*CLI, "-fl_st", "1", "--num_lms", "2", "-sl", "0.5",
                    "--unsup_train_csv", "data/unsup.csv", "--fedprox_mu", "0.01",
                    "--server_optimizer", "adam", "--topk_fraction", "0.25",
                    "--round_save_dir", "rounds"])
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(ev["eval_loss"])
    assert [r["phase"] for r in eng.logger.history if "phase" in r] == ["mt+res"]
    assert sorted(p.name for p in (tmp_path / "rounds").iterdir()) == [
        "stage0-round-1", "stage0-round-1-server", "stage0-round-1-topk"]
    init = cli.load_weights(_cfg(), None)
    final = cli.load_weights(_cfg(), "out/m_FLASR_global/final")
    moved = {k for k in init if not torch.equal(init[k], final[k])}
    assert "lm_head.weight" in moved and all(
        k.startswith(("backbone.", "lm_head.")) and "feature_extractor" not in k
        for k in moved)


def test_options_validated_as_jax():
    """The aggregation modes exclude each other and their ranges are
    checked, as JAX's ``FederatedConfig.__post_init__`` does."""
    for kw, match in ((dict(compress_bits=8, dp_clip_norm=1.0), "mutually exclusive"),
                      (dict(topk_fraction=0.1, secagg_clip_norm=1.0), "mutually exclusive"),
                      (dict(compress_bits=9), r"\[2, 8\]"),
                      (dict(secagg_clip_norm=1.0, secagg_bits=30), r"\[2, 24\]"),
                      (dict(secagg_clip_norm=1.0, fedavg_weighted=True), "unweighted"),
                      (dict(topk_fraction=0.0), r"\(0, 1\]")):
        with pytest.raises(ValueError, match=match):
            FederatedConfig(**kw)
