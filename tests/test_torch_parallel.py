"""The port's parallel layer (privacy_preserve_federated_asr_tpu_torch/parallel/)
on the CPU: ranks over gloo, one torch thread each.

One pool of 4 ranks (``RankPool``) serves the module; a 2-rank call runs on
its first two ranks in a process group of their own. The ranks' entry point
imports only the port, so the functions they run (the ``_task_*`` below, and
the helpers of test_torch_federated.py) import nothing of JAX.

Each Trainer layout and each federated mesh runs at dropout 0 from the
weights and data of a JAX single-device run and is held to it (the JAX
Trainer's two steps here, the JAX engine round of test_torch_federated.py,
shared in one process), and to the port's single-device run at the tighter
tolerances below. The draws of noise (SpecAugment spans, attention keep
masks, Gumbel masks) are held to one device's at dropout 0.1 with
SpecAugment on, port against port: JAX draws from other generators. The
GPipe forward is also held directly to JAX's ``make_pp_forward``, and the
pure layout functions (meshes, partition specs, validations) to JAX's on
the same inputs.

Tolerances: against JAX, those of test_torch_train_extras.py (losses and
grad norms 1e-4 relative, the params by ``_assert_params_match``'s rule).
Against the port's one device, a layout sums the same fp32 terms in another
order (rows split over ranks and all-reduced, tensor-parallel partial
products, the flat gradient buffer), so losses agree to 1e-6 relative,
global gradient norms to 2e-4 (CTC's log-space recursion over ~300 frames
amplifies the reordering in gradients of ~1e3), and the params after AdamW
steps (which divide by the square root of tiny second moments) to 2e-4
absolute; everything that does not add across ranks (extraction rows, the
gathered noise, state-dict round trips) is equal.
"""

import dataclasses
import functools
import multiprocessing
import pickle
import sys
import wave

import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu_torch.data import (
    AsrExample,
    CTCCharTokenizer,
    prepare_examples,
)
from privacy_preserve_federated_asr_tpu_torch.federated import FederatedEngine
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    DACSModel,
    flax_from_state_dict,
    init_dacs_state_dict,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.ops import attention as patt
from privacy_preserve_federated_asr_tpu_torch.parallel import dist as pdist
from privacy_preserve_federated_asr_tpu_torch.parallel import mesh as pmesh
from privacy_preserve_federated_asr_tpu_torch.parallel import pp as ppp
from privacy_preserve_federated_asr_tpu_torch.parallel import tp as ptp
from privacy_preserve_federated_asr_tpu_torch.parallel import zero as pzero
from privacy_preserve_federated_asr_tpu_torch.parallel.layout import Layout
from privacy_preserve_federated_asr_tpu_torch.train import Trainer, TrainerConfig
from test_torch_federated import (
    ROUND,
    TOK,
    _assert_params_match,
    _clients,
    _fcfg,
    _jax_init,
    _jax_round,
)
from test_torch_federated import _cfg as _zero_dropout_cfg
from test_torch_federated import _examples as _fed_examples
from test_torch_train_extras import (
    N_TRAIN,
    TCFG,
    _uniform,
    flax_from_port_layout,
    jax_trainer_run,
)

SENTENCES = ["THE BOY IS ON A STOOL", "THE JAR IS OPEN", "SHE DRIES DISHES",
             "WATER IS ON THE FLOOR"]
PARAM_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def pools():
    """The module's 4 ranks, started at its first test (they start and warm
    up while the tests ahead of their first call run); each call has its own
    timeout."""
    pool = pdist.RankPool(4, timeout=180, preload=(__name__,))
    yield pool
    pool.close()


# ---------------------------------------------------------------------------
# what the ranks run (port only)
# ---------------------------------------------------------------------------

def _examples(n, seed=0):
    rng = np.random.default_rng(seed)
    exs = []
    for i in range(n):
        wav = rng.normal(0, 0.1, int(rng.integers(2400, 4000))).astype(np.float32)
        exs.append(AsrExample(path=f"S{i % 3:03d}_PAR_{i}.wav", array=wav,
                              text=SENTENCES[i % len(SENTENCES)], dementia_label=i % 2))
    return prepare_examples(exs, CTCCharTokenizer())


def _cfg(stage=0, **bb):
    """Tiny DACS with hidden dropouts 0 and SpecAugment and attention dropout
    on: the configuration of the noise checks (every layout draws the whole
    batch's noise)."""
    base = dict(hidden_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0,
                attention_dropout=0.1, mask_time_prob=0.3, mask_time_length=2)
    return DACSConfig(backbone=BackboneConfig.tiny_for_tests(**{**base, **bb}), stage=stage)


def _task_train(sd, save_dir=None, **layout):
    """test_torch_train_extras.py's Trainer run (stage 0 at dropout 0 from
    the JAX init; ``scan_layers``, ``remat``, ``grad_accum`` 2, ``prefetch``
    2; 4 micro-batches of 4, the last padded with a weight-0 row, on the
    second data rank) under ``layout``, with an evaluation: the losses, grad
    norms, evaluation and final params."""
    if save_dir is not None:  # record_result's TensorBoard sink imports TensorFlow
        sys.modules["torch.utils.tensorboard"] = None
    t = TrainerConfig(**TCFG, save_steps=3, save_dir=save_dir, **layout)
    tr = Trainer(_zero_dropout_cfg(), sd, _uniform(N_TRAIN, 2), _uniform(4, 3), TOK, t,
                 device="cpu")
    tr.train()
    rows = [r for r in tr.logger.history if "loss" in r]
    return {"loss": [r["loss"] for r in rows], "grad_norm": [r["grad_norm"] for r in rows],
            "eval": tr.evaluate(), "params": tr.full_state_dict(), "step": tr.state.step}


def _jax_sd():
    return state_dict_from_flax(_jax_init()[1], _zero_dropout_cfg())


@functools.lru_cache(maxsize=None)
def _one_device_train():
    return _task_train(_jax_sd())


def _task_noise(stage=2, **layout):
    """One train-mode forward of a 4-row batch (one padding row) with
    SpecAugment and attention dropout on, under ``layout`` (``data``,
    ``model``, ``pipe`` or ``seq`` ranks over the process group; none: one
    device): the hidden states and Gumbel masks every layout draws."""
    cfg = _cfg(stage)
    model = DACSModel(cfg)
    model.load_state_dict(init_dacs_state_dict(cfg, torch.Generator().manual_seed(0)))
    model.backbone.encoder.scan_layers = True
    if layout:
        mesh = pmesh.Mesh(np.arange(int(np.prod(list(layout.values())))).reshape(
            *layout.values()), tuple(layout)).bind()
        Layout(mesh, cfg, num_microbatches=2).attach(model)
    model.train()
    torch.manual_seed(3)
    x = torch.randn(4, 3200, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out = model(x, torch.tensor([3200, 3000, 2800, 0]),
                    generator=torch.Generator().manual_seed(4),
                    seed_generator=torch.Generator().manual_seed(5))
    return out.hidden_states, out.lm_mask, out.ad_mask


def _task_noisy_train(stage=0, **layout):
    """A one-step Trainer run at the noisy configuration (3 utterances at
    batch 4: one padding row on the second data rank)."""
    cfg = _cfg(stage)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    t = TrainerConfig(num_epochs=1, batch_size=4, eval_batch_size=4, logging_steps=1,
                      learning_rate=1e-3, time_multiple=1600, log_dir="/tmp", prefetch=0,
                      cache_encoder=False, **layout)
    tr = Trainer(cfg, sd, _examples(3), None, CTCCharTokenizer(), t, device="cpu")
    tr.train()
    return [r["lm_mask_on_rate"] for r in tr.logger.history if "loss" in r]


def _task_extract(argv):
    from privacy_preserve_federated_asr_tpu_torch import cli

    cli.main(argv)


def _task_federated(mesh_shape, zero1=False, num_clients=2, compress=False):
    """One stage-0 round (staged client data) of the noisy configuration on
    a ``make_mesh(**mesh_shape)`` mesh, or on one device for
    ``mesh_shape=None``: the new global params and the round's log row."""
    from privacy_preserve_federated_asr_tpu_torch.federated import FederatedConfig

    cfg = _cfg(0)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    mesh = None if mesh_shape is None else pmesh.make_mesh(**mesh_shape)
    exs = _examples(8)
    clients = {c: exs[c::num_clients] for c in range(num_clients)}
    f = FederatedConfig(num_rounds=1, num_clients=num_clients, local_ep=1, global_ep=0,
                        batch_size=2, time_multiple=1600, learning_rate=1e-3, seed=0,
                        mesh=mesh, zero1=zero1, resident_client_data=False,
                        compress_bits=4 if compress else None, log_dir="/tmp")
    eng = FederatedEngine(cfg, f, clients, exs, None, CTCCharTokenizer(), sd, device="cpu")
    eng.run_rounds(stage=0)
    row = next(r for r in eng.logger.history if "fl_round" in r)
    return eng.global_params, {k: v for k, v in row.items() if k != "round_s"}


def _task_jax_round(sd, mesh_shape, zero1=False):
    """test_torch_federated.py's stage-0 engine round (held to JAX there) on
    a ``make_mesh(**mesh_shape)`` mesh: the new global params and the log
    rows."""
    mesh = pmesh.make_mesh(**mesh_shape)
    f = _fcfg(**ROUND, mesh=mesh, zero1=zero1, tp=mesh.axis_size("model") > 1)
    eng = FederatedEngine(_zero_dropout_cfg(0), f, _clients(), _fed_examples(4, 3), None,
                          TOK, sd, device="cpu")
    got = eng.run_rounds(stage=0, num_rounds=1)
    return got, [r for r in eng.logger.history if "fl_round" in r]


def _task_finetune(fields, tcfg, texts, y, extra):
    """``FinetuneTextTrainer.loss_and_grads`` at dp = the world size."""
    from privacy_preserve_federated_asr_tpu_torch.text import bert as pbert
    from privacy_preserve_federated_asr_tpu_torch.text import finetune as pft

    cfg = pft.FinetuneConfig(**{**fields, "bert": pbert.BertConfigT(**fields["bert"])})
    tr = pft.FinetuneTextTrainer(cfg, pbert.WordPieceTokenizer(tcfg.pop("vocab")),
                                 pft.FinetuneTrainerConfig(**tcfg, dp=pdist.world_size()),
                                 device="cpu")
    tr.init_params()
    return tr.loss_and_grads(texts, y, extra)


def _task_pp_forward(params):
    """The port's 2-stage pipeline forward of a 2-layer tiny model in eval
    mode on a 4-row batch (2 microbatches)."""
    cfg = _cfg(2, attention_dropout=0.0, mask_time_prob=0.0)
    model = DACSModel(cfg)
    model.load_state_dict(params)
    model.backbone.encoder.scan_layers = True
    mesh = pmesh.Mesh(np.arange(2), ("pipe",)).bind()
    ppp.make_pp_forward(model, mesh, num_microbatches=2)
    model.eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 3200)).astype(np.float32))
    with torch.no_grad():
        return model(x, generator=torch.Generator().manual_seed(0)).hidden_states


# ---------------------------------------------------------------------------
# the kernels' plain versions with offsets, state-dict shards, layouts vs JAX
# ---------------------------------------------------------------------------

def test_attention_ref_offsets_equal_square_call():
    """``attention_ref`` / ``attention_bwd_ref`` on a block of query rows
    (``Tq != Tk``, ``q_offset``), of batch rows (``b_offset``) and of heads
    (``h_offset``, ``h_total``) give the full square call's rows with its
    dropout masks; the blocks' dK, dV sum to the full ones (fp32 sums in
    another order: 1e-6)."""
    rng = np.random.default_rng(0)
    b, t, h, d = 3, 40, 4, 16
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
                   for _ in range(4))
    mask = torch.ones((b, t), dtype=torch.int32)
    mask[1, 30:] = 0
    rate, seed, th = 0.2, 11, 128
    full = patt.attention_ref(q, k, v, mask, rate, seed, th)
    dq, dk, dv = patt.attention_bwd_ref(q, k, v, mask, full, do, rate, seed, th)
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for lo, hi in ((0, 17), (17, 40)):  # query blocks (sequence parallelism)
        o = patt.attention_ref(q[:, lo:hi], k, v, mask, rate, seed, th, q_offset=lo)
        torch.testing.assert_close(o, full[:, lo:hi], rtol=0, atol=0)
        g = patt.attention_bwd_ref(q[:, lo:hi], k, v, mask, o, do[:, lo:hi], rate, seed, th,
                                   q_offset=lo)
        torch.testing.assert_close(g[0], dq[:, lo:hi], rtol=0, atol=0)
        dk_sum += g[1]
        dv_sum += g[2]
    torch.testing.assert_close(dk_sum, dk, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dv_sum, dv, rtol=1e-6, atol=1e-6)
    o = patt.attention_ref(q[1:], k[1:], v[1:], mask[1:], rate, seed, th, b_offset=1)
    torch.testing.assert_close(o, full[1:], rtol=0, atol=0)  # data parallelism
    o = patt.attention_ref(q[:, :, 2:], k[:, :, 2:], v[:, :, 2:], mask, rate, seed, th,
                           h_offset=2, h_total=4)
    torch.testing.assert_close(o, full[:, :, 2:], rtol=0, atol=0)  # tensor parallelism
    g = patt.attention_bwd_ref(q[:, :, 2:], k[:, :, 2:], v[:, :, 2:], mask, o, do[:, :, 2:],
                               rate, seed, th, h_offset=2, h_total=4)
    for got, want in zip(g, (dq, dk, dv)):
        torch.testing.assert_close(got, want[:, :, 2:], rtol=0, atol=0)


def test_tp_and_pp_state_dict_round_trip():
    cfg = _cfg(2)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    for n in (2, 4):
        shards = [ptp.tp_split_state_dict(sd, i, n) for i in range(n)]
        assert shards[1]["backbone.encoder.layers.0.attention.q_proj.weight"].shape == (
            32 // n, 32)
        assert shards[1]["backbone.encoder.layers.0.feed_forward.output_dense.weight"].shape \
            == (32, 64 // n)
        back = ptp.tp_gather_state_dict(shards)
        assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
    shards = [ppp.pp_split_state_dict(sd, s, 2, 2) for s in range(2)]
    assert not any(k.startswith("backbone.encoder.layers.1.") for k in shards[0])
    back = ppp.pp_gather_state_dict(shards)
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())


def test_layout_functions_match_jax():
    """Meshes (grids and errors), the tensor-parallel spec of every
    parameter of a tiny model (torch's [out, in] against flax's [in, out]),
    ZeRO-1 specs and the validations' messages, on the same inputs as JAX's."""
    import jax

    from privacy_preserve_federated_asr_tpu.models.config import (
        BackboneConfig as JaxBackboneConfig,
    )
    from privacy_preserve_federated_asr_tpu.parallel import mesh as jmesh
    from privacy_preserve_federated_asr_tpu.parallel import pp as jpp
    from privacy_preserve_federated_asr_tpu.parallel import tp as jtp
    from privacy_preserve_federated_asr_tpu.parallel import zero as jzero

    devs = jax.devices()
    ids = list(range(len(devs)))

    def same(jfn, pfn, *a, **kw):
        try:
            want = jfn(*a, devices=devs, **kw)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
                pfn(*a, devices=ids, **kw)
            return
        got = pfn(*a, devices=ids, **kw)
        assert got.axis_names == want.axis_names
        np.testing.assert_array_equal(got.devices, np.vectorize(lambda x: x.id)(want.devices))

    for kw in (dict(client=2, data=2), dict(client=2), dict(client=2, data=2, model=2),
               dict(client=4, data=4), dict(client=3, data=2, model=2)):
        same(jmesh.make_mesh, pmesh.make_mesh, **kw)
    for kw in (dict(client=2, data=2, num_slices=2), dict(client=4, data=2, num_slices=2),
               dict(client=3, data=1, num_slices=2), dict(client=2, data=5, num_slices=2),
               dict(client=2, data=1, num_slices=3)):
        same(jmesh.make_multislice_mesh, pmesh.make_multislice_mesh, **kw)

    sd = init_dacs_state_dict(_cfg(2), torch.Generator().manual_seed(0))
    flat = {}

    def walk(tree, path=()):
        for name, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, path + (name,))
            else:
                flat[path + (name,)] = sub

    walk(flax_from_state_dict(sd))
    checked = 0
    for name, v in sd.items():
        parts = name.split(".")
        fpath = []  # layers.N -> layers_N, conv_layers.N -> conv_layers_N in flax
        for p in parts[:-1]:
            if p.isdigit():
                fpath[-1] = f"{fpath[-1]}_{p}"
            else:
                fpath.append(p)
        leaf = {"weight": ("kernel", "scale"), "bias": ("bias",)}.get(parts[-1], (parts[-1],))
        fk = next((tuple(fpath) + (lf,) for lf in leaf if tuple(fpath) + (lf,) in flat), None)
        if fk is None:
            continue
        want = tuple(jtp.tp_partition_spec(fk, np.ndim(flat[fk])))
        got = ptp.tp_partition_spec(parts, v.dim())
        assert got == (tuple(reversed(want)) if v.dim() == 2 else want), name
        checked += 1
    assert checked > 30
    for shape in ((1024, 4096), (5, 8), (3, 7), (), (12,), (2, 6, 4)):
        for n in (2, 4):
            assert pzero.zero1_partition_spec(shape, n) == tuple(
                jzero.zero1_partition_spec(shape, n))
    for mod_p, mod_j, a in ((ptp, jtp, 3), (ptp, jtp, 2)):
        bb, jbb = BackboneConfig.tiny_for_tests(), JaxBackboneConfig.tiny_for_tests()
        try:
            mod_j.validate_tp_divisibility(jbb, a)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                mod_p.validate_tp_divisibility(bb, a)
    for args in ((2, 8, 2), (3, 8, 2), (2, 8, 1), (2, 7, 2)):
        try:
            jpp.validate_pp(JaxBackboneConfig.tiny_for_tests(), *args)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
                ppp.validate_pp(BackboneConfig.tiny_for_tests(), *args)
        else:
            ppp.validate_pp(BackboneConfig.tiny_for_tests(), *args)


# ---------------------------------------------------------------------------
# the trainer's layouts against JAX and one device (2 ranks)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _one_device(fn, *args, **kw):
    """A task's single-device run in this process, once per module."""
    return fn(*args, **kw)


def _assert_matches_jax(got):
    """Against the JAX Trainer's run: the losses 1e-4 relative and the
    params by ``_assert_params_match``'s rule, as test_torch_train_extras.py
    holds them; the grad norms 1e-4 before the first update and 1e-3 after
    it (Adam's first update moves every element by about lr, those whose
    gradient is at rounding level in either direction: the next gradients
    differ by more than the first)."""
    _, params, rows = jax_trainer_run()
    np.testing.assert_allclose(got["loss"], [r["loss"] for r in rows], rtol=1e-4)
    want = [r["grad_norm"] for r in rows]
    np.testing.assert_allclose(got["grad_norm"][:2], want[:2], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"][2:], want[2:], rtol=1e-3)
    _assert_params_match(got["params"], flax_from_port_layout(params), ("backbone", "lm_head"))


def _assert_same_run(got, want):
    """Against the port's one device at the tolerances of the module
    docstring; the evaluation reads the final params, which differ by up to
    PARAM_ATOL after two AdamW updates: 1e-5 relative."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-4)
    for k in ("eval_loss", "eval_wer", "eval_ad_acc"):
        assert got["eval"][k] == pytest.approx(want["eval"][k], rel=1e-5), k
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        torch.testing.assert_close(got["params"][k], v, rtol=0, atol=PARAM_ATOL, msg=k)


def _assert_layout_run(got):
    _assert_matches_jax(got[0])
    _assert_same_run(got[0], _one_device_train())
    for other in got[1:]:  # every rank holds the same whole model
        for k, v in got[0]["params"].items():
            torch.testing.assert_close(other["params"][k], v, rtol=0, atol=0, msg=k)


def test_one_device_trainer_matches_jax():
    """The reference of the layouts: the port's single-device run of
    ``_task_train`` against the JAX Trainer's, grad norms included."""
    _assert_matches_jax(_one_device_train())


def test_pp_forward_matches_jax_make_pp_forward(pools):
    """The port's 2-rank GPipe stack against JAX's ``make_pp_forward`` at
    pp=2 on 2 of the forced CPU devices, 2 tiny layers, 2 microbatches, the
    same weights: the encoder outputs within fp32 tolerance."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from privacy_preserve_federated_asr_tpu.models import DACSConfig as JaxDACSConfig
    from privacy_preserve_federated_asr_tpu.models import DACSModel as JaxDACSModel
    from privacy_preserve_federated_asr_tpu.models.config import (
        BackboneConfig as JaxBackboneConfig,
    )
    from privacy_preserve_federated_asr_tpu.parallel.pp import make_pp_stack
    from privacy_preserve_federated_asr_tpu.parallel.stacked import make_composed_forward

    cfg = _cfg(2, attention_dropout=0.0, mask_time_prob=0.0)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    jcfg = JaxDACSConfig(backbone=JaxBackboneConfig.tiny_for_tests(
        **{f.name: getattr(cfg.backbone, f.name) for f in dataclasses.fields(cfg.backbone)
           if f.name in ("hidden_dropout", "activation_dropout", "feat_proj_dropout",
                         "attention_dropout", "mask_time_prob", "mask_time_length")}),
        stage=2)
    params = jax.tree.map(jnp.asarray, flax_from_state_dict(sd, scan_layers=True))
    model = JaxDACSModel(jcfg, scan_layers=True)
    mesh = Mesh(np.array(jax.devices()[:2]), ("pipe",))
    stack = make_pp_stack(jcfg.backbone, jnp.float32, mesh, num_microbatches=2)
    x = np.random.default_rng(0).normal(size=(4, 3200)).astype(np.float32)
    fwd = make_composed_forward(model, stack)
    want = jax.jit(lambda p, v: fwd(p, v, rngs={"gumbel": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(x)).hidden_states
    got = pools.run_on(2, _task_pp_forward, sd)[0]  # (the ranks start meanwhile)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", [dict(dp=2), dict(dp=2, zero1=True), dict(tp=2),
                                    dict(pp=2), dict(sp=2)])
def test_two_rank_layouts_equal_one_device(pools, layout):
    """``_task_train`` (2 updates of 2 micro-batches, the last padded with a
    weight-0 row on the second data rank): every 2-rank layout takes the
    JAX Trainer's steps (losses, grad norms, params) and one device's (the
    same at the tighter tolerances, and the evaluation)."""
    _assert_layout_run(pools.run_on(2, _task_train, _jax_sd(), **layout))


def test_dp_draws_one_devices_noise(pools):
    """dp=2 draws the SpecAugment spans, attention keep masks and Gumbel
    noise one device draws for the same 4 rows (the Gumbel heads run on the
    gathered batch), and a stage-2 train run's mask rates equal one
    device's."""
    for got, w in zip(pools.run_on(2, _task_noise, data=2)[0], _one_device(_task_noise)):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pools.run_on(2, _task_noisy_train, stage=2, dp=2)[0],
                               _one_device(_task_noisy_train, stage=2), rtol=1e-6)


@pytest.mark.parametrize("axis", ["model", "pipe", "seq"])
def test_layouts_draw_one_devices_noise(pools, axis):
    """tp, pp and sp at 2 ranks draw the SpecAugment spans, attention keep
    masks (the kernel told the block's heads, rows or query frames) and
    Gumbel masks one device draws: the train-mode forward of
    ``test_dp_draws_one_devices_noise``."""
    for got, w in zip(pools.run_on(2, _task_noise, **{axis: 2})[0], _one_device(_task_noise)):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5)


def test_zero1_checkpoint_resumes_at_dp1(pools, tmp_path):
    """A ZeRO-1 run (dp=2) writes vanilla checkpoints: the one after
    micro-step 3 (mid-accumulation) holds the whole AdamW moments and the
    whole partial gradient sum (ZeRO-1 gathers its shards); one device
    resumes from it with that state, and its last micro-step ends at one
    device's params."""
    from privacy_preserve_federated_asr_tpu_torch.models.recipes import get_recipe
    from privacy_preserve_federated_asr_tpu_torch.train.optim import path_of

    sd = _jax_sd()
    got = pools.run_on(2, _task_train, sd, save_dir=str(tmp_path / "m"), dp=2, zero1=True)[0]
    assert got["step"] == 4
    ck = torch.load(tmp_path / "m/checkpoint-3/state.pt", weights_only=True)
    trainable = [v for k, v in ck["model"].items() if get_recipe("dacs").trainable(0)(
        path_of(k))]
    moments = list(ck["optimizer"]["adamw"]["state"].values())
    assert sorted(tuple(m["exp_avg"].shape) for m in moments) == sorted(
        tuple(v.shape) for v in trainable)
    assert [tuple(a.shape) for a in ck["optimizer"]["accum"]["acc"]] == [
        tuple(v.shape) for v in trainable]
    tr = Trainer(_zero_dropout_cfg(), sd, _uniform(N_TRAIN, 2), None, TOK,
                 TrainerConfig(**TCFG, resume_from=str(tmp_path / "m/checkpoint-3")),
                 device="cpu")
    assert tr.state.step == 3 and tr.state.tx.mini_step == 1
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(v, ck["model"][k]), k
    for i, st in tr.state.tx.state_dict()["adamw"]["state"].items():
        want = ck["optimizer"]["adamw"]["state"][i]
        assert torch.equal(st["exp_avg"], want["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], want["exp_avg_sq"])
    for i, (_, (fn, args)) in enumerate(tr.train_batches(0)):
        if i == 3:  # the epoch's last micro-batch completes update 2
            fn(tr.state, *args)
    for k, v in _one_device_train()["params"].items():
        torch.testing.assert_close(tr.state.model.state_dict()[k], v, rtol=0,
                                   atol=PARAM_ATOL, msg=k)


def test_finetune_dp2_step_equals_dp1(pools):
    """``FinetuneTextTrainer(dp=2)``: the two ranks' rows through the model,
    the logits gathered and the gradients summed give one device's loss and
    gradients (fp32 sums of the halves' terms in another order: 1e-6)."""
    from privacy_preserve_federated_asr_tpu_torch.text import bert as pbert
    from privacy_preserve_federated_asr_tpu_torch.text import finetune as pft

    words = ["the", "boy", "is", "on", "a", "stool", "jar", "open", "water"]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + words
    bert = pbert.BertConfigT(vocab_size=len(vocab), hidden_size=16, num_hidden_layers=1,
                             num_attention_heads=2, intermediate_size=32,
                             max_position_embeddings=16, hidden_dropout=0.0,
                             attention_dropout=0.0)
    cfg = pft.FinetuneConfig(bert=bert, num_text_inputs=2, extra_dim=3,
                             fusion="cross_attention", align_dim=8)
    texts = [[" ".join(words[i:i + 4]) for i in range(4)],
             [" ".join(words[i + 1:i + 6]) for i in range(4)]]
    y = np.array([0, 1, 1, 0])
    extra = np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)
    tcfg = dict(max_length=12, seed=1)
    one = pft.FinetuneTextTrainer(cfg, pbert.WordPieceTokenizer(vocab),
                                  pft.FinetuneTrainerConfig(**tcfg), device="cpu")
    one.init_params()
    want_loss, want = one.loss_and_grads(texts, y, extra)
    for loss, grads in pools.run_on(2, _task_finetune, dataclasses.asdict(cfg),
                                    {**tcfg, "vocab": vocab}, texts, y, extra):
        assert loss == pytest.approx(want_loss, rel=1e-6)
        for k, g in want.items():
            np.testing.assert_allclose(grads[k], g, rtol=1e-6, atol=1e-6, err_msg=k)


def _assert_jax_round(got):
    """A mesh's round against the JAX engine's single-device round, by the
    rule of test_torch_federated.py::test_round_matches_jax_engine."""
    from privacy_preserve_federated_asr_tpu.federated.engine import STAGE_NETWORK
    from privacy_preserve_federated_asr_tpu.parallel.fed import NETWORKS

    params, rows = got
    want, jrows = _jax_round(0)
    assert rows[0]["dead_step_frac"] == jrows[0]["dead_step_frac"] == 0.25
    assert rows[0]["local_steps"] == 4
    for c in (0, 1):
        np.testing.assert_allclose(rows[0][f"client{c}_loss"], jrows[0][f"client{c}_loss"],
                                   rtol=1e-4, err_msg=f"client {c}")
    _assert_params_match(params, want, NETWORKS[STAGE_NETWORK[0]])


def _assert_round(got, want):
    g, row = got
    wg, wrow = want
    for k, v in wg.items():
        torch.testing.assert_close(g[k], v, rtol=0, atol=PARAM_ATOL, msg=k)
    for k, v in wrow.items():
        if k.endswith("_loss"):
            assert row[k] == pytest.approx(v, rel=1e-6), k
        else:
            assert row[k] == v, k


def test_federated_client_mesh_round(pools):
    """``client=2``: each rank trains one client and the FedAvg sum is
    all-reduced; ``model=2``: each client's encoder matmuls
    tensor-parallel. Both take the JAX engine's round. 3 clients over 2
    ranks (noisy configuration, port against one device) split 2 + 1, log
    JAX's ``gspmd_client_pad_frac`` (1 - 3/4) and draw one device's
    stochastic rounding of the compressed deltas."""
    sd = _jax_sd()
    _assert_jax_round(pools.run_on(2, _task_jax_round, sd, dict(client=2, data=1))[0])
    _assert_jax_round(pools.run_on(2, _task_jax_round, sd, dict(client=1, data=1, model=2))[0])
    got = pools.run_on(2, _task_federated, dict(client=2, data=1), num_clients=3,
                       compress=True)[0]
    assert got[1].pop("gspmd_client_pad_frac") == round(1.0 - 3 / 4, 4)
    _assert_round(got, _one_device(_task_federated, None, num_clients=3, compress=True))


def _write_corpus(root):
    rng = np.random.default_rng(0)
    (root / "clips").mkdir(parents=True)
    rows = {"train": [], "test": []}
    for i in range(10):
        name = f"S{i % 3:03d}_PAR_{i}_0_100.wav"
        with wave.open(str(root / "clips" / name), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.normal(0, 0.1, int(rng.integers(2400, 4000))) * 32767
                           ).astype("<i2").tobytes())
        rows["train" if i < 6 else "test"].append((name, SENTENCES[i % 4]))
    for split, rs in rows.items():
        (root / f"{split}.csv").write_text(
            "path,sentence\n" + "".join(f"{n},{s}\n" for n, s in rs))
    np.save(root / "spk2label.npy", {f"S{i:03d}": i % 2 for i in range(3)})


def test_extract_dp2_pickles_equal_dp1(pools, tmp_path):
    """``cli extract --dp 2`` (its batches over the data ranks, the rows
    back in input order) writes the pickles and Result.csv one device
    writes, byte for byte."""
    from privacy_preserve_federated_asr_tpu_torch import cli

    _write_corpus(tmp_path)
    base = ["extract", "--model_type", "tiny", "-st", "2", "--audio_dir",
            str(tmp_path / "clips"), "--train_csv", str(tmp_path / "train.csv"),
            "--test_csv", str(tmp_path / "test.csv"), "--spk2label",
            str(tmp_path / "spk2label.npy"), "--dataset_cache", str(tmp_path / "cache"),
            "--eval_batch_size", "2", "--device", "cpu"]
    cli.main(base + ["--csv_out_dir", str(tmp_path / "one")])
    pools.run_on(2, _task_extract, base + ["--csv_out_dir", str(tmp_path / "two"), "--dp", "2"])
    for name in ("extract.pkl", "extract_train.pkl", "Result.csv"):
        assert (tmp_path / "two" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()
    assert len(pickle.loads((tmp_path / "one/extract.pkl").read_bytes())["path"]) == 4


# ---------------------------------------------------------------------------
# 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", [dict(dp=2, tp=2), dict(dp=2, pp=2), dict(dp=2, sp=2)])
def test_four_rank_layouts_equal_one_device(pools, layout):
    _assert_layout_run(pools.run(_task_train, _jax_sd(), **layout))


def test_federated_client_data_zero1_round(pools):
    """``client=2 x data=2`` with ``--fl_zero1``: each client's batch rows
    over its data ranks (client 1's padded batch puts its 2 weight-0 rows on
    the second), moments sharded: the JAX engine's round."""
    _assert_jax_round(pools.run(_task_jax_round, _jax_sd(), dict(client=2, data=2),
                                zero1=True)[0])


if multiprocessing.parent_process() is not None:
    # imported by a rank of the module's pool as it starts, before it joins
    # the process group: its first Trainer run and train-mode forward (lazy
    # imports, first dispatches: ~2 s) happen here, while the main process
    # runs the tests ahead of the pool's first call
    _task_train(init_dacs_state_dict(_zero_dropout_cfg(), torch.Generator().manual_seed(0)))
    _task_noise()
