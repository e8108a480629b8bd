"""The rest of the port's Trainer against the JAX package's: ``grad_accum``
(summed micro-gradients, optax ``MultiSteps``), ``remat``, ``scan_layers``
and ``prefetch`` together against the JAX Trainer on the same weights and
data, a resume in the middle of an accumulation, and port-side rules: a
remat step equals a plain step, k micro-batches equal one batch of k x B
rows, and the prefetch thread re-raises its failures. Tiny shapes, fp32,
dropouts 0 where JAX is compared; every tolerance is stated at its
assert."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from privacy_preserve_federated_asr_tpu_torch.data.collate import LengthBucketBatcher
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    DACSModel,
    flax_from_state_dict,
    init_dacs_state_dict,
    state_dict_from_flax,
)
from privacy_preserve_federated_asr_tpu_torch.train import (
    DeviceBatch,
    Trainer,
    TrainerConfig,
    create_train_state,
    make_optimizer,
    make_train_step,
    prefetch_device_batches,
    prefetch_iter,
)
from test_torch_federated import (  # noqa: F401
    LR,
    TOK,
    _assert_params_match,
    _cfg,
    _examples,
    _jax_tok,
    _leaves,
    jax_init,
    one_torch_thread,
)


def _uniform(n, seed, **kw):
    """``n`` utterances of 0.2 s: one time bucket, so one compiled step."""
    return [dataclasses.replace(e, array=e.array[:3200], input_values=e.input_values[:3200])
            for e in _examples(n, seed, **kw)]


TCFG = dict(num_epochs=1, batch_size=2, learning_rate=LR, time_multiple=3200,
            logging_steps=1, log_dir=".", scan_layers=True, remat=True, grad_accum=2,
            prefetch=2, cache_frontend=False)


@pytest.fixture
def no_tensorboard(monkeypatch):
    """record_result's TensorBoard sink imports TensorFlow (~10 s) where it
    is installed: blocked, the sink returns None as without TensorBoard."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_trainer_matches_jax_scan_remat_accum_prefetch(jax_init, tmp_path, no_tensorboard):
    """Stage 0 from waveforms (the prefetched path), 4 micro-batches of 2 =
    2 AdamW updates, the JAX Trainer with ``scan_layers`` (its params
    stacked, read back through the bridge), ``remat``, ``grad_accum`` 2 and
    ``prefetch`` 2 against the port's with the same flags: the trainable
    params by ``_assert_params_match``'s rule (99.5% of elements within 1e-2
    lr), the frozen ones bit-equal; the micro-step losses rtol 1e-4. Then a
    resume from the checkpoint after micro-step 3 (mid-accumulation, the
    partial sum in it) ends bit-equal to the run that did not stop."""
    import jax
    from privacy_preserve_federated_asr_tpu.data.dataset import AsrExample as JEx
    from privacy_preserve_federated_asr_tpu.train.trainer import (
        Trainer as JTrainer,
        TrainerConfig as JTrainerConfig,
    )

    jcfg, params = jax_init
    jtr = JTrainer(jcfg, params, _uniform(8, 2, cls=JEx), None, _jax_tok(),
                   JTrainerConfig(**TCFG))
    jstate = jtr.train()
    assert int(jstate.step) == 4
    want = jax.device_get(jstate.params)
    assert "layers_scan" in want["backbone"]["encoder"]

    cfg = _cfg()
    tr = Trainer(cfg, state_dict_from_flax(params, cfg), _uniform(8, 2), None, TOK,
                 TrainerConfig(**TCFG, save_dir=str(tmp_path / "m"), save_steps=3),
                 device="cpu")
    assert tr.state.model.backbone.encoder.remat
    tr.train()
    assert tr.state.step == 4 and tr.state.tx.schedule.last_epoch == 2
    got = tr.state.model.state_dict()
    scan_got = flax_from_state_dict(got, scan_layers=True)
    assert sorted(p for p, _ in _leaves(scan_got)) == sorted(p for p, _ in _leaves(want))
    _assert_params_match(got, flax_from_port_layout(want), ("backbone", "lm_head"))
    jl = [r["loss"] for r in jtr.logger.history if "loss" in r]
    pl = [r["loss"] for r in tr.logger.history if "loss" in r]
    np.testing.assert_allclose(pl, jl, rtol=1e-4)

    resumed = Trainer(cfg, state_dict_from_flax(params, cfg), _uniform(8, 2), None, TOK,
                      TrainerConfig(**TCFG, resume_from=str(tmp_path / "m/checkpoint-3")),
                      device="cpu")
    assert resumed.state.step == 3 and resumed.state.tx.mini_step == 1
    assert resumed.state.tx.acc is not None
    for i, (_, (fn, args)) in enumerate(resumed.train_batches(0)):
        if i == 3:  # the epoch's last micro-batch completes update 2
            fn(resumed.state, *args)
    assert resumed.state.tx.schedule.last_epoch == 2
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, got[k]), k


def flax_from_port_layout(tree):
    """A JAX scan-layout params tree in the per-layer layout, through the
    port's bridge (``state_dict_from_flax`` reads the stacked layers)."""
    return flax_from_state_dict(state_dict_from_flax(tree, _cfg()))


def _batch(n, seed):
    """``n`` rows of 3200 samples with labels (one time and label bucket)."""
    exs = _uniform(n, seed)
    b = next(LengthBucketBatcher(exs, n, time_multiple=3200).epoch(0))
    return DeviceBatch.from_host(b, "cpu")


def _rows(db, sl):
    return DeviceBatch(*(getattr(db, f.name)[sl] for f in dataclasses.fields(db)))


def test_remat_step_equals_plain_step():
    """Two stage-0 steps with attention, hidden and activation dropout live
    (0.1), with and without ``remat``: the recompute sees the same
    attention-dropout seed and replays the other masks, so the losses, grad
    norms and params are bit-equal on the CPU."""
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(
        attention_dropout=0.1, hidden_dropout=0.1, activation_dropout=0.1), stage=0)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(1))
    batch = _batch(2, 3)
    out = {}
    for remat in (False, True):
        model = DACSModel(cfg, remat=remat)
        model.load_state_dict(sd)
        state = create_train_state(model, make_optimizer(model, 0, learning_rate=LR), 4)
        metrics = [make_train_step(cfg)(state, batch) for _ in range(2)]
        out[remat] = ([(float(m["loss"]), float(m["grad_norm"])) for m in metrics],
                      model.state_dict())
    assert out[True][0] == out[False][0]
    for k, v in out[False][1].items():
        assert torch.equal(out[True][1][k], v), k


def test_grad_accum_equals_one_batch_of_k_rows():
    """``grad_accum`` 2 over two micro-batches of 2 rows is one update of the
    summed gradient: the params equal one update on the 4 rows together
    (rtol 1e-5 over atol 1e-7: the CTC loss is a sum over rows), the
    clip included; the first micro-step moves nothing. The key biases are
    exempt, as in ``_assert_params_match``: their exact gradient is 0, so
    Adam turns the rounding noise of two sums into steps of up to lr."""
    cfg = _cfg()
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(2))
    batch = _batch(4, 5)
    out = {}
    for k in (1, 2):
        model = DACSModel(cfg)
        model.load_state_dict(sd)
        state = create_train_state(model, make_optimizer(
            model, 0, learning_rate=LR, max_grad_norm=50.0, grad_accum=k), 0)
        step = make_train_step(cfg)
        if k == 1:
            norm = step(state, batch)["grad_norm"]
        else:
            step(state, _rows(batch, slice(0, 2)))
            assert all(torch.equal(v, sd[n]) for n, v in model.state_dict().items())
            step(state, _rows(batch, slice(2, 4)))
        out[k] = model.state_dict()
    assert float(norm) > 50.0  # the clip binds
    for n, v in out[1].items():
        if not n.endswith("attention.k_proj.bias"):
            torch.testing.assert_close(out[2][n], v, rtol=1e-5, atol=1e-7, msg=n)


def test_prefetch_stages_same_batches_and_reraises():
    """``prefetch_device_batches`` yields the batches synchronous staging
    gives, in order; a failure in the producer thread is raised in the
    consumer (never a quiet fallback); a consumer that leaves early stops the
    thread; ``prefetch_iter`` likewise."""
    exs = _uniform(6, 7)
    bat = LengthBucketBatcher(exs, 2, time_multiple=3200)
    want = [DeviceBatch.from_host(b, "cpu") for b in bat.epoch(3)]
    got = [db for _, db in prefetch_device_batches(bat.epoch(3), 2, "cpu")]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))

    def failing():
        yield from bat.epoch(3)
        raise OSError("disk gone")

    seen = []
    with pytest.raises(OSError, match="disk gone"):
        for b, _ in prefetch_device_batches(failing(), 2, "cpu"):
            seen.append(b)
    assert len(seen) == 3
    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_iter(failing(), 1))
    before = threading.active_count()
    it = prefetch_iter(iter(range(100)), 2)
    assert next(it) == 0
    it.close()
    for t in threading.enumerate():
        if t.name == "prefetch":
            t.join(timeout=5)
    assert threading.active_count() <= before
