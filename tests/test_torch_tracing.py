"""The port's spans (utils/profiling.py ``span``) on the CPU: one train step
of a tiny ``Trainer`` under ``torch.profiler`` opens each of the eight
spans once, nested as the step runs, at stage 0 (the frontend-cache
feature step), and the same tree at stages 1 and 2 (the encoder-cache
step), whose losses hold no and two CTC terms; without a profiler
``span`` is one shared no-op, and profiling a step changes none of its
numbers."""

import contextlib

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from privacy_preserve_federated_asr_tpu_torch.data import (
    AsrExample,
    CTCCharTokenizer,
    prepare_examples,
)
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    init_dacs_state_dict,
)
from privacy_preserve_federated_asr_tpu_torch.train import Trainer, TrainerConfig
from privacy_preserve_federated_asr_tpu_torch.utils import span
from test_torch_backbone import one_torch_thread  # noqa: F401

SPANS = ("dacs.train.step", "dacs.train.gather", "dacs.train.forward", "dacs.train.loss",
         "dacs.ctc.forward", "dacs.train.backward", "dacs.ctc.backward", "dacs.train.optim")
# each span's parent
PARENT = {"dacs.train.gather": "dacs.train.step", "dacs.train.forward": "dacs.train.step",
          "dacs.train.loss": "dacs.train.step", "dacs.train.backward": "dacs.train.step",
          "dacs.train.optim": "dacs.train.step", "dacs.ctc.forward": "dacs.train.loss",
          "dacs.ctc.backward": "dacs.train.backward"}


def _trainer(stage: int, **backbone) -> Trainer:
    """The tiny Trainer of test_torch_train.py on two utterances of ~0.07 s
    (~100 frames: the CTC recursions loop over frames in Python);
    ``backbone``: fields of the tiny backbone replaced."""
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests(**backbone), stage=stage)
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    examples = prepare_examples(
        [AsrExample(path=f"S00{i}_PAR_{i}.wav", text=text, dementia_label=i,
                    array=rng.normal(0, 0.1, n).astype(np.float32))
         for i, (n, text) in enumerate([(1100, "THE JAR"), (800, "A STOOL")])],
        CTCCharTokenizer())
    tcfg = TrainerConfig(batch_size=2, learning_rate=1e-3, time_multiple=400, log_dir=".")
    return Trainer(cfg, sd, examples, None, CTCCharTokenizer(), tcfg, device="cpu")


def _one_step(tr: Trainer, profiled: bool, all_threads: bool = False):
    """The first step ``Trainer.train`` would run -> (its loss, the
    profiler's events or None); ``all_threads``: a profiler of every
    thread, as the benchmark runs it."""
    _, (fn, args) = next(iter(tr.train_batches(0)))
    config = _ExperimentalConfig(profile_all_threads=True) if all_threads else None
    with (profile(activities=[ProfilerActivity.CPU], experimental_config=config) if profiled
          else contextlib.nullcontext()) as prof:
        metrics = fn(tr.state, *args)
    return metrics["loss"], (prof.events() if profiled else None)


@pytest.mark.parametrize("stage,all_threads", [(0, False), (0, True), (1, True), (2, False)])
def test_train_step_spans_nest(stage, all_threads):
    """Each span once per step, inside its parent's interval; the gather
    is the cache's (row gathers, no encoder), and the forward runs the
    encoder at stage 0 (its positional conv) and the heads alone on the
    cached encoder output at stages 1 and 2."""
    tr = _trainer(stage)
    assert (tr._cache_frontend, tr._cache_encoder) == (stage == 0, stage > 0)
    _, events = _one_step(tr, profiled=True, all_threads=all_threads)
    found = {name: [(e.time_range.start, e.time_range.end) for e in events if e.name == name]
             for name in SPANS}
    ctc_terms = {0: 1, 1: 0, 2: 2}[stage]
    assert {k: len(v) for k, v in found.items()} == {
        k: ctc_terms if k.startswith("dacs.ctc.") else 1 for k in SPANS}
    for name, parent in PARENT.items():
        [(pa, pb)] = found[parent]
        for a, b in found[name]:
            assert pa <= a and b <= pb, (name, parent)

    def ops_in(name):
        [(a, b)] = found[name]
        return {e.name for e in events if e.name.startswith("aten::")
                and a <= e.time_range.start and e.time_range.end <= b}

    assert "aten::index" in ops_in("dacs.train.gather")
    assert "aten::convolution" not in ops_in("dacs.train.gather")
    assert ("aten::convolution" in ops_in("dacs.train.forward")) == (stage == 0)


def test_span_is_shared_noop_without_profiler():
    off = span("dacs.train.step")
    assert off is span("dacs.ctc.backward")
    assert isinstance(off, contextlib.nullcontext)
    for config in (None, _ExperimentalConfig(profile_all_threads=True)):
        with profile(activities=[ProfilerActivity.CPU], experimental_config=config):
            assert isinstance(span("dacs.train.step"), torch.profiler.record_function)
        assert span("dacs.train.step") is off


def test_profiled_step_is_bit_equal():
    """Two Trainers from one seed: the step profiled and the step not give
    the same loss and parameters, bit for bit (each steps before the next
    is built: building one seeds the default generator both draw their
    dropout masks from)."""
    plain = _trainer(0)
    loss_a, _ = _one_step(plain, profiled=False)
    traced = _trainer(0)
    loss_b, _ = _one_step(traced, profiled=True)
    assert torch.equal(loss_a, loss_b)
    want = traced.state.model.state_dict()
    for k, v in plain.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("pos_conv_type", ["stacked", "single"])
def test_pos_conv_spans(pos_conv_type):
    """The positional conv's span in one stage-0 step: once, inside
    ``dacs.train.forward``, around every convolution of the forward; the
    backward's convolutions lie outside it."""
    tr = (_trainer(0) if pos_conv_type == "stacked" else
          _trainer(0, pos_conv_type="single", num_conv_pos_embeddings=4,
                   do_stable_layer_norm=True))
    _, events = _one_step(tr, profiled=True, all_threads=True)

    def one(name):
        [(a, b)] = [(e.time_range.start, e.time_range.end) for e in events if e.name == name]
        return a, b

    (a, b), (pa, pb) = one("dacs.encoder.pos_conv"), one("dacs.train.forward")
    assert pa <= a and b <= pb
    inside = [e for e in events if e.name == "aten::convolution"]
    assert inside and all(a <= e.time_range.start and e.time_range.end <= b for e in inside)
    after = [e for e in events if e.name == "aten::convolution_backward"]
    assert after and all(e.time_range.start >= b for e in after)
