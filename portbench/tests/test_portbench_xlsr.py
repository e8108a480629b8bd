"""The benchmark's pieces for XLS-R 2B and the long-utterance cells: the
configuration file against the port's preset, the pre-LN layouts' stage-0
gradients against the reference, tiny fp32 runs of the two new cells, and
the ``trainer_lean`` kind's reference against the ``trainer`` kind's.

    python -m pytest portbench/tests/test_portbench_xlsr.py
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from portbench.kinds import trainer, trainer_lean
from portbench.lib import harness, inputs
from portbench.lib.program import BACKBONE_KEYS, backbone_kwargs, dacs_config
from portbench.reference import ssl_dacs as ref
from portbench.tests.conftest import tiny_config, tiny_traffic

NAME = "wav2vec2-xls-r-2b.dacs"
CELLS = ["xlsr-2b.train-s0.b8x7.5-15s", "d2v-large.train-s0.mixed-2-15s"]


def _tiny_context(cell_name: str, dtype: str, seed: int = 2_718_281_828) -> harness.Context:
    """A cell at the tiny size on the CPU, as ``conftest.run_tiny`` builds
    it; a ``trainer_lean`` mix takes the ``trainer`` mix's tiny sizes."""
    spec = harness.load_spec()
    cell, _, traffic, limits = harness.load_cell(cell_name, spec)
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = tiny_config(conf["file"].rsplit("/", 1)[-1][:-len(".json")])
    config["compute_dtype"] = dtype
    tiny = dict(tiny_traffic(dict(traffic, kind="trainer")), kind=traffic["kind"])
    return harness.Context(cell, config, tiny, limits, seed, 1.0, False, torch.device("cpu"),
                           time.perf_counter())


def test_config_file_is_its_port_preset():
    from privacy_preserve_federated_asr_tpu_torch.models.config import BackboneConfig

    cfg = json.loads((harness.BENCH_DIR / "configs" / f"{NAME}.json").read_text())
    assert cfg["port_preset"] == "BackboneConfig.wav2vec2_xls_r_2b"
    preset = BackboneConfig.wav2vec2_xls_r_2b()
    assert {k: getattr(preset, k) for k in BACKBONE_KEYS} == backbone_kwargs(cfg)
    conf = {c["name"]: c for c in harness.load_spec()["configs"]}[NAME]
    assert conf["source"] == cfg["source"] and conf["file"].endswith(f"{NAME}.json")
    assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"],
            cfg["intermediate_size"]) == (1920, 48, 16, 7680)


def test_reference_parameters_are_the_ports():
    from privacy_preserve_federated_asr_tpu_torch.models.dacs import DACSModel

    cfg = json.loads((harness.BENCH_DIR / "configs" / f"{NAME}.json").read_text())
    with torch.device("meta"):
        model = DACSModel(dacs_config(cfg, stage=2))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == ref.param_shapes(cfg)


@pytest.mark.parametrize("name", ["hubert-large-ls960.dacs", NAME])
def test_pre_ln_gradients_match_port_fp32(name):
    """Stage-0 loss and gradients at dropout 0 in the pre-LN layout with the
    single conv: the reference's summed CTC against the port's loss through
    its own autograd. The floor is at the gradients' scale: the key biases'
    exact gradient is 0 (a shift shared by a query's keys leaves its softmax
    as it was), so both sides hold rounding noise there, ~1e-9 here."""
    from privacy_preserve_federated_asr_tpu_torch.models.dacs import DACSModel
    from privacy_preserve_federated_asr_tpu_torch.models.objectives import dacs_loss

    ref.fp32_only()
    cfg = tiny_config(name)
    cfg.update(hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    w = inputs.draw_weights(cfg, 5, "cpu")
    model = DACSModel(dacs_config(cfg, stage=0))
    model.load_state_dict(w)
    model.train()
    r = inputs.rng(5, 0)
    lens = np.array([16000, 12000])
    audio = ref.pad_rows([ref.normalize(inputs.audio(r, n)) for n in lens], 16000)
    labels = r.integers(4, 32, size=(2, 6)).astype(np.int32)
    out = model(torch.from_numpy(audio), torch.from_numpy(lens.astype(np.int32)),
                need_masks=False)
    loss, _ = dacs_loss(out, torch.from_numpy(labels), torch.tensor([6, 6]), torch.zeros(2),
                        model.cfg, model.similar_fc.weight, aux_metrics=False)
    loss.backward()
    wr = {k: v.clone() for k, v in w.items()}
    trainable = {k: t.requires_grad_() for k, t in wr.items() if ref.stage0_trainable(k)}
    plan = ref.DropoutPlan(cfg, 2, audio.shape[1] // 320, torch.Generator(), "cpu",
                           torch.float32)
    total, grads = ref.train_step_grads(cfg, wr, trainable, audio, lens, labels,
                                        np.array([6, 6]), plan, "cpu", block=1)
    assert total == pytest.approx(float(loss.detach()), rel=1e-5)
    params = dict(model.named_parameters())
    norms = sorted(float(g.norm()) for g in grads.values())
    floor = 1e-9 * norms[len(norms) // 2]
    for k, g in grads.items():  # two CTC implementations: compare by norm
        assert float((params[k].grad - g).norm()) <= 1e-4 * float(g.norm()) + floor, k


@pytest.mark.parametrize("cell", CELLS)
def test_cell_in_fp32_agrees_with_reference(cell):
    """A whole tiny run in float32, dropout on: every compared number near
    rounding, so the reference replays the program's dropout and batching
    exactly (the XLS-R cell through the ``trainer_lean`` kind)."""
    ctx = _tiny_context(cell, "float32")
    line = harness.result(harness.load_spec(), ctx, harness.run_kind(ctx))
    assert line["correct"], line["checks"]
    c = line["checks"]
    assert c["loss_rel_gap"]["value"] < 1e-5
    assert c["first_grad_leaf_gap"]["value"] < 1e-3
    assert c["first_grad_cos_gap"]["value"] < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lean_reference_is_the_trainer_kinds(dtype):
    """The ``trainer_lean`` kind's reference steps give the ``trainer``
    kind's losses, gradient norms, changes and cosines, bit for bit, from
    the same weights, batches and dropout (bf16: the rounded leaves are the
    straight-through copies' values)."""
    ctx = _tiny_context(CELLS[0], dtype, seed=123_456_789_011)
    corpus = inputs.train_corpus(ctx.traffic, ctx.seed)
    g = torch.Generator().manual_seed(3)
    prog_first = {k: torch.randn(s, generator=g) for k, s in ref.param_shapes(ctx.config).items()
                  if ref.stage0_trainable(k)}
    want = trainer.reference_steps(ctx, corpus, prog_first)
    got = trainer_lean.reference_steps(ctx, corpus, prog_first)
    assert got[0] == want[0] and min(want[0]) > 0
    for a, b in zip(got[1:], want[1:]):
        assert a.keys() == b.keys() and all(a[k] == b[k] for k in a), \
            max(abs(a[k] - b[k]) for k in a)
