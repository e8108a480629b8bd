"""The plain reference against the port at a tiny size on the CPU, in
float32, and the configuration files against the port's presets. (The
tests import both; the reference module imports nothing of the port.)"""

import ast
import json

import numpy as np
import pytest
import torch

from portbench.lib import inputs
from portbench.lib.harness import BENCH_DIR
from portbench.lib.program import BACKBONE_KEYS, backbone_kwargs, dacs_config
from portbench.reference import ssl_dacs as ref
from portbench.tests.conftest import run_tiny, spec_with_test_cells, tiny_config

CONFIGS = ["data2vec-audio-large.dacs", "hubert-large-ls960.dacs"]


def _file(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_reference_imports_only_torch_and_numpy():
    allowed = {"__future__", "math", "numpy", "torch"}
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= allowed, (path.name, names)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file_is_its_port_preset(name):
    from privacy_preserve_federated_asr_tpu_torch.models.config import BackboneConfig

    cfg = _file(name)
    preset = getattr(BackboneConfig, cfg["port_preset"].split(".")[-1])()
    kw = backbone_kwargs(cfg)
    assert {k: getattr(preset, k) for k in BACKBONE_KEYS} == kw
    conf = {c["name"]: c for c in spec_with_test_cells()["configs"]}[name]
    assert conf["source"] == cfg["source"] and conf["file"].endswith(f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_parameters_are_the_ports(name):
    from privacy_preserve_federated_asr_tpu_torch.models.dacs import DACSModel

    cfg = _file(name)
    with torch.device("meta"):
        model = DACSModel(dacs_config(cfg, stage=2))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == ref.param_shapes(cfg)


@pytest.mark.parametrize("seed,b_offset,t", [(0, 0, 249), (-123456789, 5, 200), (2**31 - 2, 1, 77)])
def test_keep_hash_copy_is_the_kernels(seed, b_offset, t):
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import bh_index, keep_mask

    b, h, rate = 3, 4, 0.1
    mine = ref.attention_keep(seed, b, b_offset, h, t, rate, "cpu")
    t_hash = -(-t // 128) * 128
    port = keep_mask(seed, b * h, t, t, t_hash, rate, bh_idx=bh_index(b, h, b_offset))
    assert torch.equal(mine.reshape(b * h, t, t), port)
    assert 0.08 < 1.0 - mine.float().mean() < 0.12


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_matches_port_fp32(name):
    from privacy_preserve_federated_asr_tpu_torch.models.dacs import DACSModel

    ref.fp32_only()
    cfg = tiny_config(name)
    w = inputs.draw_weights(cfg, 77, "cpu")
    model = DACSModel(dacs_config(cfg, stage=2))
    model.load_state_dict(w)
    model.eval()
    r = inputs.rng(77, 0)
    lens = [16000, 23000, 9000]
    bucket = 32000
    audio = ref.pad_rows([ref.normalize(inputs.audio(r, n)) for n in lens], bucket)
    t = ref.conv_out_frames(cfg, bucket)
    lm_noise, ad_noise = ref.gumbel_noise((3, t, cfg["hidden_size"], 2), "cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(audio), torch.tensor(lens, dtype=torch.int32),
                    gumbel_noise=(lm_noise, ad_noise))
        fl = torch.tensor([ref.conv_out_frames(cfg, n) for n in lens])
        h = ref.encoder(cfg, w, ref.frontend(cfg, w, torch.from_numpy(audio)), fl)
        logits, dem = ref.stage2_heads(w, h, lm_noise, ad_noise, cfg["gs_tau"])
    assert torch.equal(out.frame_lengths.long(), fl)
    for i, n in enumerate(fl.tolist()):
        torch.testing.assert_close(out.logits[i, :n], logits[i, :n], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(out.dementia_logits_ad[i, :n], dem[i, :n], rtol=1e-4,
                                   atol=1e-4)


def test_reference_gradients_match_port_fp32():
    """Stage-0 loss and gradients at dropout 0: the reference's summed CTC
    against the port's loss through its own autograd."""
    from privacy_preserve_federated_asr_tpu_torch.models.dacs import DACSModel
    from privacy_preserve_federated_asr_tpu_torch.models.objectives import dacs_loss

    ref.fp32_only()
    cfg = tiny_config("data2vec-audio-large.dacs")
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
    for k, g in grads.items():  # two CTC implementations: compare by norm
        assert float((params[k].grad - g).norm()) <= 1e-4 * float(g.norm()) + 1e-9, k


@pytest.mark.parametrize("cell", ["d2v-large.train-s0.b64x5s", "serve.backlog",
                                  "serve.backlog.hubert"])
def test_cell_in_fp32_agrees_with_reference(cell):
    """A whole tiny run in float32, dropout on in training: every compared
    number near rounding, so the reference replays the program's dropout
    and batching exactly."""
    line = run_tiny(cell, dtype="float32")
    assert line["correct"], line["checks"]
    c = line["checks"]
    if "loss_rel_gap" in c:
        assert c["loss_rel_gap"]["value"] < 1e-5
        assert c["first_grad_leaf_gap"]["value"] < 1e-3
        assert c["first_grad_cos_gap"]["value"] < 1e-6
    else:
        assert c["ctc_tail_share"]["value"] == 0.0 and c["frames_mismatch"]["value"] == 0
