"""The port package stands alone: it imports with jax/flax/optax/orbax,
scikit-learn and pandas blocked and loads nothing of the JAX package (its
native-library shims included);
neither its sources nor chip_smoke.py import JAX or the JAX package; and its
entry points never carry on quietly on the CPU when the default device
(cuda) is missing."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import privacy_preserve_federated_asr_tpu_torch as port_pkg
from privacy_preserve_federated_asr_tpu_torch import cli
from privacy_preserve_federated_asr_tpu_torch.models import (
    BackboneConfig,
    DACSConfig,
    init_dacs_state_dict,
)
from privacy_preserve_federated_asr_tpu_torch.serving import InferenceEngine, ServingConfig
from test_torch_backbone import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(port_pkg.__file__).parent
BLOCKED = ("jax", "flax", "optax", "orbax")
JAX_PKG = "privacy_preserve_federated_asr_tpu"

_CHILD = f"""
import importlib, pkgutil, sys
for m in {BLOCKED + ("sklearn", "pandas")!r}:
    sys.modules[m] = None  # any import of it raises ImportError
import privacy_preserve_federated_asr_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# the ctypes shims load the native libraries without the JAX package
from privacy_preserve_federated_asr_tpu_torch.data import native_audio
from privacy_preserve_federated_asr_tpu_torch.ops import beam
assert native_audio.available() and beam.native_available()
bad = [m for m in sys.modules if m == {JAX_PKG!r} or m.startswith({JAX_PKG + "."!r})]
print(len(names), bad)
"""


def test_port_imports_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(maxsplit=1)
    assert int(n) >= 50 and bad.strip() == "[]", res.stdout


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        bad = _imported_roots(f) & {*BLOCKED, JAX_PKG}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DACSConfig(backbone=BackboneConfig.tiny_for_tests())
    sd = init_dacs_state_dict(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--model_type", "tiny", "--no_warmup"])
    # the CPU is taken only when asked for
    scfg = ServingConfig(batch_size=1, time_multiple=3200, compute_dtype="float32")
    eng = InferenceEngine(cfg, sd, scfg=scfg, device="cpu")
    assert eng.infer_batch([np.zeros(3200, np.float32)])[0].samples == 3200


def test_copied_numpy_modules_match_jax_package(tmp_path):
    """data/audio.py, data/tokenizer.py, data/splits.py,
    federated/privacy.py, evaluation/detail_wer.py and
    evaluation/feat_scoring.py are copies, not imports: they must keep
    giving the JAX package's answers."""
    from types import SimpleNamespace

    from scipy.io import wavfile

    from privacy_preserve_federated_asr_tpu.data import audio as jax_audio
    from privacy_preserve_federated_asr_tpu.data import splits as jax_splits
    from privacy_preserve_federated_asr_tpu.data.tokenizer import CTCCharTokenizer as JaxTok
    from privacy_preserve_federated_asr_tpu.evaluation import detail_wer as jax_detail_wer
    from privacy_preserve_federated_asr_tpu.evaluation import feat_scoring as jax_feat_scoring
    from privacy_preserve_federated_asr_tpu.federated import privacy as jax_privacy
    from privacy_preserve_federated_asr_tpu_torch.data import audio, splits
    from privacy_preserve_federated_asr_tpu_torch.data.tokenizer import CTCCharTokenizer
    from privacy_preserve_federated_asr_tpu_torch.evaluation import detail_wer, feat_scoring
    from privacy_preserve_federated_asr_tpu_torch.federated import privacy

    assert splits.CLIENT_SPLITS_ADRESS == jax_splits.CLIENT_SPLITS_ADRESS
    assert splits.CLIENT_SPLITS_ADRESSO == jax_splits.CLIENT_SPLITS_ADRESSO
    exs = [SimpleNamespace(path=f"S{i:03d}_PAR_0.wav") for i in range(160)]
    for cid in ("public", 0, 1):
        spk = splits.CLIENT_SPLITS_ADRESS[cid]
        assert splits.filter_by_speakers(exs, spk) == jax_splits.filter_by_speakers(exs, spk)
    for q, sigma in ((0.02, 4.0), (0.5, 1.1), (1.0, 0.7)):
        np.testing.assert_array_equal(privacy.rdp_sampled_gaussian(q, sigma),
                                      jax_privacy.rdp_sampled_gaussian(q, sigma))
        assert (privacy.epsilon_for_rounds(30, q, sigma, 1e-5)
                == jax_privacy.epsilon_for_rounds(30, q, sigma, 1e-5))
    assert (privacy.noise_for_epsilon(30, 0.5, 8.0, 1e-5)
            == jax_privacy.noise_for_epsilon(30, 0.5, 8.0, 1e-5))
    acc, jacc = privacy.DpAccountant(delta=1e-6), jax_privacy.DpAccountant(delta=1e-6)
    for a in (acc, jacc):
        a.step(0.5, 1.1, num_steps=3)
        a.step(1.0, 2.0)
    assert acc.epsilon() == jacc.epsilon() and acc.state_dict() == jacc.state_dict()
    assert privacy.DpAccountant.from_state(acc.state_dict()).epsilon() == acc.epsilon()

    rng = np.random.default_rng(11)
    x = rng.normal(0, 0.2, 5000).astype(np.float32)
    for fn in ("normalize_input_values", "peak_normalize"):
        np.testing.assert_array_equal(getattr(audio, fn)(x), getattr(jax_audio, fn)(x))
    wav = tmp_path / "a.wav"
    wavfile.write(wav, 8000, (x * 32767).astype(np.int16))
    np.testing.assert_array_equal(audio.load_audio(str(wav)), jax_audio.load_audio(str(wav)))
    tok, jtok = CTCCharTokenizer(), JaxTok()
    assert tok.encode("HELLO WORLD'S") == jtok.encode("HELLO WORLD'S")
    ids = rng.integers(0, 32, 200)
    assert tok.decode(ids) == jtok.decode(ids)
    assert tok.decode(ids, group_tokens=False) == jtok.decode(ids, group_tokens=False)

    words = ["THE", "BOY", "JAR", "SINK", "IS", "ON"]
    rows = [{"path": f"S{i % 4:03d}_{'INV' if i % 3 == 0 else 'PAR'}_{i}.wav",
             "text": " ".join(rng.choice(words, 1 + i % 5)),
             "pred_str": " ".join(rng.choice(words, i % 4)),
             "dementia_labels": i % 2,
             "lm_mask": (rng.random((1, 7 + i, 6)) > 0.5).astype(np.float32),
             "dementia_mask": (rng.random((1, 7 + i, 6)) > 0.4).astype(np.float32)}
            for i in range(12)]
    id2mmse = {"S000": 29, "S001": 23, "S002": 12, "S003": 4}
    assert detail_wer.MMSE_BANDS == jax_detail_wer.MMSE_BANDS
    for level in (1, 2, 3):
        assert (detail_wer.detailed_wer_report(rows, level, id2mmse)
                == jax_detail_wer.detailed_wer_report(rows, level, id2mmse))
    for fn in ("mask_node_statistics", "per_utt_on_rates"):
        got, want = getattr(feat_scoring, fn)(rows), getattr(jax_feat_scoring, fn)(rows)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
