"""Audio ingest: 16 kHz wav loading, resampling, normalization.

Replaces the reference's librosa/scipy load paths
(reference: federated/src/utils.py:126-134): wav files are read with
``scipy.io.wavfile``, converted to float32 in [-1, 1], resampled to 16 kHz
with a polyphase filter when needed, and (for the scipy path parity)
peak-normalized like ``librosa.util.normalize``. Feature normalization is
the Wav2Vec2FeatureExtractor zero-mean/unit-variance transform.

A copy of ``privacy_preserve_federated_asr_tpu/data/audio.py``: the port
imports nothing of the JAX package, not even its numpy-only modules.
"""

from __future__ import annotations

import numpy as np

_INT_SCALES = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0,
               np.dtype(np.uint8): 128.0}


def peak_normalize(x: np.ndarray) -> np.ndarray:
    """librosa.util.normalize default: divide by max |x| (inf-norm)."""
    x = np.asarray(x, dtype=np.float32)
    peak = np.max(np.abs(x))
    if peak > 0:
        x = x / peak
    return x


def load_audio(path: str, target_sr: int = 16000, normalize: bool = True) -> np.ndarray:
    """Load a wav file as mono float32 at ``target_sr``.

    Stereo is averaged to mono; integer PCM is scaled to [-1, 1];
    ``normalize`` applies peak normalization (the reference's scipy path).
    """
    # imported here: scipy.signal takes seconds to import, and the serving
    # path (which only normalizes) should not pay for it
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, sig = wavfile.read(path)
    sig = np.asarray(sig)
    if sig.ndim == 2:
        sig = sig.mean(axis=1)
    if sig.dtype in _INT_SCALES:
        scale = _INT_SCALES[sig.dtype]
        offset = 128.0 if sig.dtype == np.uint8 else 0.0
        sig = (sig.astype(np.float32) - offset) / scale
    else:
        sig = sig.astype(np.float32)
    if sr != target_sr:
        g = np.gcd(int(sr), int(target_sr))
        sig = resample_poly(sig, target_sr // g, sr // g).astype(np.float32)
    if normalize:
        sig = peak_normalize(sig)
    return sig


def normalize_input_values(x: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Wav2Vec2FeatureExtractor zero-mean / unit-variance normalization.

    HF computes ``(x - mean) / sqrt(var + 1e-7)`` per utterance, before
    padding (reference pipeline: ``processor(audio).input_values[0]``).
    """
    x = np.asarray(x, dtype=np.float32)
    mean = x.mean()
    var = x.var()
    return ((x - mean) / np.sqrt(var + eps)).astype(np.float32)
