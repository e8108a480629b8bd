"""CSV -> examples pipeline (the reference's ``csv2dataset`` capability).

A copy of ``privacy_preserve_federated_asr_tpu/data/dataset.py`` (the port
imports nothing of the JAX package): audio loads through the native threaded
loader (``native/libdacsaudio.so``, ``data/native_audio.py``) with a per-file
scipy retry.

Reference behavior reproduced (federated/src/utils.py:97-149,
centralized/utils.py:62-111):
  * CSV columns ``path`` (+ optional ``sentence``); rows with empty
    transcripts are skipped when transcripts are expected,
  * waveform loaded at 16 kHz; utterances <= 1600 samples (0.1 s) dropped,
  * transcripts uppercased,
  * dementia label derived from the filename: ``S###_INV_...`` -> 0
    (interviewer), ``S###_PAR_...`` -> speaker lookup table,
  * optional on-disk cache (npz per split instead of HF arrow).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .audio import load_audio, normalize_input_values
from .tokenizer import CTCCharTokenizer


@dataclass
class AsrExample:
    path: str
    array: np.ndarray                    # raw waveform @16 kHz
    text: str | None                     # uppercase transcript (None if unlabeled)
    dementia_label: int
    input_values: np.ndarray | None = None   # normalized waveform
    labels: np.ndarray | None = field(default=None)  # CTC label ids

    def __len__(self) -> int:
        return len(self.array)


def id_to_label(file_id: str, spk2label: dict[str, int]) -> int:
    """Filename ``S###_{INV|PAR}_...`` -> dementia label.

    INV (interviewer) is always healthy-control (0); PAR (participant) is
    looked up in the speaker->label table
    (reference: federated/src/utils.py:52-59).
    """
    name = Path(file_id).name.split("_")
    if len(name) > 1 and name[1] == "INV":
        return 0
    return int(spk2label[name[0]])


def load_spk2label(path: str) -> dict[str, int]:
    """Load a speaker->label table from a numpy ``.npy`` pickle (reference
    meta-data format, e.g. meta-data/test_dic.npy)."""
    return np.load(path, allow_pickle=True).tolist()


def csv_to_examples(
    audio_dir: str,
    csv_path: str,
    spk2label: dict[str, int],
    with_transcript: bool = True,
    cache_dir: str | None = None,
    min_samples: int = 1600,
    target_sr: int = 16000,
) -> list[AsrExample]:
    """Read a split CSV and load audio + labels (with optional npz cache)."""
    cache_file = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        stem = Path(csv_path).stem
        cache_file = Path(cache_dir) / f"{stem}.npz"
        if cache_file.exists():
            return _load_cache(cache_file)

    rows: list[tuple[str, str | None]] = []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            path = row["path"]
            sentence = row.get("sentence")
            if with_transcript and (sentence is None or sentence == ""):
                continue
            rows.append((path, sentence))

    wav_paths = [os.path.join(audio_dir, p) for p, _ in rows]
    sigs = _load_all_audio(wav_paths, target_sr)
    examples: list[AsrExample] = []
    for (path, sentence), sig in zip(rows, sigs):
        if sig is None or len(sig) <= min_samples:
            continue
        examples.append(
            AsrExample(
                path=path,
                array=sig,
                text=sentence.upper() if (with_transcript and sentence) else None,
                dementia_label=id_to_label(path, spk2label),
            )
        )
    if cache_file is not None:
        _save_cache(cache_file, examples)
    return examples


def _load_all_audio(wav_paths: list[str], target_sr: int) -> list:
    """Corpus audio load: the native threaded loader (native/wavio.cpp via
    data/native_audio.py, bit-equal to the scipy path) when the shared
    library is available, then per-file scipy for whatever it did not load
    (all files without the library). A file that fails both becomes None
    (logged), matching the reference's skip-and-print behavior
    (federated/src/utils.py csv2dataset)."""
    from . import native_audio

    sigs = (native_audio.load_many_native(wav_paths, target_sr=target_sr)
            if native_audio.available() else [None] * len(wav_paths))
    # the native parser covers PCM 8/16/24/32 + IEEE float32; scipy also
    # reads e.g. float64 WAVs — a corpus must not shrink just because the
    # C++ loader was buildable
    for i, (p, s) in enumerate(zip(wav_paths, sigs)):
        if s is None:
            try:
                sigs[i] = load_audio(p, target_sr=target_sr)
            except Exception as e:  # any decode error (struct.error on a
                # truncated file, IsADirectoryError, ...): one bad file is
                # skipped, not the corpus build aborted
                print(f"Err file = {p}: {e}")
    return sigs


def prepare_examples(
    examples: list[AsrExample], tokenizer: CTCCharTokenizer
) -> list[AsrExample]:
    """Attach normalized input_values and CTC label ids (the reference's
    ``prepare_dataset`` map, federated/src/utils.py:40-50)."""
    for ex in examples:
        ex.input_values = normalize_input_values(ex.array)
        if ex.text is not None:
            ex.labels = np.asarray(tokenizer.encode(ex.text), dtype=np.int32)
    return examples


def _save_cache(cache_file: Path, examples: list[AsrExample]) -> None:
    arrays = np.empty(len(examples), dtype=object)
    for i, e in enumerate(examples):
        arrays[i] = e.array
    np.savez_compressed(
        cache_file,
        paths=np.array([e.path for e in examples]),
        texts=np.array([e.text if e.text is not None else "" for e in examples]),
        labels=np.array([e.dementia_label for e in examples], dtype=np.int32),
        arrays=arrays,
    )


def _load_cache(cache_file: Path) -> list[AsrExample]:
    z = np.load(cache_file, allow_pickle=True)
    return [
        AsrExample(
            path=str(p),
            array=np.asarray(a, dtype=np.float32),
            text=str(t) if t else None,
            dementia_label=int(l),
        )
        for p, a, t, l in zip(z["paths"], z["arrays"], z["texts"], z["labels"])
    ]
