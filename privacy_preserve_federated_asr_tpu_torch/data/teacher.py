"""Teacher-student pseudo-transcription for unlabeled (ADReSSo) audio (the
port's ``data/teacher.py``).

The reference transcribes ADReSSo train clips offline with Whisper large-v2
and merges the stored transcripts (``transcript.json``: a list aligned with
the dataset order, or CSVs) into the dataset at startup (reference:
federated/src/federated_main.py:29-68 ``TeacherStudentLearning``, :283-298
merge + filter). Here:

  * :func:`load_transcripts` ingests the reference's transcript.json / CSV
    artifacts,
  * :func:`add_transcripts` attaches them with the reference's filter, and
  * :func:`transcribe_with_ctc_model` makes the package's own fine-tuned CTC
    model the teacher (self-training; ``cli teacher`` without
    ``--whisper_hf``).

The Whisper teacher of the JAX package (``WhisperTeacher``, the
temperature-fallback decode) is not ported yet.
"""

from __future__ import annotations

import csv
import json
from typing import Mapping, Sequence

import numpy as np
import torch

from .dataset import AsrExample
from .tokenizer import CTCCharTokenizer


def load_transcripts(path: str) -> list[str] | dict[str, str]:
    """Load a transcript artifact: JSON (list aligned to dataset order, or
    {path: text} dict) or CSV with path,text (or path,sentence) columns."""
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    out: dict[str, str] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out[row["path"]] = row.get("text", row.get("sentence", ""))
    return out


def add_transcripts(examples: Sequence[AsrExample],
                    transcripts: list[str] | dict[str, str],
                    tokenizer: CTCCharTokenizer | None = None,
                    min_samples: int = 1600) -> list[AsrExample]:
    """Attach teacher transcripts and filter (len(audio) >= 1600 samples and
    non-empty text, the reference's ``FilterAvailAudios``)."""
    if isinstance(transcripts, dict):
        texts = [transcripts.get(e.path, "") for e in examples]
    else:
        if len(transcripts) != len(examples):
            raise ValueError(f"{len(transcripts)} transcripts for {len(examples)} examples")
        texts = list(transcripts)
    out = []
    for e, text in zip(examples, texts):
        text = (text or "").upper().strip()
        if len(e.array) < min_samples or not text:
            continue
        e.text = text
        if tokenizer is not None:
            e.labels = np.asarray(tokenizer.encode(text), dtype=np.int32)
        out.append(e)
    return out


def transcribe_with_ctc_model(cfg, state_dict: Mapping[str, torch.Tensor],
                              examples: Sequence[AsrExample], tokenizer: CTCCharTokenizer,
                              batch_size: int = 16, time_multiple: int = 16000,
                              device: str | torch.device = "cuda") -> dict[str, str]:
    """path -> greedy transcript of a fine-tuned CTC model of this package
    (``cfg`` / ``state_dict`` as ``extract_embeddings`` takes them; fp32,
    the extraction default), the teacher of the self-training pass."""
    from ..evaluation.extract import extract_embeddings

    rows = extract_embeddings(cfg, state_dict, examples, tokenizer, batch_size=batch_size,
                              time_multiple=time_multiple, device=device)
    return {r.path: r.pred_str for r in rows}
