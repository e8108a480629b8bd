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
    ``--whisper_hf``), and
  * :class:`WhisperTeacher` is the reference's Whisper teacher on the card
    (``cli teacher --whisper_hf``): long-form windows, whisper's
    temperature fallback (:func:`fallback_transcribe`,
    :func:`fallback_transcribe_full`), conditioning on the previous text and
    the timestamp seek.
"""

from __future__ import annotations

import csv
import json
from typing import Callable, Mapping, Sequence

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


def _needs_retry(compression_ratio_threshold: float | None,
                 logprob_threshold: float | None) -> Callable[[str, float], bool]:
    from ..models.whisper import compression_ratio

    def needs_retry(text: str, lp: float) -> bool:
        if (compression_ratio_threshold is not None
                and compression_ratio(text) > compression_ratio_threshold):
            return True
        return logprob_threshold is not None and lp < logprob_threshold

    return needs_retry


def fallback_transcribe(decode: Callable, n_windows: int,
                        temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                        compression_ratio_threshold: float | None = 2.4,
                        logprob_threshold: float | None = -1.0,
                        seed: int = 0) -> list[str]:
    """whisper.transcribe's temperature-fallback loop over decode windows.

    ``decode(window_indices, temperature, seed) -> (texts, avg_logprobs)``
    decodes the given windows at one temperature. Every window first decodes
    at ``temperatures[0]``; a window whose text compresses too well
    (``compression_ratio > compression_ratio_threshold``) or whose
    ``avg_logprob < logprob_threshold`` is re-decoded at the next
    temperature, until it passes or the temperatures run out (whisper's
    ``decode_with_fallback``)."""
    needs_retry = _needs_retry(compression_ratio_threshold, logprob_threshold)
    idx = list(range(n_windows))
    texts, lps = decode(idx, float(temperatures[0]), seed)
    texts, lps = list(texts), list(lps)
    for ti, t in enumerate(temperatures[1:], start=1):
        bad = [i for i in idx if needs_retry(texts[i], float(lps[i]))]
        if not bad:
            break
        re_texts, re_lps = decode(bad, float(t), seed + ti)
        for i, tx, lp in zip(bad, re_texts, re_lps):
            texts[i], lps[i] = tx, lp
    return texts


def fallback_transcribe_full(decode: Callable, n_windows: int,
                             temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                             compression_ratio_threshold: float | None = 2.4,
                             logprob_threshold: float | None = -1.0,
                             seed: int = 0) -> tuple[list[str], list, list[float]]:
    """:func:`fallback_transcribe` that also returns each window's decoded
    token ids and the temperature of its final text (the conditioning path
    needs both). ``decode(window_indices, temperature, seed) -> (texts,
    avg_logprobs, ids)``, ids a [n, T] array of EOT-padded rows."""
    needs_retry = _needs_retry(compression_ratio_threshold, logprob_threshold)
    idx = list(range(n_windows))
    t0 = float(temperatures[0])
    texts, lps, ids = decode(idx, t0, seed)
    texts, lps, ids = list(texts), list(lps), list(ids)
    temps = [t0] * n_windows
    for ti, t in enumerate(temperatures[1:], start=1):
        bad = [i for i in idx if needs_retry(texts[i], float(lps[i]))]
        if not bad:
            break
        re_texts, re_lps, re_ids = decode(bad, float(t), seed + ti)
        for i, tx, lp, row in zip(bad, re_texts, re_lps, re_ids):
            texts[i], lps[i], ids[i], temps[i] = tx, lp, row, float(t)
    return texts, ids, temps


class WhisperTeacher:
    """The reference's Whisper teacher (``TeacherStudentLearning``,
    federated/src/federated_main.py:29-68) on ``device``: batched windows ->
    log-mel -> encoder -> KV-cached decode, with ``whisper.transcribe``'s
    long-form semantics: audio beyond one window is split into windows whose
    transcripts are stitched, and windows failing whisper's quality gates
    (compression ratio > 2.4 or avg_logprob < -1.0) are re-decoded at
    escalating temperatures.

    ``weights`` is an HF-named Whisper state dict (or the module
    ``port_hf_whisper`` built); ``detokenize`` maps token-id lists to text
    (``data/whisper_tokens.py`` for a checkpoint directory). Transcripts are
    uppercased and stripped like the reference's ``transcribe`` (:60). The
    defaults are the JAX package's: fp32, conditioning on the previous text
    (reset after a window decoded above temperature 0.5), and fixed windows
    unless ``timestamps`` (``cli teacher`` passes True: upstream's seek)."""

    def __init__(self, cfg, weights, detokenize: Callable[[Sequence[int]], str],
                 dtype: torch.dtype | None = None,
                 temperatures: Sequence[float] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                 compression_ratio_threshold: float | None = 2.4,
                 logprob_threshold: float | None = -1.0,
                 condition_on_previous_text: bool = True,
                 max_prompt_tokens: int | None = None,
                 timestamps: bool = False,
                 max_initial_timestamp: float | None = 1.0,
                 device: str | torch.device = "cuda"):
        from ..models.whisper import chunk_samples, port_hf_whisper
        from ..serving.engine import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = (weights if isinstance(weights, torch.nn.Module)
                      else port_hf_whisper(weights, cfg, self.device, dtype or torch.float32))
        self.detokenize = detokenize
        self.chunk = chunk_samples(cfg)
        self.temperatures = tuple(temperatures)
        self.compression_ratio_threshold = compression_ratio_threshold
        self.logprob_threshold = logprob_threshold
        self.condition_on_previous_text = condition_on_previous_text
        self.timestamps = timestamps
        self.max_initial_timestamp = max_initial_timestamp
        # whisper's n_ctx//2 - 1, capped so at least a quarter of the
        # positions stay for sampled tokens
        n_forced = len(cfg.forced_tokens(timestamps))
        self.max_prompt = (max_prompt_tokens if max_prompt_tokens is not None
                           else min(cfg.max_target_positions // 2 - 1,
                                    cfg.max_target_positions - n_forced
                                    - max(cfg.max_target_positions // 4, 1)))

    def _pad_or_trim(self, a: np.ndarray) -> np.ndarray:
        from ..models.whisper import pad_or_trim

        return pad_or_trim(a, self.chunk)

    def _ids_to_text(self, row) -> str:
        if self.timestamps:
            from ..models.whisper import timestamp_text_ids

            return self.detokenize(timestamp_text_ids(self.cfg, row)).upper().strip()
        eot = self.cfg.eot_token
        return self.detokenize([int(t) for t in row if int(t) != eot]).upper().strip()

    def _build_prompts(self, rows, prev):
        """Right-aligned ``<|startofprev|>`` conditioning prompts of the
        given clip rows from their previous-window contexts; the context
        resets after a window that needed temperature > 0.5 or that
        produced no tokens."""
        p = self.max_prompt
        prompts = np.full((len(rows), p), self.cfg.eot_token, np.int32)
        plens = np.zeros((len(rows),), np.int32)
        for j, i in enumerate(rows):
            ctx = prev[i]
            if ctx is None or ctx[1] > 0.5 or not ctx[0]:
                continue
            toks = [self.cfg.prev_token] + ctx[0][-(p - 1):]
            prompts[j, p - len(toks):] = toks
            plens[j] = len(toks)
        return prompts, plens

    def _decode_windows(self, windows: np.ndarray, idx, temperature, seed,
                        prompts: np.ndarray | None = None,
                        prompt_lens: np.ndarray | None = None):
        """Decode ``windows[idx]`` at one temperature -> (texts, lps, ids)
        (numpy); ``prompts``/``prompt_lens`` (aligned with ``windows``)
        condition the decode."""
        from ..models.whisper import decode_with_stats, log_mel_spectrogram

        sel = np.asarray(idx)
        audio = torch.from_numpy(np.ascontiguousarray(windows[sel])).to(self.device)
        mel = log_mel_spectrogram(audio, self.cfg.num_mel_bins)
        gen = torch.Generator(self.device).manual_seed(int(seed))
        kw = {} if prompts is None else dict(
            prompt_ids=torch.from_numpy(prompts[sel]).to(self.device),
            prompt_lens=torch.from_numpy(prompt_lens[sel]).to(self.device))
        ids, lps = decode_with_stats(self.cfg, self.model, mel, temperature, gen,
                                     timestamps=self.timestamps,
                                     max_initial_timestamp=self.max_initial_timestamp, **kw)
        ids, lps = ids.cpu().numpy(), lps.cpu().numpy()
        return [self._ids_to_text(row) for row in ids], lps, ids

    def _fallback(self, stack: np.ndarray, rows, prev, w: int):
        """One frontier of windows through the temperature fallback,
        conditioned on ``prev`` after the first window."""
        if self.condition_on_previous_text and w > 0:
            prompts, plens = self._build_prompts(rows, prev)
            decode = lambda idx, t, s: self._decode_windows(stack, idx, t, s, prompts, plens)
        else:
            decode = lambda idx, t, s: self._decode_windows(stack, idx, t, s)
        return fallback_transcribe_full(decode, len(rows), self.temperatures,
                                        self.compression_ratio_threshold,
                                        self.logprob_threshold, seed=w)

    def transcribe_batch(self, audios: Sequence[np.ndarray]) -> list[str]:
        """Transcribe a batch of clips of any length: each is split into
        ceil(len/chunk) windows (1 minimum) whose texts are stitched in
        order. With ``condition_on_previous_text`` the windows decode
        frontier by frontier (all clips' window 0 as one batch, then window
        1 conditioned on each clip's window-0 tokens, ...); without it, or
        when every clip fits one window, all windows decode as one batch.
        With ``timestamps`` each window advances by its last predicted
        segment boundary (:meth:`_transcribe_seek`)."""
        clips = [np.asarray(a, np.float32) for a in audios]
        if self.timestamps:
            return self._transcribe_seek(clips)
        n_wins = [max(1, -(-len(a) // self.chunk)) for a in clips]
        if not self.condition_on_previous_text or max(n_wins) == 1:
            owner, windows = [], []
            for a_i, a in enumerate(clips):
                for w in range(n_wins[a_i]):
                    windows.append(self._pad_or_trim(a[w * self.chunk:(w + 1) * self.chunk]))
                    owner.append(a_i)
            stack = np.stack(windows)
            texts = fallback_transcribe(
                lambda idx, t, s: self._decode_windows(stack, idx, t, s)[:2],
                len(windows), self.temperatures, self.compression_ratio_threshold,
                self.logprob_threshold)
            out = [[] for _ in audios]
            for o, t in zip(owner, texts):
                if t:
                    out[o].append(t)
            return [" ".join(parts) for parts in out]

        eot = self.cfg.eot_token
        parts: list[list[str]] = [[] for _ in clips]
        prev: list[tuple[list[int], float] | None] = [None] * len(clips)
        for w in range(max(n_wins)):
            rows = [i for i, n in enumerate(n_wins) if w < n]
            stack = np.stack([self._pad_or_trim(clips[i][w * self.chunk:(w + 1) * self.chunk])
                              for i in rows])
            texts, ids, temps = self._fallback(stack, rows, prev, w)
            for j, i in enumerate(rows):
                if texts[j]:
                    parts[i].append(texts[j])
                prev[i] = ([int(t) for t in ids[j] if int(t) != eot], temps[j])
        return [" ".join(ps) for ps in parts]

    def _transcribe_seek(self, clips: list[np.ndarray]) -> list[str]:
        """The timestamp-seek long-form loop (upstream whisper.transcribe):
        each clip keeps its own ``seek``; a window advances to the last
        consecutive-timestamp-pair boundary it predicted, or by the whole
        window (``timestamp_seek``, which never returns a non-positive
        advance, so the loop ends). All clips still needing audio decode
        together; the conditioning context is the consumed text tokens."""
        from ..models.whisper import timestamp_seek

        parts: list[list[str]] = [[] for _ in clips]
        seek = [0] * len(clips)
        prev: list[tuple[list[int], float] | None] = [None] * len(clips)
        pending = list(range(len(clips)))  # every clip decodes >= 1 window
        w = 0
        while pending:
            rows = pending
            stack = np.stack([self._pad_or_trim(clips[i][seek[i]: seek[i] + self.chunk])
                              for i in rows])
            _, ids, temps = self._fallback(stack, rows, prev, w)
            pending = []
            for j, i in enumerate(rows):
                advance, text_ids = timestamp_seek(self.cfg, ids[j])
                txt = self.detokenize(text_ids).upper().strip() if text_ids else ""
                if txt:
                    parts[i].append(txt)
                prev[i] = (text_ids, temps[j])
                seek[i] += advance
                if seek[i] < len(clips[i]):
                    pending.append(i)
            w += 1
        return [" ".join(ps) for ps in parts]

    def transcribe(self, examples: Sequence[AsrExample], batch_size: int = 8) -> dict[str, str]:
        """path -> transcript for a dataset (the reference's per-file loop,
        batched)."""
        out: dict[str, str] = {}
        for i in range(0, len(examples), batch_size):
            chunk = examples[i: i + batch_size]
            for e, t in zip(chunk, self.transcribe_batch([e.array for e in chunk])):
                out[e.path] = t
        return out
