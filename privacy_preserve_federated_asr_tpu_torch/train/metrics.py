"""Word error rate, self-contained (jiwer is not available in this image;
the reference itself vendors jiwer's ``compute_measures`` in
centralized/detail_wer.py:88-241). Standard Levenshtein alignment on
whitespace-tokenized words, returning H/S/D/I counts compatible with the
reference's detailed WER reports.

A copy of ``privacy_preserve_federated_asr_tpu/train/metrics.py`` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ErrorCounts:
    hits: int
    substitutions: int
    deletions: int
    insertions: int

    @property
    def n_ref(self) -> int:
        return self.hits + self.substitutions + self.deletions

    @property
    def wer(self) -> float:
        n = self.n_ref
        if n == 0:
            return 0.0 if self.insertions == 0 else float("inf")
        return (self.substitutions + self.deletions + self.insertions) / n

    def __add__(self, other: "ErrorCounts") -> "ErrorCounts":
        return ErrorCounts(
            self.hits + other.hits,
            self.substitutions + other.substitutions,
            self.deletions + other.deletions,
            self.insertions + other.insertions,
        )


def word_error_counts(reference: str, hypothesis: str) -> ErrorCounts:
    """Levenshtein-aligned H/S/D/I counts between two transcripts."""
    ref = reference.split()
    hyp = hypothesis.split()
    r, h = len(ref), len(hyp)
    # dp[i, j] = (cost, hits, subs, dels, ins) minimal-cost alignment
    cost = np.zeros((r + 1, h + 1), dtype=np.int32)
    cost[:, 0] = np.arange(r + 1)
    cost[0, :] = np.arange(h + 1)
    for i in range(1, r + 1):
        for j in range(1, h + 1):
            sub = cost[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            cost[i, j] = min(sub, cost[i - 1, j] + 1, cost[i, j - 1] + 1)
    # backtrack
    i, j = r, h
    hits = subs = dels = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] == hyp[j - 1]:
                hits += 1
            else:
                subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and cost[i, j] == cost[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return ErrorCounts(hits, subs, dels, ins)


def wer(references: list[str], hypotheses: list[str]) -> float:
    """Corpus-level WER: total (S+D+I) / total reference words — the
    aggregation ``datasets.load_metric("wer")`` / jiwer uses (reference:
    federated/src/update.py:38-50 ``compute_metrics``)."""
    total = ErrorCounts(0, 0, 0, 0)
    for ref, hyp in zip(references, hypotheses):
        total = total + word_error_counts(ref, hyp)
    return total.wer
