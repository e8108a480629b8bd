"""Detailed WER breakdowns (reference: centralized/detail_wer.py:88-361).

Levels (reference CLI ``-t {1,2,3}``):
  1 — overall WER,
  2 — groups HC-all / HC-INV / HC-PAR / AD(-PAR),
  3 — AD speakers banded by MMSE: [30-25], [24-21], [20-10], [9-0].

Counts come from :mod:`..train.metrics` (our Levenshtein H/S/D/I — the
reference vendors jiwer's compute_measures for the same numbers).

A copy of ``privacy_preserve_federated_asr_tpu/evaluation/detail_wer.py``
over the port's ``train/metrics.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence

from ..train.metrics import ErrorCounts, word_error_counts

MMSE_BANDS: tuple[tuple[int, int, str], ...] = (
    (25, 30, "MMSE 30-25"),
    (21, 24, "MMSE 24-21"),
    (10, 20, "MMSE 20-10"),
    (0, 9, "MMSE 9-0"),
)


def _speaker(path: str) -> str:
    return path.split("_")[0]


def _role(path: str) -> str:
    parts = path.split("_")
    return parts[1] if len(parts) > 1 else "PAR"


def _accumulate(rows) -> dict:
    total = ErrorCounts(0, 0, 0, 0)
    for r in rows:
        total = total + word_error_counts(r["text"], r["pred_str"])
    return {
        "n_utts": len(rows),
        "hits": total.hits,
        "substitutions": total.substitutions,
        "deletions": total.deletions,
        "insertions": total.insertions,
        "wer": total.wer,
    }


def detailed_wer_report(
    rows: Sequence[Mapping],
    level: int = 2,
    id2mmse: Mapping[str, float] | None = None,
    out_dir: str | None = None,
) -> dict[str, dict]:
    """rows: dicts with path / text / pred_str / dementia_labels.

    Returns {group_name: {wer, hits, substitutions, deletions, insertions,
    n_utts}} and optionally writes one txt per group (reference behavior).
    """
    rows = [r for r in rows if r.get("text")]
    groups: dict[str, list] = {"overall": list(rows)}
    if level >= 2:
        groups["HC_all"] = [r for r in rows if r["dementia_labels"] == 0]
        groups["HC_INV"] = [r for r in rows
                            if r["dementia_labels"] == 0 and _role(r["path"]) == "INV"]
        groups["HC_PAR"] = [r for r in rows
                            if r["dementia_labels"] == 0 and _role(r["path"]) == "PAR"]
        groups["AD"] = [r for r in rows if r["dementia_labels"] == 1]
    if level >= 3:
        if id2mmse is None:
            raise ValueError("level 3 needs the speaker->MMSE lookup")
        ad_rows = [r for r in rows if r["dementia_labels"] == 1]
        for lo, hi, name in MMSE_BANDS:
            groups[name] = [
                r for r in ad_rows
                if _speaker(r["path"]) in id2mmse
                and lo <= float(id2mmse[_speaker(r["path"])]) <= hi
            ]

    report = {name: _accumulate(rs) for name, rs in groups.items()}
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        for name, stats in report.items():
            lines = [f"{k}: {v}" for k, v in stats.items()]
            (Path(out_dir) / f"{name}.txt").write_text("\n".join(lines) + "\n")
    return report
