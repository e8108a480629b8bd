"""Session text assembly (reference: centralized/Extract_Session_text.py:
50-120): parse utterance filenames ``<session>_<role>_<number>_<start>_<end>
.wav`` into (session, role, number, start, end), group transcripts by
session, filter by role, sort by start time, and concatenate "ROLE: text"
lines into one session document.

A copy of ``privacy_preserve_federated_asr_tpu/text/session.py``: the port
imports nothing of the JAX package, not even its stdlib/numpy modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Mapping, Sequence


@dataclass
class SessionUtterance:
    session: str
    role: str          # INV | PAR
    number: int
    start: int
    end: int
    text: str


def parse_path(path: str) -> tuple[str, str, int, int, int]:
    """``S001_PAR_12_3400_5600.wav`` -> (S001, PAR, 12, 3400, 5600).

    Tolerates shorter name forms (missing number/start/end -> 0).
    """
    stem = Path(path).stem
    parts = stem.split("_")
    session = parts[0]
    role = parts[1] if len(parts) > 1 else "PAR"

    def _int(i):
        try:
            return int(parts[i])
        except (IndexError, ValueError):
            return 0

    return session, role, _int(2), _int(3), _int(4)


def assemble_sessions(
    rows: Iterable[Mapping],
    roles: Sequence[str] = ("INV", "PAR"),
    text_key: str = "text",
    include_role_tag: bool = True,
) -> dict[str, str]:
    """rows with path + transcript -> {session: document}.

    Utterances are sorted by start time within each session and joined as
    "ROLE: text" lines (the reference's session document format).
    """
    grouped: dict[str, list[SessionUtterance]] = {}
    for r in rows:
        session, role, number, start, end = parse_path(r["path"])
        if role not in roles:
            continue
        text = (r.get(text_key) or "").strip()
        if not text:
            continue
        grouped.setdefault(session, []).append(
            SessionUtterance(session, role, number, start, end, text))
    docs = {}
    for session, utts in grouped.items():
        utts.sort(key=lambda u: (u.start, u.number))
        if include_role_tag:
            docs[session] = "\n".join(f"{u.role}: {u.text}" for u in utts)
        else:
            docs[session] = "\n".join(u.text for u in utts)
    return docs
