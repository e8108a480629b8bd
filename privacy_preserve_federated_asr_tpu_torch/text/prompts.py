"""Prompt / privacy library (reference: centralized/prompts.py).

The reference ships three artifacts:
  * ``Sensitive_replace_dict`` — per-speaker rewrites of privacy-sensitive
    utterances applied before sending session text to an external LLM.
    Those rewrites are *dataset-derived privacy data*; hardcoding them in a
    public repo defeats their purpose, so here the dict ships empty and is
    loaded from a JSON sidecar kept with the (access-controlled) dataset —
    same mechanism, safer packaging.
  * ``Psychology_template`` — clinical-linguistics feature definitions with
    examples, used as few-shot context for LLM session assessment.
  * assessment / instruction prompt templates for session summarization.

A copy of ``privacy_preserve_federated_asr_tpu/text/prompts.py``: the port
imports nothing of the JAX package, not even its stdlib/numpy modules.
"""

from __future__ import annotations

import json
import re
from typing import Mapping

# speaker -> ordered [(original utterance, privacy-safe rewrite), ...]
# (the reference's native shape; a plain mapping also works); load from the
# dataset sidecar via load_sensitive_dict (see module docstring).
SENSITIVE_REPLACE_DICT: dict[str, object] = {}

# Clinical-linguistics feature definitions (the reference's
# Psychology_template keys) used as few-shot assessment context.
PSYCHOLOGY_TEMPLATE: dict[str, str] = {
    "anomia": (
        "Difficulty retrieving words, often surfacing as circumlocution "
        "('the thing you write with'), empty words ('thing', 'stuff'), or "
        "long word-finding pauses."),
    "disfluency": (
        "Interruptions in the flow of speech: filled pauses (uh, um), "
        "repetitions, self-corrections, and abandoned sentence fragments."),
    "agrammatism": (
        "Simplified or incorrect grammar: omitted function words, wrong "
        "tense or agreement, reduced sentence complexity."),
    "semantic_paraphasia": (
        "Substituting a semantically related but incorrect word, e.g. "
        "saying 'stove' for 'sink'."),
    "perseveration": (
        "Repeating the same word, phrase, or idea beyond the point where "
        "it is relevant."),
    "tangentiality": (
        "Drifting away from the topic or question without returning to it; "
        "reduced topic maintenance."),
    "empty_speech": (
        "Fluent speech that conveys little information: high proportion of "
        "pronouns and generic terms relative to content words."),
}


def load_sensitive_dict(path: str) -> dict[str, object]:
    """Load per-speaker sensitive-utterance rewrites from a JSON sidecar and
    install them as the module-level dict. Entries may be the reference's
    list-of-pairs shape or a plain {original: replacement} mapping."""
    with open(path) as f:
        loaded = json.load(f)
    SENSITIVE_REPLACE_DICT.clear()
    SENSITIVE_REPLACE_DICT.update(loaded)
    return SENSITIVE_REPLACE_DICT


def apply_sensitive_replacements(
    session_id: str,
    text: str,
    table: Mapping[str, object] | None = None,
) -> str:
    """Replace privacy-sensitive utterances for one session's document.

    Per-session entries may be an ordered list of (original, replacement)
    pairs — the reference's native ``Sensitive_replace_dict`` shape, applied
    as sequential ``str.replace`` (0207_DM_Extact_dataAugmentation.py:105-108)
    — or a {original: replacement} mapping."""
    table = SENSITIVE_REPLACE_DICT if table is None else table
    entries = table.get(session_id, ())
    pairs = entries.items() if hasattr(entries, "items") else entries
    for original, replacement in pairs:
        text = text.replace(original, replacement)
    return text


def _template_block(features: Mapping[str, str] | None = None) -> str:
    features = PSYCHOLOGY_TEMPLATE if features is None else features
    return "\n".join(f"- {name}: {desc}" for name, desc in features.items())


def summary_prompt(session_text: str) -> str:
    """Session-summarization instruction (reference
    0207_DM_SessionLvlSummary.py prompt assembly): summarize the picture-
    description interview, preserving speech characteristics relevant to
    cognitive assessment."""
    return (
        "You are given the transcript of a picture-description interview "
        "between an investigator (INV) and a participant (PAR).\n"
        "Summarize the PARTICIPANT's speech in a few sentences, focusing on "
        "language characteristics relevant to cognitive assessment, such "
        "as:\n"
        f"{_template_block()}\n\n"
        "Transcript:\n"
        f"{session_text}\n\n"
        "Summary:")


def assessment_prompt(session_text: str) -> str:
    """Feature-assessment instruction: rate the presence of each clinical
    linguistic feature in the participant's speech."""
    return (
        "Assess the PARTICIPANT's speech in the transcript below for each "
        "of the following clinical linguistic features. For each feature, "
        "answer 'present' or 'absent' with one short justification.\n\n"
        f"Features:\n{_template_block()}\n\n"
        "Transcript:\n"
        f"{session_text}\n\n"
        "Assessment:")


_WS = re.compile(r"\s+")


def extractive_summary(session_text: str, max_sentences: int = 3) -> str:
    """Offline fallback "LLM": keep the longest PAR utterances (a crude
    extractive summary so the pipeline runs without an external API)."""
    par_lines = [l[len("PAR:"):].strip() for l in session_text.splitlines()
                 if l.startswith("PAR:")]
    par_lines.sort(key=len, reverse=True)
    return _WS.sub(" ", ". ".join(par_lines[:max_sentences]))
