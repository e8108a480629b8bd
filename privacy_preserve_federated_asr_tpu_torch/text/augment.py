"""LLM-based text data augmentation (reference:
centralized/0207_DM_Extact_dataAugmentation.py): generate k paraphrased
copies of each session document via an LLM prompt (with sensitive-text
replacement applied first), carrying the session's labels over to the
augmented copies named ``{session}_aug{i}``.

The LLM is a plain callable; the offline fallback shuffles utterance order
(label-preserving) so pipelines run without an external API.

A copy of ``privacy_preserve_federated_asr_tpu/text/augment.py``: the port
imports nothing of the JAX package, not even its stdlib/numpy modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np

from .prompts import apply_sensitive_replacements


def augmentation_prompt(dialogue_content: str) -> str:
    return (
        "Paraphrase the following interview transcript. Keep the speaker "
        "tags (INV/PAR), the meaning, and the participant's speech "
        "characteristics (hesitations, repetitions, word-finding "
        "difficulties) intact, but vary the wording.\n\n"
        f"Transcript:\n{dialogue_content}\n\nParaphrased transcript:")


def _offline_paraphrase(text: str, rng: np.random.Generator) -> str:
    lines = text.splitlines()
    if len(lines) > 2:  # keep first/last, shuffle the middle lightly
        mid = lines[1:-1]
        rng.shuffle(mid)
        lines = [lines[0], *mid, lines[-1]]
    return "\n".join(lines)


@dataclass
class SessionAugmenter:
    llm_fn: Callable[[str], str] | None = None
    sensitive_table: Mapping[str, Mapping[str, str]] | None = None
    seed: int = 0

    def augment_sessions(
        self,
        docs: Mapping[str, str],
        labels: Mapping[str, int],
        k: int = 1,
    ) -> tuple[dict[str, str], dict[str, int], list[str]]:
        """-> (augmented docs {session_augI: text}, their labels, failures)."""
        rng = np.random.default_rng(self.seed)
        out_docs: dict[str, str] = {}
        out_labels: dict[str, int] = {}
        failures: list[str] = []
        for session, text in docs.items():
            safe = apply_sensitive_replacements(session, text, self.sensitive_table)
            for i in range(k):
                name = f"{session}_aug{i}"
                try:
                    if self.llm_fn is None:
                        new_text = _offline_paraphrase(safe, rng)
                    else:
                        new_text = self.llm_fn(augmentation_prompt(safe)).strip()
                except Exception:
                    failures.append(session)
                    continue
                out_docs[name] = new_text
                out_labels[name] = labels[session]
        return out_docs, out_labels, failures
