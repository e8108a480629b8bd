"""LLM session summarization + similarity/RAG pipeline interface
(reference: centralized/0207_DM_SessionLvlSummary.py ``RAG_chatbot``
[Azure OpenAI via LangChain], 0207_DM_SentenceLvlRAGSummary.py,
0207_DM_SessionLvlSimilarityEmb.py).

The external LLM is behind a plain callable ``llm_fn(prompt) -> str`` —
production plugs any API client in; an offline extractive fallback keeps
the pipeline runnable in closed environments. Privacy-sensitive text
replacement happens *before* any prompt leaves the process.

A copy of ``privacy_preserve_federated_asr_tpu/text/summarize.py``: the port
imports nothing of the JAX package, not even its stdlib/numpy modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np

from .prompts import (
    apply_sensitive_replacements,
    extractive_summary,
    summary_prompt,
)


@dataclass
class SessionSummarizer:
    """Per-session summaries with sensitive-text replacement.

    ``llm_fn`` defaults to the offline extractive fallback.
    """

    llm_fn: Callable[[str], str] | None = None
    sensitive_table: Mapping[str, Mapping[str, str]] | None = None
    prompt_fn: Callable[[str], str] = field(default=summary_prompt)

    def summarize(self, session_id: str, session_text: str) -> str:
        safe_text = apply_sensitive_replacements(
            session_id, session_text, self.sensitive_table)
        if self.llm_fn is None:
            return extractive_summary(safe_text)
        return self.llm_fn(self.prompt_fn(safe_text)).strip()

    def summarize_sessions(self, docs: Mapping[str, str]) -> dict[str, str]:
        return {sid: self.summarize(sid, text) for sid, text in docs.items()}


def cosine_topk(
    query_emb: np.ndarray, corpus_embs: np.ndarray, k: int = 4
) -> list[int]:
    """Similarity retrieval for the RAG variant: top-k corpus entries by
    cosine similarity to the query embedding."""
    q = query_emb / max(np.linalg.norm(query_emb), 1e-12)
    c = corpus_embs / np.maximum(
        np.linalg.norm(corpus_embs, axis=1, keepdims=True), 1e-12)
    sims = c @ q
    return list(np.argsort(-sims)[:k])


@dataclass
class RAGSummarizer:
    """RAG variant: retrieve the k most similar reference sessions (by
    embedding) and include them as few-shot context in the prompt."""

    llm_fn: Callable[[str], str] | None
    embed_fn: Callable[[Sequence[str]], np.ndarray]
    corpus_texts: Sequence[str]
    corpus_summaries: Sequence[str]
    k: int = 2
    sensitive_table: Mapping[str, Mapping[str, str]] | None = None

    def __post_init__(self):
        self._corpus_embs = np.asarray(self.embed_fn(list(self.corpus_texts)))

    def summarize(self, session_id: str, session_text: str) -> str:
        safe_text = apply_sensitive_replacements(
            session_id, session_text, self.sensitive_table)
        q = np.asarray(self.embed_fn([safe_text]))[0]
        idx = cosine_topk(q, self._corpus_embs, self.k)
        shots = "\n\n".join(
            f"Transcript:\n{self.corpus_texts[i]}\nSummary: {self.corpus_summaries[i]}"
            for i in idx)
        prompt = (f"{shots}\n\n{summary_prompt(safe_text)}")
        if self.llm_fn is None:
            return extractive_summary(safe_text)
        return self.llm_fn(prompt).strip()
