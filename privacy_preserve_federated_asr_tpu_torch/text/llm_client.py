"""HTTP LLM client adapters (OpenAI / Azure OpenAI chat + embeddings).

The reference integrates Azure OpenAI through LangChain for session
summarization with few-shot prompting and for text embeddings
(centralized/0207_DM_SessionLvlSummary.py:70-120 ``AzureChatOpenAI`` /
``RAG_chatbot``; :356-381 embeddings). Here the same capability is a thin
stdlib-``urllib`` client with retry/backoff — no SDK dependency, so it
works in this container and is unit-testable against a local stub server.

Both clients are plain callables, slotting directly into
``SessionSummarizer.llm_fn`` and ``RAGSummarizer.embed_fn``
(text/summarize.py). Configuration is explicit (no env-var magic);
privacy-sensitive replacement still happens BEFORE text reaches these
(summarize.py applies it pre-prompt).

A copy of ``privacy_preserve_federated_asr_tpu/text/llm_client.py``: the port
imports nothing of the JAX package, not even its stdlib/numpy modules.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

RETRYABLE_STATUS = {429, 500, 502, 503, 504}


@dataclass
class LLMClientConfig:
    """Connection + decoding settings for an OpenAI-schema endpoint.

    ``api_type="azure"`` uses the Azure URL layout
    (``{endpoint}/openai/deployments/{model}/...?api-version=...`` with an
    ``api-key`` header, like the reference's AzureChatOpenAI setup);
    ``"openai"`` uses ``{endpoint}/v1/...`` with a Bearer token.
    """

    endpoint: str                      # e.g. https://myres.openai.azure.com
    api_key: str = ""
    model: str = "gpt-4"               # deployment name under azure
    api_type: str = "azure"            # "azure" | "openai"
    api_version: str = "2023-05-15"    # azure query param
    temperature: float = 0.0
    max_tokens: int | None = 512
    timeout: float = 60.0
    max_retries: int = 4
    backoff: float = 1.0               # seconds; doubles per retry
    system_prompt: str | None = None
    # (user, assistant) example pairs prepended to every chat request —
    # the reference's few-shot prompting
    few_shot: Sequence[tuple[str, str]] = field(default_factory=tuple)
    embedding_model: str = "text-embedding-ada-002"


class _HTTPJSON:
    """POST JSON with retries/backoff shared by both clients."""

    def __init__(self, cfg: LLMClientConfig):
        self.cfg = cfg

    def _headers(self) -> dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.cfg.api_type == "azure":
            h["api-key"] = self.cfg.api_key
        else:
            h["Authorization"] = f"Bearer {self.cfg.api_key}"
        return h

    def post(self, url: str, payload: Mapping[str, Any]) -> dict:
        data = json.dumps(payload).encode()
        delay = self.cfg.backoff
        last_err: Exception | None = None
        for attempt in range(self.cfg.max_retries + 1):
            req = urllib.request.Request(
                url, data=data, headers=self._headers(), method="POST")
            try:
                with urllib.request.urlopen(req, timeout=self.cfg.timeout) as r:
                    return json.loads(r.read().decode())
            except urllib.error.HTTPError as e:
                last_err = e
                if e.code not in RETRYABLE_STATUS or attempt == self.cfg.max_retries:
                    raise
                retry_after = e.headers.get("Retry-After")
                sleep = float(retry_after) if retry_after else delay
            except (urllib.error.URLError, TimeoutError, ConnectionError) as e:
                last_err = e
                if attempt == self.cfg.max_retries:
                    raise
                sleep = delay
            time.sleep(sleep)
            delay *= 2
        raise RuntimeError(f"unreachable; last error: {last_err}")


class OpenAIChatClient(_HTTPJSON):
    """``client(prompt) -> str`` — a drop-in ``llm_fn``.

    Builds a chat-completions request with the configured system prompt and
    few-shot (user, assistant) pairs, mirroring the reference's LangChain
    few-shot template (0207_DM_SessionLvlSummary.py:70-120).
    """

    def _url(self) -> str:
        c = self.cfg
        base = c.endpoint.rstrip("/")
        if c.api_type == "azure":
            return (f"{base}/openai/deployments/{c.model}/chat/completions"
                    f"?api-version={c.api_version}")
        return f"{base}/v1/chat/completions"

    def _messages(self, prompt: str) -> list[dict[str, str]]:
        msgs: list[dict[str, str]] = []
        if self.cfg.system_prompt:
            msgs.append({"role": "system", "content": self.cfg.system_prompt})
        for user, assistant in self.cfg.few_shot:
            msgs.append({"role": "user", "content": user})
            msgs.append({"role": "assistant", "content": assistant})
        msgs.append({"role": "user", "content": prompt})
        return msgs

    def __call__(self, prompt: str) -> str:
        payload: dict[str, Any] = {
            "messages": self._messages(prompt),
            "temperature": self.cfg.temperature,
        }
        if self.cfg.api_type != "azure":
            payload["model"] = self.cfg.model
        if self.cfg.max_tokens is not None:
            payload["max_tokens"] = self.cfg.max_tokens
        out = self.post(self._url(), payload)
        return out["choices"][0]["message"]["content"]


class OpenAIEmbeddingsClient(_HTTPJSON):
    """``client(texts) -> np.ndarray [N, D]`` — a drop-in ``embed_fn``
    (reference embeddings usage, 0207_DM_SessionLvlSummary.py:356-381)."""

    def _url(self) -> str:
        c = self.cfg
        base = c.endpoint.rstrip("/")
        if c.api_type == "azure":
            return (f"{base}/openai/deployments/{c.embedding_model}/embeddings"
                    f"?api-version={c.api_version}")
        return f"{base}/v1/embeddings"

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        payload: dict[str, Any] = {"input": list(texts)}
        if self.cfg.api_type != "azure":
            payload["model"] = self.cfg.embedding_model
        out = self.post(self._url(), payload)
        rows = sorted(out["data"], key=lambda r: r.get("index", 0))
        return np.asarray([r["embedding"] for r in rows], dtype=np.float32)


def make_llm_fn(cfg: LLMClientConfig) -> OpenAIChatClient:
    return OpenAIChatClient(cfg)


def make_embed_fn(cfg: LLMClientConfig) -> OpenAIEmbeddingsClient:
    return OpenAIEmbeddingsClient(cfg)
