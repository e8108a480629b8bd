"""Whisper token ids -> text, without ``transformers`` (the port's stand-in
for ``transformers.WhisperTokenizer.decode(ids, skip_special_tokens=True)``,
which the JAX package's ``cli teacher --whisper_hf`` calls).

A checkpoint directory's ``vocab.json`` maps byte-level BPE tokens to ids;
``added_tokens.json`` and ``tokenizer_config.json``'s ``added_tokens_decoder``
add tokens beside it (whisper's specials and timestamps), and the special
tokens are ``tokenizer_config.json``'s ``bos/eos/unk/pad_token`` and
``additional_special_tokens``, overridden by ``special_tokens_map.json``
(``from_pretrained``'s order; bos, eos and unk default to
``<|endoftext|>``). Decoding needs no merges. What ``decode`` does, in HF's
order:

  * a sequence opening with ``<|startofprev|>`` loses its prompt: it keeps
    what follows from ``<|startoftranscript|>`` on, or nothing;
  * special ids are dropped; the others become tokens (an added token's
    content, else the vocab's token, else "");
  * runs of vocab tokens are mapped through GPT-2's byte decoder and decoded
    as UTF-8 with ``errors="replace"``, each added token standing alone
    between runs;
  * timestamp tokens (``<|1.23|>``) are removed from the text.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Sequence

TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable unicode character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _content(tok) -> str | None:
    return tok.get("content") if isinstance(tok, dict) else tok


class WhisperDetokenizer:
    def __init__(self, vocab: dict[str, int], added: dict[str, int] | None = None,
                 special_tokens: Sequence[str] = ("<|endoftext|>",) * 3):
        """``special_tokens``: bos, eos, unk, then any further specials."""
        self._vocab = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.added_encoder = dict(added or {})
        self.added_decoder = {v: k for k, v in self.added_encoder.items()}
        self.unk_id = self.token_id(special_tokens[2] if len(special_tokens) > 2
                                    else "<|endoftext|>")
        self.special_ids = {self.token_id(t, self.unk_id) for t in special_tokens}
        self.byte_decoder = {c: b for b, c in bytes_to_unicode().items()}

    def token_id(self, token: str, default: int | None = None) -> int | None:
        """``convert_tokens_to_ids``: an added token first, then the vocab."""
        if token in self.added_encoder:
            return self.added_encoder[token]
        return self._vocab.get(token, default)

    @classmethod
    def from_pretrained(cls, path: str | Path) -> "WhisperDetokenizer":
        d = Path(path)

        def read(name):
            f = d / name
            return json.loads(f.read_text(encoding="utf-8")) if f.exists() else {}

        vocab = read("vocab.json")
        if not vocab:
            raise FileNotFoundError(f"{d / 'vocab.json'} is missing or empty")
        cfg, smap = read("tokenizer_config.json"), read("special_tokens_map.json")
        added = dict(read("added_tokens.json"))
        for idx, tok in (cfg.get("added_tokens_decoder") or {}).items():
            added.setdefault(_content(tok), int(idx))
        named = {k: "<|endoftext|>" for k in ("bos_token", "eos_token", "unk_token")}
        named["pad_token"] = None
        extra: list = []
        for src in (cfg, smap):
            for k in named:
                if k in src:
                    named[k] = _content(src[k])
            if "additional_special_tokens" in src:
                extra = [_content(t) for t in src["additional_special_tokens"]]
        specials = [t for t in [*named.values(), *extra] if t is not None]
        return cls(vocab, added, specials)

    def _bytes_text(self, tokens: list[str]) -> str:
        return bytearray(self.byte_decoder[c] for c in "".join(tokens)).decode(
            "utf-8", errors="replace")

    def decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids]
        if ids and ids[0] == self.token_id("<|startofprev|>", self.unk_id):
            sot = self.token_id("<|startoftranscript|>", self.unk_id)
            ids = ids[ids.index(sot):] if sot in ids else []
        parts, run = [], []
        for i in ids:
            if i in self.special_ids:
                continue
            token = self.added_decoder.get(i, self.decoder.get(i, ""))
            if token in self.added_encoder:
                if run:
                    parts.append(self._bytes_text(run))
                    run = []
                parts.append(token)
            else:
                run.append(token)
        if run:
            parts.append(self._bytes_text(run))
        return TIMESTAMP.sub("", "".join(parts))

    __call__ = decode
