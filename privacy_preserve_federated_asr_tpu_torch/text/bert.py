"""BERT encoder in PyTorch + WordPiece tokenizer (the port's ``text/bert.py``).

The reference's text branch embeds transcripts with HF BERT-family models
(mBERT, clinical/bio BERTs, XLM; reference:
centralized/Dementia_challenge_models.py:246-303 ``_setup_embedding`` /
``_get_embedding``). :class:`BertEncoder` is the JAX package's flax encoder
(post-LN transformer, exact GELU, a ``-1e9`` key-mask bias on fp32 scores,
the pooled ``tanh`` output of token 0) under HF ``BertModel`` names, so an HF
state dict loads with ``strict=True`` (:func:`port_hf_bert`). Dropout is
drawn from an explicit ``torch.Generator``. Attention runs as plain torch
ops, as the JAX package's einsums; neither flash kernel is on this path.
:class:`WordPieceTokenizer` is a copy of the JAX package's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class BertConfigT:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def tiny_for_tests(cls):
        return cls(vocab_size=200, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=64)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``Dropout``: keep with probability ``1 - rate``, scale by
    ``1 / (1 - rate)``; identity without a generator (deterministic)."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter from ``generator`` (flax's initializers in
    shape): normal(0, 1/sqrt(fan_in)) for matrices and embedding tables
    (fan_in = the last axis), zero biases, unit LayerNorm scales."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                p.copy_(torch.empty(p.shape, device=generator.device).normal_(
                    0.0, p.shape[-1] ** -0.5, generator=generator))
    return module


class _Named(nn.Module):
    """A container whose children are given by name (HF's nesting)."""

    def __init__(this, /, **children: nn.Module):
        super().__init__()
        for k, v in children.items():
            this.add_module(k, v)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfigT):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.attention = _Named(
            self=_Named(query=nn.Linear(d, d), key=nn.Linear(d, d), value=nn.Linear(d, d)),
            output=_Named(dense=nn.Linear(d, d), LayerNorm=nn.LayerNorm(d, eps=eps)))
        self.intermediate = _Named(dense=nn.Linear(d, cfg.intermediate_size))
        self.output = _Named(dense=nn.Linear(cfg.intermediate_size, d),
                             LayerNorm=nn.LayerNorm(d, eps=eps))

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None,
                generator: torch.Generator | None) -> torch.Tensor:
        c = self.cfg
        h = c.num_attention_heads
        d = c.hidden_size // h
        att = self.attention
        q = att.self.query(x).unflatten(-1, (h, d)).transpose(1, 2) * d ** -0.5
        k = att.self.key(x).unflatten(-1, (h, d)).transpose(1, 2)
        v = att.self.value(x).unflatten(-1, (h, d)).transpose(1, 2)
        scores = q.float() @ k.float().transpose(-1, -2)
        if bias is not None:
            scores = scores + bias
        probs = dropout(torch.softmax(scores, dim=-1).to(x.dtype), c.attention_dropout,
                        generator)
        ctx = (probs @ v).transpose(1, 2).flatten(2)
        attn_out = dropout(att.output.dense(ctx), c.hidden_dropout, generator)
        x = att.output.LayerNorm(x + attn_out)
        inter = F.gelu(self.intermediate.dense(x))
        out = dropout(self.output.dense(inter), c.hidden_dropout, generator)
        return self.output.LayerNorm(x + out)


class BertEncoder(nn.Module):
    """HF ``BertModel`` (``embeddings``, ``encoder.layer.{i}``, ``pooler``):
    ``(input_ids, attention_mask) -> (sequence [B, T, D], pooled [B, D])``;
    dropout only when a ``generator`` is given."""

    def __init__(self, cfg: BertConfigT):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        emb = [nn.Embedding(n, d) for n in (cfg.vocab_size, cfg.max_position_embeddings,
                                            cfg.type_vocab_size)]
        self.embeddings = _Named(word_embeddings=emb[0], position_embeddings=emb[1],
                                 token_type_embeddings=emb[2],
                                 LayerNorm=nn.LayerNorm(d, eps=cfg.layer_norm_eps))
        self.encoder = _Named(layer=nn.ModuleList(BertLayer(cfg)
                                                  for _ in range(cfg.num_hidden_layers)))
        self.pooler = _Named(dense=nn.Linear(d, d))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                token_type_ids: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        e = self.embeddings
        t = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(t, device=input_ids.device)[None, :]
        x = e.LayerNorm(e.word_embeddings(input_ids) + e.position_embeddings(pos)
                        + e.token_type_embeddings(token_type_ids))
        x = dropout(x, self.cfg.hidden_dropout, generator)
        bias = None
        if attention_mask is not None:
            bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0, -1e9)
        for layer in self.encoder.layer:
            x = layer(x, bias, generator)
        return x, torch.tanh(self.pooler.dense(x[:, 0]))


def port_hf_bert(state_dict: Mapping, cfg: BertConfigT, prefix: str = "") -> dict:
    """An HF torch ``BertModel`` state dict (keys under ``prefix``) -> the
    :class:`BertEncoder` state dict (fp32 CPU tensors; keys the encoder
    does not have, such as ``position_ids`` or heads, are not read)."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    with torch.device("meta"):
        want = list(BertEncoder(cfg).state_dict())
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"checkpoint is not a BertModel state dict: missing {missing[:5]}")
    return {k: torch.as_tensor(sd[k]).detach().to("cpu", torch.float32) for k in want}


def state_dict_from_flax_bert(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's flax ``BertEncoder`` params -> the HF-named state
    dict (the inverse of its ``port_hf_bert``; for the tests)."""
    def t(x, transpose=False):
        x = np.asarray(x, np.float32)
        return torch.from_numpy(np.ascontiguousarray(x.T if transpose else x))

    def dense(p):
        return t(p["kernel"], True), t(p["bias"])

    def ln(p):
        return t(p["scale"]), t(p["bias"])

    sd = {"embeddings.word_embeddings.weight": t(params["word_embeddings"]["embedding"]),
          "embeddings.position_embeddings.weight":
              t(params["position_embeddings"]["embedding"]),
          "embeddings.token_type_embeddings.weight":
              t(params["token_type_embeddings"]["embedding"])}
    names = {"embeddings.LayerNorm": ("embeddings_layer_norm", ln),
             "pooler.dense": ("pooler", dense)}
    n = sum(k.startswith("layer_") for k in params)
    for i in range(n):
        b = f"encoder.layer.{i}."
        for hf, fl, fn in (("attention.self.query", "query", dense),
                           ("attention.self.key", "key", dense),
                           ("attention.self.value", "value", dense),
                           ("attention.output.dense", "attention_output", dense),
                           ("attention.output.LayerNorm", "attention_layer_norm", ln),
                           ("intermediate.dense", "intermediate", dense),
                           ("output.dense", "output", dense),
                           ("output.LayerNorm", "output_layer_norm", ln)):
            names[b + hf] = (f"layer_{i}/{fl}", fn)
    for hf, (fl, fn) in names.items():
        node = params
        for part in fl.split("/"):
            node = node[part]
        sd[f"{hf}.weight"], sd[f"{hf}.bias"] = fn(node)
    return sd


def _basic_split(text: str, lowercase: bool) -> list[str]:
    if lowercase:
        text = text.lower()
    out, word = [], []
    for ch in text:
        if ch.isalnum() or ch == "'":
            word.append(ch)
        else:
            if word:
                out.append("".join(word))
                word = []
            if not ch.isspace():
                out.append(ch)
    if word:
        out.append("".join(word))
    return out


class WordPieceTokenizer:
    """Greedy longest-match WordPiece (BERT-style), loading a standard
    vocab.txt (one token per line, ## continuations)."""

    def __init__(self, vocab: dict[str, int] | list[str], lowercase: bool = True,
                 cls_token="[CLS]", sep_token="[SEP]", pad_token="[PAD]",
                 unk_token="[UNK]"):
        if isinstance(vocab, list):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab = vocab
        self.lowercase = lowercase
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.unk_id = vocab[unk_token]

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        with open(path) as f:
            return cls([line.rstrip("\n") for line in f], **kw)

    @classmethod
    def from_corpus(cls, texts, max_vocab: int = 8000, lowercase: bool = True,
                    **kw) -> "WordPieceTokenizer":
        """Whole-word vocab built from a corpus (degenerate WordPiece: no
        ## continuations, OOV -> [UNK]): the fine-tune path runs with no
        pretrained vocab.txt asset."""
        from collections import Counter

        counts: Counter = Counter()
        for t in texts:
            counts.update(_basic_split(str(t), lowercase))
        specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
        words = [w for w, _ in counts.most_common(max_vocab - len(specials))]
        return cls(specials + words, lowercase=lowercase, **kw)

    def _split(self, text: str) -> list[str]:
        return _basic_split(text, self.lowercase)

    def _wordpiece(self, word: str) -> list[int]:
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_length: int = 512,
               pad_to: int | None = None) -> tuple[list[int], list[int]]:
        """-> (input_ids, attention_mask) with [CLS] ... [SEP] framing."""
        ids = [self.cls_id]
        for word in self._split(text):
            ids.extend(self._wordpiece(word))
        ids = ids[: max_length - 1] + [self.sep_id]
        mask = [1] * len(ids)
        if pad_to is not None:
            ids = ids + [self.pad_id] * (pad_to - len(ids))
            mask = mask + [0] * (pad_to - len(mask))
        return ids, mask
