"""Character-level CTC tokenizer, bit-compatible with HF Wav2Vec2CTCTokenizer.

The reference tokenizes uppercase transcripts with the processor of
``facebook/data2vec-audio-large-960h`` (reference: federated/src/utils.py:40-50
``prepare_dataset``), whose vocab is the standard 32-token English CTC vocab
shared by the wav2vec2/data2vec/hubert *-960h checkpoints. Decoding performs
CTC collapse (group repeated tokens, then drop pad) exactly like
``Wav2Vec2CTCTokenizer.decode`` so WERs are comparable.

A copy of ``privacy_preserve_federated_asr_tpu/data/tokenizer.py``: the port
imports nothing of the JAX package, not even its numpy-only modules.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass, field
from pathlib import Path

# Vocab of facebook/wav2vec2-base-960h / data2vec-audio-*-960h (vocab.json).
DEFAULT_ENGLISH_CTC_VOCAB: dict[str, int] = {
    "<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "E": 5, "T": 6,
    "A": 7, "O": 8, "N": 9, "I": 10, "H": 11, "S": 12, "R": 13, "D": 14,
    "L": 15, "U": 16, "M": 17, "W": 18, "C": 19, "F": 20, "G": 21, "Y": 22,
    "P": 23, "B": 24, "V": 25, "K": 26, "'": 27, "X": 28, "J": 29, "Q": 30,
    "Z": 31,
}


@dataclass
class CTCCharTokenizer:
    """Char tokenizer with CTC-collapse decoding.

    Attributes:
      vocab: token -> id. ``word_delimiter`` ("|") stands for space.
      pad_token: doubles as the CTC blank (the reference passes
        ``blank=config.pad_token_id`` to ctc_loss).
    """

    vocab: dict[str, int] = field(default_factory=lambda: dict(DEFAULT_ENGLISH_CTC_VOCAB))
    pad_token: str = "<pad>"
    unk_token: str = "<unk>"
    word_delimiter: str = "|"

    def __post_init__(self):
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.pad_id = self.vocab[self.pad_token]
        self.unk_id = self.vocab[self.unk_token]
        self.delimiter_id = self.vocab[self.word_delimiter]

    @classmethod
    def from_vocab_json(cls, path: str | Path) -> "CTCCharTokenizer":
        with open(path) as f:
            return cls(vocab=json.load(f))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> list[int]:
        """Uppercase transcript -> label ids; spaces become the delimiter."""
        tokens = text.replace(" ", self.word_delimiter)
        return [self.vocab.get(ch, self.unk_id) for ch in tokens]

    def decode(self, ids, group_tokens: bool = True) -> str:
        """CTC decode: collapse repeats, drop pad, join, "|" -> space.

        Matches Wav2Vec2CTCTokenizer: grouping happens *before* pad removal,
        so pad acts as a separator between repeated characters.
        """
        ids = [int(i) for i in ids]
        if group_tokens:
            ids = [k for k, _ in itertools.groupby(ids)]
        chars = [self.id_to_token[i] for i in ids if i != self.pad_id]
        text = "".join(
            " " if c == self.word_delimiter else c
            for c in chars
            if c not in ("<s>", "</s>")
        )
        return text.strip()

    def batch_decode(self, batch_ids) -> list[str]:
        return [self.decode(ids) for ids in batch_ids]
