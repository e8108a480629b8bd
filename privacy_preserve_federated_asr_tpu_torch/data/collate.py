"""Length-bucketed, statically-shaped batching for XLA.

The reference relies on HF dynamic padding + ``group_by_length``
(reference: federated/src/models.py:1006-1068 DataCollatorCTCWithPadding,
federated/src/update.py:434-464 TrainingArguments). Dynamic shapes force an
XLA recompile per shape, so here utterances are sorted by length, grouped
into batches, and each batch padded up to *quantized* (time, label) bucket
boundaries — the number of distinct compiled shapes is bounded by the
bucket grid, and padding waste stays small because each batch is built from
a length-sorted view.

Labels are padded with -100 (HF convention, masked out of the CTC loss).

A copy of ``privacy_preserve_federated_asr_tpu/data/collate.py`` (the port
imports nothing of the JAX package). The port keeps the bucketing: it bounds
the shapes the card sees, and the trainer's steps run at the same shapes as
the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from .dataset import AsrExample

LABEL_PAD = -100


@dataclass
class Batch:
    """One statically-shaped training/eval batch (host numpy)."""

    input_values: np.ndarray      # [B, T] float32, zero-padded
    input_lengths: np.ndarray     # [B] int32 valid sample counts
    labels: np.ndarray            # [B, L] int32, LABEL_PAD-padded
    label_lengths: np.ndarray     # [B] int32
    dementia_labels: np.ndarray   # [B] int32
    sample_mask: np.ndarray       # [B] float32; 0 for rows padding out a short batch
    paths: list[str]

    @property
    def attention_mask(self) -> np.ndarray:
        t = self.input_values.shape[1]
        return (np.arange(t)[None, :] < self.input_lengths[:, None]).astype(np.int32)


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def pad_batch(
    examples: Sequence[AsrExample],
    time_multiple: int = 16000,
    label_multiple: int = 32,
    pad_to_size: int | None = None,
) -> Batch:
    """Pad a group of prepared examples to quantized static shapes."""
    bsz = pad_to_size or len(examples)
    t_max = _round_up(max(len(e.input_values) for e in examples), time_multiple)
    has_labels = examples[0].labels is not None
    l_max = (
        _round_up(max(len(e.labels) for e in examples), label_multiple)
        if has_labels
        else label_multiple
    )

    input_values = np.zeros((bsz, t_max), dtype=np.float32)
    input_lengths = np.zeros((bsz,), dtype=np.int32)
    labels = np.full((bsz, l_max), LABEL_PAD, dtype=np.int32)
    label_lengths = np.zeros((bsz,), dtype=np.int32)
    dementia = np.zeros((bsz,), dtype=np.int32)
    sample_mask = np.zeros((bsz,), dtype=np.float32)
    sample_mask[: len(examples)] = 1.0
    paths = []
    for i, e in enumerate(examples):
        iv = e.input_values
        input_values[i, : len(iv)] = iv
        input_lengths[i] = len(iv)
        if has_labels:
            labels[i, : len(e.labels)] = e.labels
            label_lengths[i] = len(e.labels)
        dementia[i] = e.dementia_label
        paths.append(e.path)
    return Batch(
        input_values, input_lengths, labels, label_lengths, dementia, sample_mask, paths
    )


class LengthBucketBatcher:
    """Length-sorted batching with shuffled batch order per epoch.

    TPU-friendly replacement for ``group_by_length``: batches are built over
    a length-sorted view (minimal padding), then the *batch order* is
    shuffled each epoch so optimization still sees random length mixes.
    """

    def __init__(
        self,
        examples: Sequence[AsrExample],
        batch_size: int,
        time_multiple: int = 16000,
        label_multiple: int = 32,
        seed: int = 0,
        drop_last: bool = False,
        max_samples: int | None = None,
        shuffle_window: int | None = None,
    ):
        """``shuffle_window``: when set, batch *membership* reshuffles each
        epoch HF-LengthGroupedSampler-style — examples are permuted, locally
        sorted by length within windows of ``batch_size * shuffle_window``,
        then batched. None keeps fixed length-sorted membership (fewest
        compiled shapes)."""
        examples = [
            e for e in examples if max_samples is None or len(e.input_values) <= max_samples
        ]
        order = np.argsort([len(e.input_values) for e in examples], kind="stable")
        self._sorted = [examples[i] for i in order]
        self.batch_size = batch_size
        self.time_multiple = time_multiple
        self.label_multiple = label_multiple
        self.drop_last = drop_last
        self.shuffle_window = shuffle_window
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self._sorted)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def examples(self) -> list[AsrExample]:
        """Canonical (filtered, length-sorted) example order — the index
        space of :meth:`epoch_indices`."""
        return self._sorted

    def _epoch_groups(self, epoch_seed: int | None) -> Iterator[list[int]]:
        """Shuffled batch groups as indices into ``self.examples``."""
        rng0 = (np.random.default_rng(epoch_seed)
                if epoch_seed is not None else self._rng)
        n = len(self._sorted)
        if self.shuffle_window:
            pool = list(rng0.permutation(n))
            win = self.batch_size * self.shuffle_window
            order: list[int] = []
            for i in range(0, n, win):
                chunk = pool[i : i + win]
                chunk.sort(key=lambda j: len(self._sorted[j].input_values))
                order.extend(chunk)
        else:
            order = list(range(n))
        groups = [
            order[i : i + self.batch_size]
            for i in range(0, n, self.batch_size)
        ]
        if self.drop_last and groups and len(groups[-1]) < self.batch_size:
            groups = groups[:-1]
        for gi in rng0.permutation(len(groups)):
            yield groups[gi]

    def epoch(self, epoch_seed: int | None = None) -> Iterator[Batch]:
        """Yield padded batches in shuffled order."""
        for group in self._epoch_groups(epoch_seed):
            yield pad_batch(
                [self._sorted[j] for j in group],
                time_multiple=self.time_multiple,
                label_multiple=self.label_multiple,
                pad_to_size=self.batch_size,
            )

    def epoch_indices(self, epoch_seed: int | None = None) -> Iterator[list[int]]:
        """Same batch composition/order as :meth:`epoch`, but as indices into
        ``self.examples``, padded to ``batch_size`` with -1 (masked rows).
        Used by the device-resident federated data path."""
        for group in self._epoch_groups(epoch_seed):
            yield group + [-1] * (self.batch_size - len(group))
