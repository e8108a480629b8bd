"""CTC prefix beam search with optional shallow LM fusion (the port's
``ops/beam.py``: a copy of the JAX package's numpy module, with the
``native/libdacsbeam.so`` binding through the port's ``utils/native.py``).

The reference decodes greedily everywhere (argmax + collapse,
federated/src/update.py:162-212 ``map_to_result``); greedy stays this
framework's default and parity path (ops/decode.py). This module adds the
standard production upgrade: prefix beam search (Hannun et al. 2014) over
the CTC posterior, with an optional character-LM shallow-fusion hook
(``score = log P_ctc + alpha * log P_lm + beta * |prefix|``).

Runs on the host over the device-computed log-posteriors — decode is not
the hot path (V=32 vocab, ~10^3 frames), and the ragged beam state is
host-shaped work; the device's job ends at the fused log_softmax. Beams are
advanced with numpy-vectorized scoring over (beam x vocab).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from ..utils.native import load_native_lib

NEG_INF = -np.inf


def _logsumexp2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.logaddexp(a, b)


@dataclass
class BeamHypothesis:
    ids: tuple[int, ...]
    log_prob: float       # total CTC log-probability (blank + non-blank)
    lm_log_prob: float    # accumulated LM component (0 when no LM)

    @property
    def score(self) -> float:
        return self.log_prob + self.lm_log_prob


# Beam state: prefix -> (p_b, p_nb, lm) with p_b / p_nb the log-prob of
# the prefix with the last frame being blank / non-blank. The recursion is
# purely sequential over frames, so the state can be checkpointed at any
# frame boundary and advanced later — the streaming path
# (serving/streaming.py) carries one such state over its FINALIZED frames
# and re-runs only the partial tail each pass.
BeamState = dict


def ctc_beam_init() -> BeamState:
    """Empty-prefix beam state (decode position 0)."""
    return {(): (0.0, NEG_INF, 0.0)}


def ctc_beam_advance(
    log_probs: np.ndarray,
    beams: BeamState,
    beam_size: int = 16,
    blank_id: int = 0,
    lm_fn: Callable[[tuple[int, ...]], np.ndarray] | None = None,
    lm_alpha: float = 0.3,
    lm_beta: float = 0.0,
    prune_log_prob: float = -12.0,
) -> BeamState:
    """Advance a beam state over ``log_probs`` ([T', V]) frames; returns the
    new state (the input state is not mutated). Composition law (what the
    streaming bit-identity test relies on): advancing over [0, a) then
    [a, T) equals one advance over [0, T)."""
    T, V = log_probs.shape

    for t in range(T):
        frame = log_probs[t]
        keep = np.flatnonzero(frame >= frame.max() + prune_log_prob)
        next_beams: dict[tuple[int, ...], list[float]] = {}

        def add(prefix, p_b, p_nb, lm):
            cur = next_beams.get(prefix)
            if cur is None:
                next_beams[prefix] = [p_b, p_nb, lm]
            else:
                cur[0] = _logsumexp2(cur[0], p_b)
                cur[1] = _logsumexp2(cur[1], p_nb)
                # lm component is a function of the prefix alone — identical
                # for merged paths
                cur[2] = lm

        for prefix, (p_b, p_nb, lm) in beams.items():
            p_tot = _logsumexp2(p_b, p_nb)
            lm_next = None
            for v in keep:
                pv = float(frame[v])
                if v == blank_id:
                    add(prefix, p_tot + pv, NEG_INF, lm)
                    continue
                last = prefix[-1] if prefix else None
                if v == last:
                    # repeat: extends the prefix only via a blank gap
                    add(prefix, NEG_INF, p_nb + pv, lm)
                    new_lm = lm
                    if lm_fn is not None:
                        if lm_next is None:
                            lm_next = lm_fn(prefix)
                        new_lm = lm + lm_alpha * float(lm_next[v]) + lm_beta
                    add(prefix + (int(v),), NEG_INF, p_b + pv, new_lm)
                else:
                    new_lm = lm
                    if lm_fn is not None:
                        if lm_next is None:
                            lm_next = lm_fn(prefix)
                        new_lm = lm + lm_alpha * float(lm_next[v]) + lm_beta
                    add(prefix + (int(v),), NEG_INF, p_tot + pv, new_lm)

        scored = sorted(
            ((k, v) for k, v in next_beams.items()
             if _logsumexp2(v[0], v[1]) > NEG_INF),  # drop dead prefixes
            key=lambda kv: -(_logsumexp2(kv[1][0], kv[1][1]) + kv[1][2]))
        beams = {k: (v[0], v[1], v[2]) for k, v in scored[:beam_size]}
    return beams


def beam_state_hypotheses(beams: BeamState) -> list[BeamHypothesis]:
    """A beam state as sorted hypotheses (best first); hypothesis ids are
    the collapsed label sequence (no blanks, no repeats)."""
    out = [
        BeamHypothesis(ids=prefix,
                       log_prob=float(_logsumexp2(p_b, p_nb)),
                       lm_log_prob=float(lm))
        for prefix, (p_b, p_nb, lm) in beams.items()
    ]
    out.sort(key=lambda h: -h.score)
    return out


def ctc_prefix_beam_search(
    log_probs: np.ndarray,
    beam_size: int = 16,
    blank_id: int = 0,
    lm_fn: Callable[[tuple[int, ...]], np.ndarray] | None = None,
    lm_alpha: float = 0.3,
    lm_beta: float = 0.0,
    prune_log_prob: float = -12.0,
) -> list[BeamHypothesis]:
    """Decode one utterance's CTC posterior.

    Args:
      log_probs: [T, V] log-softmax scores over valid frames only.
      beam_size: number of prefixes kept per frame.
      blank_id: CTC blank (== pad, reference blank=pad_token_id).
      lm_fn: optional ``prefix_ids -> [V] log P(next | prefix)``; fused as
        ``alpha * lm + beta`` per emitted (non-blank, non-repeat) token.
      prune_log_prob: per-frame emission pruning threshold relative to the
        frame's best token (standard beam pruning; keeps V small).

    Returns the final beam sorted by fused score (best first).
    """
    return beam_state_hypotheses(ctc_beam_advance(
        log_probs, ctc_beam_init(), beam_size=beam_size, blank_id=blank_id,
        lm_fn=lm_fn, lm_alpha=lm_alpha, lm_beta=lm_beta,
        prune_log_prob=prune_log_prob))


def beam_search_batch(
    log_probs: np.ndarray,
    frame_lengths: Sequence[int],
    beam_size: int = 16,
    blank_id: int = 0,
    lm_fn=None,
    lm_alpha: float = 0.3,
    lm_beta: float = 0.0,
    backend: str = "auto",
) -> list[list[BeamHypothesis]]:
    """[B, T, V] log-posteriors (+ valid lengths) -> per-utterance beams.

    ``backend="auto"`` uses the native C++ decoder (native/beam.cpp) when
    it is available and the LM is absent or a :class:`CharBigramLM` (whose
    table ships across the ctypes boundary); arbitrary ``lm_fn`` callables
    and toolchain-less hosts fall back to the Python implementation.
    """
    use_native = (
        backend == "native"
        or (backend == "auto"
            and (lm_fn is None or isinstance(lm_fn, CharBigramLM))
            and native_available())
    )
    if use_native:
        return [
            [ctc_prefix_beam_search_native(
                np.asarray(log_probs[b, : int(frame_lengths[b])], np.float32),
                beam_size=beam_size, blank_id=blank_id, lm=lm_fn,
                lm_alpha=lm_alpha, lm_beta=lm_beta)]
            for b in range(len(frame_lengths))
        ]
    return [
        ctc_prefix_beam_search(
            np.asarray(log_probs[b, : int(frame_lengths[b])], np.float32),
            beam_size=beam_size, blank_id=blank_id, lm_fn=lm_fn,
            lm_alpha=lm_alpha, lm_beta=lm_beta)
        for b in range(len(frame_lengths))
    ]


# ---- native backend (native/beam.cpp via ctypes) ----


def _setup(lib) -> None:
    import ctypes

    lib.dacs_ctc_beam_search.restype = ctypes.c_long
    lib.dacs_ctc_beam_search.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
        ctypes.POINTER(ctypes.c_float)]


def _load_native():
    return load_native_lib("libdacsbeam.so", "beam.cpp", _setup)


def native_available() -> bool:
    """True when the C++ decoder is loadable (building it on demand)."""
    return _load_native() is not None


def ctc_prefix_beam_search_native(
    log_probs: np.ndarray,
    beam_size: int = 16,
    blank_id: int = 0,
    lm: "CharBigramLM | None" = None,
    lm_alpha: float = 0.3,
    lm_beta: float = 0.0,
    prune_log_prob: float = -12.0,
) -> BeamHypothesis:
    """C++ decoder (native/beam.cpp); semantics-identical to
    :func:`ctc_prefix_beam_search`'s top hypothesis (tested). The LM, when
    given, must be a :class:`CharBigramLM` (its table crosses the ctypes
    boundary); the returned hypothesis carries the fused score in
    ``log_prob`` (the blank/non-blank and LM split stays host-side only in
    the Python backend)."""
    import ctypes

    lib = _load_native()
    if lib is None:
        raise RuntimeError("native beam library unavailable")
    lp = np.ascontiguousarray(log_probs, np.float32)
    T, V = lp.shape
    lm_ptr = None
    if lm is not None:
        table = np.ascontiguousarray(lm._log_probs, np.float32)
        assert table.shape == (V + 1, V), "LM table must be (V+1, V)"
        lm_ptr = table.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    out = np.zeros(T, np.int32)
    score = ctypes.c_float()
    n = lib.dacs_ctc_beam_search(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, V,
        beam_size, blank_id, lm_ptr, lm_alpha, lm_beta,
        float(prune_log_prob),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), T,
        ctypes.byref(score))
    if n < 0:
        raise RuntimeError(f"native beam search failed (rc={n})")
    return BeamHypothesis(ids=tuple(int(i) for i in out[:n]),
                          log_prob=float(score.value), lm_log_prob=0.0)


class CharBigramLM:
    """Tiny additive-smoothed character bigram LM for shallow fusion —
    trainable from transcripts (e.g. the ADReSS train CSV), no external
    deps. ``log P(next | prefix)`` depends on the prefix's last token."""

    def __init__(self, vocab_size: int, smoothing: float = 1.0):
        self.vocab_size = vocab_size
        self.smoothing = float(smoothing)
        self.counts = np.zeros((vocab_size + 1, vocab_size), np.float64)
        # row vocab_size = sentence-start context

    def fit(self, sequences: Sequence[Sequence[int]]) -> "CharBigramLM":
        for seq in sequences:
            prev = self.vocab_size
            for v in seq:
                self.counts[prev, int(v)] += 1.0
                prev = int(v)
        c = self.counts + self.smoothing
        self._log_probs = np.log(c / c.sum(axis=1, keepdims=True))
        return self

    def __call__(self, prefix: tuple[int, ...]) -> np.ndarray:
        prev = prefix[-1] if prefix else self.vocab_size
        return self._log_probs[prev]
