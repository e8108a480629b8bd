"""How far a served transcript lies from the reference's best path.

The engine returns text, not per-frame ids. Every CTC path whose collapse
gives that text is a way the served tokens could have come out; at each
frame the served token lies some gap below the reference's best logit
there. The number compared is the smallest, over those paths, of the
widest such gap: 0 when the reference's greedy path gives the same text,
small where a near-tie flipped, large where the text is wrong.

Decoding as the serving tokenizer does it: repeats collapse before the
blank-like tokens (``<pad>``, ``<s>``, ``</s>``) are dropped, ``|`` is a
space, and leading and trailing spaces are stripped, so the path may spend
frames on blank-like tokens or ``|`` before the first and after the last
character.
"""

from __future__ import annotations

import numpy as np

INFEASIBLE = 1e9


def text_ids(text: str, vocab: list[str]) -> list[int]:
    """A served transcript as token ids (space -> ``|``; ``<unk>`` whole)."""
    index = {tok: i for i, tok in enumerate(vocab)}
    out, i = [], 0
    while i < len(text):
        if text.startswith("<unk>", i):
            out.append(index["<unk>"])
            i += 5
            continue
        ch = "|" if text[i] == " " else text[i]
        if ch not in index:
            return [-1]
        out.append(index[ch])
        i += 1
    return out


def min_max_gap(logits: np.ndarray, labels: list[int], blank_like: tuple[int, ...],
                delimiter: int, total: bool = False, over: float | None = None) -> float:
    """Min over the paths that decode to ``labels`` of the max per-frame gap
    ``max(logits[t]) - logits[t, token_t]``; ``logits`` is ``[T, V]``. With
    ``total`` the path's gaps are summed instead (its mean over frames is
    the sum over ``T``); with ``over`` too, its frames whose gap exceeds
    ``over`` are counted."""
    logits = np.asarray(logits, np.float64)
    t_n = logits.shape[0]
    if any(lab < 0 for lab in labels) or t_n == 0:
        return INFEASIBLE
    gap = logits.max(1, keepdims=True) - logits
    if over is not None:
        gap = (gap > over).astype(np.float64)
    g_blank = gap[:, list(blank_like)].min(1)
    g_edge = np.minimum(g_blank, gap[:, delimiter])
    n = len(labels)
    if n == 0:
        return float(g_edge.sum() if total else g_edge.max())
    # states: edge-before, then (label j, blank after j) pairs, edge-after
    s_n = 2 * n + 2
    emit = np.empty((t_n, s_n))
    emit[:, 0] = g_edge
    emit[:, 1:2 * n:2] = gap[:, labels]
    emit[:, 2:2 * n + 1:2] = g_blank[:, None]
    emit[:, -1] = g_edge
    skip = np.zeros(s_n, bool)  # s-2 -> s allowed
    for j in range(1, n):
        skip[2 * j + 1] = labels[j] != labels[j - 1]
    skip[-1] = True  # last label -> edge-after
    cost = np.full(s_n, np.inf)
    cost[:2] = emit[0, :2]
    for t in range(1, t_n):
        best = cost.copy()
        np.minimum(best[1:], cost[:-1], out=best[1:])
        best[2:] = np.where(skip[2:], np.minimum(best[2:], cost[:-2]), best[2:])
        cost = best + emit[t] if total else np.maximum(best, emit[t])
    end = min(cost[2 * n - 1], cost[2 * n], cost[2 * n + 1])
    return float(end) if np.isfinite(end) else INFEASIBLE
