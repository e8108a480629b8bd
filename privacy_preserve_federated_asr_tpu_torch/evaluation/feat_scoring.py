"""Mask statistics (reference: centralized/feat_scoring.py), vectorized.

The reference triple-loops python over utterances x nodes computing, per
hidden node: mutual-exclusion rate (lm vs AD mask disagree over time),
sklearn mutual information, per-stream on-rates, and both-on rate — then
averages over utterances. Here each per-utterance pass is one vectorized
numpy computation over [T, D].

A copy of ``privacy_preserve_federated_asr_tpu/evaluation/feat_scoring.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def _mask(r: Mapping, key: str) -> np.ndarray:
    m = np.asarray(r[key])
    return m[0] if m.ndim == 3 else m  # drop the reference's batch dim


def mask_node_statistics(rows: Sequence[Mapping]) -> dict[str, np.ndarray]:
    """Per-node statistics averaged over utterances.

    Returns dict of [D] arrays: mex_rate, mutual_info, lm_on_rate,
    ad_on_rate, rate_11 (both-on).
    """
    first = _mask(rows[0], "lm_mask")
    d = first.shape[1]
    acc = {k: np.zeros(d) for k in
           ("mex_rate", "mutual_info", "lm_on_rate", "ad_on_rate", "rate_11")}
    for r in rows:
        lm = _mask(r, "lm_mask")          # [T, D]
        ad = _mask(r, "dementia_mask")    # [T, D]
        t = lm.shape[0]
        n11 = np.sum((lm == 1) & (ad == 1), axis=0).astype(np.float64)
        n10 = np.sum((lm == 1) & (ad == 0), axis=0).astype(np.float64)
        n01 = np.sum((lm == 0) & (ad == 1), axis=0).astype(np.float64)
        n00 = np.sum((lm == 0) & (ad == 0), axis=0).astype(np.float64)

        acc["mex_rate"] += (n10 + n01) / t
        acc["lm_on_rate"] += (n11 + n10) / t
        acc["ad_on_rate"] += (n11 + n01) / t
        acc["rate_11"] += n11 / t

        # MI = sum_{xy} p(x,y) log(p(x,y) / (p(x)p(y))), natural log
        mi = np.zeros(d)
        pa1 = (n11 + n10) / t
        pb1 = (n11 + n01) / t
        for nxy, px, py in ((n11, pa1, pb1), (n10, pa1, 1 - pb1),
                            (n01, 1 - pa1, pb1), (n00, 1 - pa1, 1 - pb1)):
            p = nxy / t
            with np.errstate(divide="ignore", invalid="ignore"):
                term = p * np.log(p / np.maximum(px * py, 1e-300))
            mi += np.where(p > 0, term, 0.0)
        acc["mutual_info"] += mi
    n = len(rows)
    return {k: v / n for k, v in acc.items()}


def per_utt_on_rates(rows: Sequence[Mapping]) -> dict[str, np.ndarray]:
    """Per-utterance mask on-rates (reference feat_scoring.py:97-117):
    mean over time of each frame's node-on fraction."""
    lm_rates, ad_rates = [], []
    for r in rows:
        lm = _mask(r, "lm_mask")
        ad = _mask(r, "dementia_mask")
        lm_rates.append(float(lm.mean()))
        ad_rates.append(float(ad.mean()))
    return {"lm_on_rate": np.asarray(lm_rates), "ad_on_rate": np.asarray(ad_rates)}
