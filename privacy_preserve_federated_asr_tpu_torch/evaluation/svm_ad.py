"""Downstream SVM AD prediction over extracted embeddings (the port's
``evaluation/svm_ad.py``; reference: centralized/pred_AD_svm.py).

Pipeline parity: pool each utterance's (optionally masked) hidden states
over time with min/max/mean/median; optionally fuse (concat) or replace
with session-level text embeddings; standard scaler + RBF SVC; **speaker-
level majority vote over PAR utterances** (vote > 0.5 -> AD); report
ACC/BACC/F1/Sens/Spec/UAR appended to a results CSV.

The JAX package calls scikit-learn; the port needs neither it nor pandas.
:func:`speaker_vote_metrics` computes the sklearn metrics in numpy, and
:class:`RbfSVC` is what ``sklearn.svm.SVC()`` computes for two classes
(C = 1, ``gamma="scale"`` = 1 / (n_features * X.var())), solved in torch on
the device: libsvm's dual SMO with its second-order working-set selection,
its two-variable update and its stopping rule (maximal violating pair gap
< 1e-3), in fp64 over the precomputed kernel matrix, and the intercept from
the free support vectors.
"""

from __future__ import annotations

import csv
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from ..serving.engine import resolve_device

POOLING = {"mean": np.mean, "min": np.min, "max": np.max, "median": np.median}


def _features(rows: Sequence[Mapping], pooling: str, masked: bool,
              text_embeddings: Mapping[str, np.ndarray] | None = None, mode: str = "audio"):
    """Pooled (optionally lm-masked) hidden states, or with ``mode`` "text"
    the row's session text embedding, or with "fusion" both concatenated;
    rows whose session has no text embedding are dropped in those modes.
    -> (features, AD labels, the rows kept)."""
    xs, ys, keep = [], [], []
    for r in rows:
        h = np.asarray(r["hidden_states"])
        if h.ndim == 3:  # reference keeps a leading batch dim of 1
            h = h[0]
        if masked:
            m = np.asarray(r["lm_mask"])
            if m.ndim == 3:
                m = m[0]
            h = h * m
        emb = POOLING[pooling](h, axis=0)
        if mode in ("fusion", "text"):
            session = r["path"].split("_")[0]
            if text_embeddings is None or session not in text_embeddings:
                continue
            t = np.asarray(text_embeddings[session])
            emb = np.concatenate([emb, t]) if mode == "fusion" else t
        xs.append(emb)
        ys.append(int(r["dementia_labels"]))
        keep.append(r)
    return np.stack(xs), np.asarray(ys), keep


def speaker_vote_metrics(paths: Sequence[str], preds: Sequence[int],
                         spk2label: Mapping[str, int]) -> dict[str, float]:
    """Majority vote per PAR speaker, then ACC/BACC/F1/Sens/Spec/UAR
    (reference: pred_AD_svm.py:231-268), each as the JAX package's sklearn
    call defines it: ``accuracy_score``, ``balanced_accuracy_score`` (mean
    recall over the classes in the truth), binary ``f1_score`` and
    ``recall_score`` of class 1, specificity from ``confusion_matrix(labels=
    [0, 1])``, and macro ``recall_score`` over the classes in truth or
    prediction; ``zero_division=0``."""
    votes: dict[str, list[int]] = {}
    for path, pred in zip(paths, preds):
        parts = path.split("_")
        if len(parts) > 1 and parts[1] == "PAR":
            votes.setdefault(parts[0], []).append(int(pred))
    true = np.asarray([int(spk2label[spk]) for spk in votes], dtype=np.int64)
    pred = np.asarray([1 if sum(vs) / len(vs) > 0.5 else 0 for vs in votes.values()],
                      dtype=np.int64)

    def count(t: int, p: int) -> int:
        return int(np.sum((true == t) & (pred == p)))

    def recall(label: int) -> float:
        support = int(np.sum(true == label))
        return count(label, label) / support if support else 0.0

    tp, fp, fn, tn = count(1, 1), count(0, 1), count(1, 0), count(0, 0)
    labels = np.union1d(true, pred)
    return {
        "ACC": float(np.mean(true == pred)),
        "BACC": float(np.mean([recall(c) for c in labels if np.any(true == c)])),
        "F1": 2 * tp / (2 * tp + fp + fn) if tp + fp + fn else 0.0,
        "Sens": recall(1),
        "Spec": tn / max(tn + fp, 1),
        "UAR": float(np.mean([recall(c) for c in labels])),
    }


def standard_scale(x_train: torch.Tensor, x_test: torch.Tensor):
    """sklearn's ``StandardScaler().fit(x_train)`` applied to both: centre
    and divide by the population std, with a scale of 1 for features whose
    variance is within rounding of zero (``_is_constant_feature``)."""
    n = x_train.shape[0]
    mean = x_train.mean(0)
    var = x_train.var(0, correction=0)
    eps = torch.finfo(torch.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = torch.where(constant, torch.ones_like(var), var.sqrt())
    return (x_train - mean) / scale, (x_test - mean) / scale


def _rbf(a: torch.Tensor, b: torch.Tensor, gamma: float) -> torch.Tensor:
    d2 = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist") ** 2
    return torch.exp(-gamma * d2)


def _last_argmax(v: torch.Tensor) -> torch.Tensor:
    """One-element index of the last maximum (libsvm's ``>=`` scans keep
    the last)."""
    return (v.numel() - 1 - torch.argmax(v.flip(0))).view(1)


class RbfSVC:
    """``sklearn.svm.SVC()`` for labels {0, 1}, solved in torch on the device
    of its inputs (module docstring). As in libsvm (and sklearn, which sorts
    the classes), class 0 is the solver's +1 and the decision value is
    negated, so ``decision_function > 0`` means class 1."""

    TAU = 1e-12        # libsvm's floor of a non-positive curvature
    CHECK_EVERY = 64   # SMO steps between two reads of the stop flag

    def __init__(self, C: float = 1.0, tol: float = 1e-3):
        self.C, self.tol = C, tol

    def fit(self, x: torch.Tensor, y: torch.Tensor) -> "RbfSVC":
        x = x.to(torch.float64)
        if set(torch.unique(y).tolist()) != {0, 1}:
            raise ValueError("RbfSVC needs labels 0 and 1, both present")
        var = x.var(correction=0).item()
        self.gamma = 1.0 / (x.shape[1] * var) if var != 0 else 1.0
        ys = torch.where(y == 0, 1.0, -1.0).to(x)
        alpha, rho, self.n_iter = self._solve(_rbf(x, x, self.gamma), ys)
        sv = alpha > 0
        self.support_vectors = x[sv]
        self.dual_coef = (alpha * ys)[sv]
        self.rho = rho
        return self

    def decision_function(self, x: torch.Tensor) -> torch.Tensor:
        k = _rbf(x.to(torch.float64), self.support_vectors, self.gamma)
        return -(k @ self.dual_coef - self.rho)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        # libsvm votes class 0 only for a positive solver decision, so 0 -> 1
        return (self.decision_function(x) >= 0).to(torch.int64)

    def _solve(self, k: torch.Tensor, y: torch.Tensor):
        """libsvm's ``Solver::Solve`` without shrinking: returns (alpha,
        rho, updates made). Every step stays on the device; a done flag
        freezes the state once the stopping rule holds, read every
        ``CHECK_EVERY`` steps."""
        n, c = y.numel(), self.C
        q = y[:, None] * y[None, :] * k
        qd = torch.diagonal(q)
        alpha = torch.zeros_like(y)
        grad = -torch.ones_like(y)
        done = torch.zeros((), dtype=torch.bool, device=y.device)
        neg_inf = torch.tensor(-torch.inf, dtype=y.dtype, device=y.device)
        updates = torch.zeros((), dtype=torch.int64, device=y.device)
        max_iter = max(10_000_000, 100 * n)
        for _ in range(0, max_iter, self.CHECK_EVERY):
            for _ in range(self.CHECK_EVERY):
                done = self._step(q, qd, y, alpha, grad, done, c, neg_inf)
                updates += ~done
            if done.item():
                break
        return alpha, self._rho(y, alpha, grad), int(updates)

    def _step(self, q, qd, y, alpha, grad, done, c, neg_inf):
        """One SMO step in place (``select_working_set`` and the update of
        ``Solver::Solve``); a no-op once ``done``. Returns the new flag. The
        pair (i, j) and its scalars stay one-element tensors: no step waits
        for the host."""
        pos = y > 0
        up = torch.where(pos, alpha < c, alpha > 0)     # not at the bound y pushes to
        low = torch.where(pos, alpha > 0, alpha < c)
        yg = y * grad
        i = _last_argmax(torch.where(up, -yg, neg_inf))
        q_i = q.index_select(0, i)[0]
        g_max = -yg.gather(0, i)
        g_max2 = torch.where(low, yg, neg_inf).max()
        grad_diff = g_max + yg
        quad = qd.gather(0, i) + qd - 2.0 * y.gather(0, i) * y * q_i
        quad = torch.where(quad > 0, quad, torch.full_like(quad, self.TAU))
        cand = low & (grad_diff > 0)
        obj = torch.where(cand, -grad_diff * grad_diff / quad, -neg_inf)
        j = _last_argmax(-obj)
        q_j = q.index_select(0, j)[0]
        done = done | (g_max + g_max2 < self.tol).squeeze(0) | ~cand.any()

        ai, aj, gi, gj = alpha.gather(0, i), alpha.gather(0, j), grad.gather(0, i), grad.gather(0, j)
        qii, qjj, qij = qd.gather(0, i), qd.gather(0, j), q_i.gather(0, j)
        zero = torch.zeros_like(ai)
        # y_i != y_j: alpha_i - alpha_j is kept
        quad1 = qii + qjj + 2 * qij
        quad1 = torch.where(quad1 > 0, quad1, torch.full_like(quad1, self.TAU))
        delta = (-gi - gj) / quad1
        diff = ai - aj
        a1i, a1j = ai + delta, aj + delta
        cut = (diff > 0) & (a1j < 0)
        a1i, a1j = torch.where(cut, diff, a1i), torch.where(cut, zero, a1j)
        cut = (diff <= 0) & (a1i < 0)
        a1i, a1j = torch.where(cut, zero, a1i), torch.where(cut, -diff, a1j)
        cut = (diff > 0) & (a1i > c)
        a1i, a1j = torch.where(cut, zero + c, a1i), torch.where(cut, c - diff, a1j)
        cut = (diff <= 0) & (a1j > c)
        a1i, a1j = torch.where(cut, c + diff, a1i), torch.where(cut, zero + c, a1j)
        # y_i == y_j: alpha_i + alpha_j is kept
        quad2 = qii + qjj - 2 * qij
        quad2 = torch.where(quad2 > 0, quad2, torch.full_like(quad2, self.TAU))
        delta = (gi - gj) / quad2
        total = ai + aj
        a2i, a2j = ai - delta, aj + delta
        cut = (total > c) & (a2i > c)
        a2i, a2j = torch.where(cut, zero + c, a2i), torch.where(cut, total - c, a2j)
        cut = (total <= c) & (a2j < 0)
        a2i, a2j = torch.where(cut, total, a2i), torch.where(cut, zero, a2j)
        cut = (total > c) & (a2j > c)
        a2i, a2j = torch.where(cut, total - c, a2i), torch.where(cut, zero + c, a2j)
        cut = (total <= c) & (a2i < 0)
        a2i, a2j = torch.where(cut, zero, a2i), torch.where(cut, total, a2j)

        same = y.gather(0, i) == y.gather(0, j)
        new_i = torch.where(done, ai, torch.where(same, a2i, a1i))
        new_j = torch.where(done, aj, torch.where(same, a2j, a1j))
        grad += q_i * (new_i - ai) + q_j * (new_j - aj)
        alpha.index_put_((i,), new_i)
        alpha.index_put_((j,), new_j)
        return done

    def _rho(self, y, alpha, grad) -> torch.Tensor:
        """libsvm's ``calculate_rho``: the mean of y*G over the free
        variables, else the midpoint of the bounds' range."""
        yg = y * grad
        upper, lower = alpha >= self.C, alpha <= 0
        free = ~upper & ~lower
        pos = y > 0
        ub = torch.where((upper & ~pos) | (lower & pos), yg, torch.inf).min()
        lb = torch.where((upper & pos) | (lower & ~pos), yg, -torch.inf).max()
        n_free = free.sum()
        return torch.where(n_free > 0, (yg * free).sum() / n_free.clamp_min(1),
                           (ub + lb) / 2)


def predict_ad_svm(
    train_rows: Sequence[Mapping],
    test_rows: Sequence[Mapping],
    spk2label: Mapping[str, int],
    pooling: str = "min",
    masked: bool = False,
    mode: str = "audio",            # audio | text | fusion
    text_embeddings_train: Mapping[str, np.ndarray] | None = None,
    text_embeddings_test: Mapping[str, np.ndarray] | None = None,
    par_only: bool = True,
    results_csv: str | None = None,
    title: str = "dacs_tpu",
    device: str | torch.device = "cuda",
) -> dict[str, float]:
    """The JAX ``predict_ad_svm`` with the scaler and the SVC in torch on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if par_only:  # reference default: train/test on participant utts only
        train_rows = [r for r in train_rows if "PAR" in r["path"]]
        test_rows = [r for r in test_rows if "PAR" in r["path"]]

    x_train, y_train, _ = _features(train_rows, pooling, masked, text_embeddings_train, mode)
    x_test, _, test_rows = _features(test_rows, pooling, masked, text_embeddings_test, mode)
    x_train, x_test = standard_scale(
        *(torch.from_numpy(x).to(device, torch.float64) for x in (x_train, x_test)))
    svm = RbfSVC().fit(x_train, torch.from_numpy(y_train).to(device))
    preds = svm.predict(x_test).cpu().numpy()

    metrics = speaker_vote_metrics([r["path"] for r in test_rows], preds, spk2label)
    if results_csv is not None:
        os.makedirs(os.path.dirname(results_csv) or ".", exist_ok=True)
        exists = os.path.exists(results_csv)
        with open(results_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["model"] + list(metrics))
            if not exists:
                w.writeheader()
            w.writerow({"model": f"{title} spkid-wise", **metrics})
    return metrics
