"""Loss library of the DACS objective family (the port's ``ops/losses.py``).

fp32 internally, with the JAX package's numerics (and through it the
reference's):

  * ``recall_family_loss``  — RecallLoss: soft recall / precision / F1 and
    their weighted ``1 - metric`` forms (federated/src/models.py:187-260)
  * ``am_softmax_loss``     — AngularPenaltySMLoss, cosface s=30 m=0.4 by
    default (federated/src/models.py:131-185). The reference "normalizes" the
    fc weight in a loop that rebinds a local name and so never normalizes W;
    only x is normalized. Reproduced (``normalize_weight=False``).
  * ``cross_entropy_loss``  — torch ``nn.CrossEntropyLoss`` (mean)
  * ``fsm_attention_loss``  — the FSM mask-decorrelation loss
    (centralized/Models.py:56-74)
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

RECALL_LOSS_KINDS = ("cel", "recall", "prec", "f1", "recall_ori", "prec_ori")


def _weighted_mean(x: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    """Mean, or sample-weighted mean when ``w`` [N] is given (it broadcasts
    on the leading batch axis; it drops the rows padding out a batch)."""
    if w is None:
        return x.mean()
    w = w.to(x.dtype)
    while w.dim() < x.dim():
        w = w[..., None]
    return (x * w).sum() / torch.broadcast_to(w, x.shape).sum().clamp_min(1e-9)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       sample_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch; logits [N, C], labels [N]."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return _weighted_mean(nll, sample_weight)


def recall_family_loss(logits: torch.Tensor, labels: torch.Tensor, kind: str,
                       weight: Sequence[float] | None,
                       sample_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Soft recall / precision / F1 losses for imbalanced classification, or
    cross-entropy for ``kind="cel"``. With pt = softmax(logits), onehot the
    labels and w the class weights normalised to sum 1 (C classes):
    recall = (pt*onehot + 1e-5) / (onehot + 1e-5), prec = (pt*onehot +
    1e-5) / (pt + 1e-5), f1 = 2rp / (r + p); "recall"/"prec" are
    mean((1 - metric) w C), "f1" and the "*_ori" kinds 1 - mean(metric w C)."""
    if kind == "cel":
        return cross_entropy_loss(logits, labels, sample_weight)
    if kind not in RECALL_LOSS_KINDS:
        raise ValueError(f"unknown AD loss kind: {kind!r}")
    logits = logits.float()
    c = logits.shape[1]
    pt = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), c).float()
    tp = pt * onehot
    recall = (tp + 1e-5) / (onehot + 1e-5)
    precision = (tp + 1e-5) / (pt + 1e-5)
    f1 = 2.0 * recall * precision / (recall + precision)
    if weight is None:
        w = torch.full((c,), 1.0 / c, device=logits.device)
    else:
        w = torch.tensor(list(weight), dtype=torch.float32, device=logits.device)
        w = w / w.sum()
    wc = w[None, :] * c
    if kind == "recall":
        return _weighted_mean((1.0 - recall) * wc, sample_weight)
    if kind == "prec":
        return _weighted_mean((1.0 - precision) * wc, sample_weight)
    metric = {"f1": f1, "recall_ori": recall, "prec_ori": precision}[kind]
    return 1.0 - _weighted_mean(metric * wc, sample_weight)


def _safe_normalize(v: torch.Tensor) -> torch.Tensor:
    # the clamp sits inside the rsqrt, so an all-zero row (a padded batch
    # row) gets zero gradients rather than inf/NaN
    return v * torch.rsqrt((v * v).sum(1, keepdim=True).clamp_min(1e-24))


def am_softmax_loss(x: torch.Tensor, labels: torch.Tensor, fc_weight: torch.Tensor,
                    loss_type: str = "cosface", s: float | None = None,
                    m: float | None = None, eps: float = 1e-7,
                    normalize_weight: bool = False,
                    sample_weight: torch.Tensor | None = None):
    """Angular-penalty softmax ("diversity") loss of embeddings x [N, D]
    with class ids ``labels`` [N] against the bias-free projection
    ``fc_weight`` [C, D] (torch layout). Returns ``(loss, wf [N, C])`` like
    the reference's ``(-mean(L), wf)``."""
    defaults = {"arcface": (64.0, 0.5), "sphereface": (64.0, 1.35), "cosface": (30.0, 0.4)}
    if loss_type not in defaults:
        raise ValueError(f"unknown loss_type: {loss_type!r}")
    s = defaults[loss_type][0] if s is None else s
    m = defaults[loss_type][1] if m is None else m
    w = fc_weight.float()
    if normalize_weight:
        w = _safe_normalize(w)
    wf = _safe_normalize(x.float()) @ w.T
    labels = labels.long()
    target = wf.gather(1, labels[:, None])[:, 0]
    if loss_type == "cosface":
        numerator = s * (target - m)
    elif loss_type == "arcface":
        numerator = s * torch.cos(torch.acos(target.clamp(-1.0 + eps, 1.0 - eps)) + m)
    else:  # sphereface
        numerator = s * torch.cos(m * torch.acos(target.clamp(-1.0 + eps, 1.0 - eps)))
    onehot = F.one_hot(labels, wf.shape[1]).float()
    excl = (torch.exp(s * wf) * (1.0 - onehot)).sum(1)
    denominator = torch.exp(numerator) + excl
    loss = -_weighted_mean(numerator - torch.log(denominator), sample_weight)
    return loss, wf


def fsm_attention_loss(lm_masks: torch.Tensor, ad_masks: torch.Tensor,
                       frame_mask: torch.Tensor | None = None,
                       eps: float = 1e-6) -> torch.Tensor:
    """Mask-decorrelation loss: mean over the batch of
    ``||[[0, s12], [s21, 0]]||_F`` with s12 = s21 the cosine similarity of
    the time-averaged lm and AD masks ``[B, T, D]``, so ``sqrt(2) * |cos|``.
    ``frame_mask`` [B, T] restricts the time average to valid frames; the
    reference (batch size 1) averages over all frames."""
    lm, ad = lm_masks.float(), ad_masks.float()
    if frame_mask is None:
        lm_mean, ad_mean = lm.mean(1), ad.mean(1)
    else:
        fm = frame_mask.float()[:, :, None]
        denom = fm.sum(1).clamp_min(1.0)
        lm_mean, ad_mean = (lm * fm).sum(1) / denom, (ad * fm).sum(1) / denom
    num = (lm_mean * ad_mean).sum(-1)
    cos = num / (torch.linalg.vector_norm(lm_mean, dim=-1)
                 * torch.linalg.vector_norm(ad_mean, dim=-1)).clamp_min(eps)
    return torch.sqrt(2.0 * cos * cos).mean()
