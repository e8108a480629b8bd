"""Straight-through Gumbel-softmax sampling (the port's ``ops/gumbel.py``).

Matches the JAX package's ``gumbel_softmax`` and, through it, the
reference's custom one (federated/src/models.py:75-129):

  * gumbels ~ Gumbel(0, 1); perturbed logits ``(logits + g) / tau``,
  * soft sample = softmax over ``dim``,
  * hard sample = one-hot(argmax of soft, first index on ties) with the
    straight-through trick ``y_hard - y_soft.detach() + y_soft``.

The noise is either injected (parity tests hand both packages the same
numpy draw) or drawn from an explicit ``torch.Generator`` as
``-log(Exponential(1))``, the reference's torch recipe. That recipe can give
``+inf`` when the exponential sample is 0, so the ``clip(-1e9, 1e9)`` guard
of the JAX version is kept.
"""

from __future__ import annotations

import torch


def sample_gumbel(shape, generator: torch.Generator,
                  device: torch.device | str) -> torch.Tensor:
    """Gumbel(0, 1) noise in fp32 from ``generator`` (on ``device``)."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return -e.exponential_(generator=generator).log()


def gumbel_softmax(logits: torch.Tensor, noise: torch.Tensor, tau: float = 1.0,
                   hard: bool = False, dim: int = -1) -> torch.Tensor:
    """Gumbel-softmax sample shaped like ``logits`` for the Gumbel(0, 1)
    ``noise`` of the same shape; one-hot along ``dim`` if ``hard``."""
    gumbels = noise.to(torch.float32).clamp(-1e9, 1e9)
    y = (logits.to(torch.float32) + gumbels) / tau
    y_soft = torch.softmax(y, dim=dim)
    if not hard:
        return y_soft.to(logits.dtype)
    index = torch.argmax(y_soft, dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    ret = y_hard - y_soft.detach() + y_soft
    return ret.to(logits.dtype)
