"""Gradient Reversal Layer (the port's ``ops/grl.py``).

The reference's ``ReverseLayerF`` (federated/src/models.py:61-73) as a
``torch.autograd.Function``: identity in the forward pass, the cotangent
multiplied by ``-lam`` in the backward pass.
"""

from __future__ import annotations

import torch


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


def gradient_reversal(x: torch.Tensor, lam: float) -> torch.Tensor:
    """Identity forward; backward multiplies the cotangent by ``-lam``."""
    return _GradientReversal.apply(x, float(lam))
