"""Sequence (context) parallelism for the encoder layer stack (the port's
``parallel/sp.py``).

Each ``seq`` rank holds ``T / sp`` frames of every stack activation: the
stack's input is padded to a multiple of ``sp`` frames (the padding frames
are masked keys and are dropped at the exit) and each rank keeps its block
of frames. LayerNorm and the FFN are frame-local and run on the block.
Attention runs the rank's query rows against keys and values gathered over
the ``seq`` ranks: the all-gather-KV form that JAX's GSPMD layout lowers to
(ring attention only pays past T ~ 1e4 frames). The kernels take the local
query rows (``Tq = T / sp``) against the ``T`` valid keys with the query
offset of the block, so the dropout keep masks are one device's (the
stack's attention modules become ``SPAttention`` at its first call). The
stack's exit gathers the blocks back to the full time axis, where the final
LN, the heads and CTC's time recursion run as in the vanilla layout.

The gathers are autograd-aware (``parallel/dist.py``): the gradient of the
gathered K/V is summed over the ranks and sliced, that of the exit gather
is sliced. Composes with ``dp`` (rows over ``data``); ``sp x tp`` and
``sp x pp`` are refused, as in JAX.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from ..models.backbone import Attention
from . import dist as pdist
from .stacked import make_composed_forward


class SPAttention(Attention):
    """This rank's query rows (its block of frames) against K and V
    gathered over ``group`` and cut to the ``key_mask.shape[1]`` valid
    keys; the query offset keeps the keep masks one device's."""

    group = None

    def forward(self, x, key_mask, seed: int = 0, b_offset: int = 0):
        b, t, _ = x.shape
        q, k, v = self.project(x)
        kv = pdist.gather_summed(torch.stack((k, v)), self.group, 2)[:, :, :key_mask.shape[1]]
        ctx = self.attend(q, kv[0], kv[1], key_mask, seed, b_offset=b_offset,
                          q_offset=pdist.group_rank(self.group) * t)
        return self.out_proj(ctx.reshape(b, t, -1))


def make_sp_stack(mesh, *, axis: str = "seq") -> Callable:
    """``stack_fn`` running the encoder's layers time-sharded over
    ``mesh``'s ``axis`` (remat: the encoder's own flag)."""
    group = mesh.group(axis)

    def stack_fn(enc, x, frame_mask, seeds, b_offset: int):
        for layer in enc.layers:
            if type(layer.attention) is Attention:
                layer.attention.__class__ = SPAttention
                layer.attention.group = group
        n, r = pdist.group_size(group), pdist.group_rank(group)
        t = x.shape[1]
        tl = -(-t // n)
        if tl * n != t:
            x = F.pad(x, (0, 0, 0, tl * n - t))
        y = enc.run_layers(enc.layers, x[:, r * tl:(r + 1) * tl], frame_mask, seeds, b_offset)
        return pdist.gather_identical(y, group, 1)[:, :t]

    return stack_fn


def make_sp_forward(model, mesh, *, axis: str = "seq") -> Callable:
    """The model's forward with its stack sequence-parallel over ``axis``."""
    return make_composed_forward(model, make_sp_stack(mesh, axis=axis))
