"""Pipeline parallelism (GPipe) for the encoder layer stack (the port's
``parallel/pp.py``).

Stage ``s`` of the ``pipe`` ranks runs layers ``[s L/P, (s+1) L/P)`` on M
microbatches. The schedule is written by hand with point-to-point sends
inside one autograd Function (``torch.distributed.pipelining`` is not
used):

  * forward: for microbatch i = 0..M-1, stage 0 takes rows ``[i B/M, (i+1)
    B/M)`` of the stack's input, every other stage receives its
    predecessor's activation; each runs its layers and sends the result on.
    The last stage's outputs are broadcast to every stage (JAX's ``psum``
    over the pipe axis), where the final LN and the heads run as in the
    vanilla layout;
  * backward: for i = 0..M-1 in the same order on every stage, the last
    stage seeds each microbatch's backward from the broadcast's gradient,
    the others receive it from their successor; each sends the gradient of
    its input on to its predecessor. One fixed order on every stage is what
    keeps blocking sends from hanging.

Each stage computes the frame mask from the batch's lengths, so only the
activations travel. Every stage holds the whole parameter set (JAX keeps
the params replicated on every stage too) and runs the frontend; only
stage 0's feeds the stack, and the stages' gradients of everything up to
the stack's exit are summed over the pipe ranks. Each layer keeps its
attention-dropout seed and each microbatch its row offset, so the keep
masks are one device's. Composes with ``dp`` (rows over ``data``); ``tp x
pp`` is refused, as in JAX.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from . import dist as pdist
from .stacked import make_composed_forward


def validate_pp(bcfg, pp: int, batch_size: int, num_microbatches: int) -> None:
    """Static divisibility requirements, JAX's."""
    bad = []
    if bcfg.num_hidden_layers % pp:
        bad.append(f"num_hidden_layers={bcfg.num_hidden_layers} % pp={pp}")
    if num_microbatches < pp:
        bad.append(f"microbatches={num_microbatches} < pp={pp} "
                   "(pipeline would never fill)")
    if batch_size % num_microbatches:
        bad.append(f"batch_size={batch_size} % microbatches={num_microbatches}")
    if bad:
        raise ValueError("pipeline config invalid: " + "; ".join(bad))


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, enc, frame_mask, seeds, b_offset, group, m, grad):
        ranks = dist.get_process_group_ranks(group)
        n, s = len(ranks), pdist.group_rank(group)
        per = len(enc.layers) // n
        layers = list(enc.layers)[s * per:(s + 1) * per]
        seeds = seeds[s * per:(s + 1) * per]
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        mb = b // m
        like = x[:mb].detach()
        ins, outs = [], []
        with torch.set_grad_enabled(grad):
            for i in range(m):
                xi = x[i * mb:(i + 1) * mb].detach() if s == 0 else pdist.recv(like, ranks[s - 1])
                if grad:
                    xi.requires_grad_()
                yi = enc.run_layers(layers, xi, frame_mask[i * mb:(i + 1) * mb], seeds,
                                    b_offset + i * mb)
                if s < n - 1:
                    pdist.send(yi.detach(), ranks[s + 1])
                ins.append(xi)
                outs.append(yi)
        y = torch.cat(outs).detach() if s == n - 1 else torch.empty_like(x)
        pdist.broadcast_(y, ranks[-1], group)
        ctx.ins, ctx.outs, ctx.ranks, ctx.s, ctx.mb = ins, outs, ranks, s, mb
        return y

    @staticmethod
    def backward(ctx, dy):
        ranks, s, mb, n = ctx.ranks, ctx.s, ctx.mb, len(ctx.ranks)
        for i, (xi, yi) in enumerate(zip(ctx.ins, ctx.outs)):
            g = (dy[i * mb:(i + 1) * mb].contiguous() if s == n - 1
                 else pdist.recv(yi.detach(), ranks[s + 1]))
            if yi.requires_grad:
                torch.autograd.backward(yi, g)
            gx = xi.grad if xi.grad is not None else torch.zeros_like(xi)
            if s > 0:
                pdist.send(gx, ranks[s - 1])
        dx = (torch.cat([xi.grad if xi.grad is not None else torch.zeros_like(xi)
                         for xi in ctx.ins]) if s == 0 else torch.zeros_like(dy))
        ctx.ins = ctx.outs = None
        return dx, None, None, None, None, None, None, None


def make_pp_stack(mesh, *, axis: str = "pipe", num_microbatches: int) -> Callable:
    """``stack_fn`` running the encoder's layers as a GPipe pipeline over
    ``mesh``'s ``axis`` (remat: the encoder's own flag)."""
    group = mesh.group(axis)

    def stack_fn(enc, x, frame_mask, seeds, b_offset: int):
        return _Pipeline.apply(x, enc, frame_mask, seeds, b_offset, group,
                               num_microbatches, torch.is_grad_enabled())

    return stack_fn


def make_pp_forward(model, mesh, *, axis: str = "pipe", num_microbatches: int) -> Callable:
    """The model's forward with its stack pipelined over ``axis``."""
    return make_composed_forward(model, make_pp_stack(mesh, axis=axis,
                                                      num_microbatches=num_microbatches))


def pp_split_state_dict(sd, stage: int, pp: int, num_layers: int) -> dict:
    """Stage ``stage``'s shard of a vanilla state dict: its layers
    ``[stage L/P, (stage+1) L/P)`` under their own names, and everything
    outside the stack (which every stage holds)."""
    per = num_layers // pp
    mine = {str(i) for i in range(stage * per, (stage + 1) * per)}
    pre = "backbone.encoder.layers."
    return {k: v for k, v in sd.items()
            if not k.startswith(pre) or k[len(pre):].split(".", 1)[0] in mine}


def pp_gather_state_dict(shards) -> dict:
    """The vanilla state dict of every stage's shard, in stage order."""
    out = {}
    for sd in shards:
        for k, v in sd.items():
            out.setdefault(k, v)
    return out
