"""ZeRO-1: AdamW moments sharded over the ``data`` axis (the port's
``parallel/zero.py``).

With plain data parallelism every rank holds the fp32 Adam moments of every
parameter (~2.5 GB for data2vec-audio-large). ZeRO-1 (Rajbhandari et al.,
2020) gives each ``data`` rank the moments of one shard of each parameter:
the gradients are reduce-scattered into the shards, each rank updates its
shard, and the updated shards are all-gathered into the parameters, which
stay whole on every rank (ZeRO-1, not ZeRO-3). A rank's shard is a view of
its parameter: AdamW updates it in place, and only the moments are
sharded copies.

Layout rule, JAX's: a tensor is sharded along its FIRST dim divisible by the
axis size (``zero1_partition_spec``); a tensor with no such dim, and a
scalar, stays replicated. In torch's ``[out, in]`` weight layout the first
divisible dim is usually the output one.

``Zero1`` is what the port's AdamW (``train/optim.py``) runs over: the shard
views, the reduce-scatter of the gradients (a flat all-reduce and a slice),
the all-gather of the updates, and
the conversion of the moments to and from the full tensors a checkpoint
holds (a ZeRO-1 checkpoint is the plain one, and resumes at any ``dp``).
The federated engine's ``--fl_zero1`` (JAX ``zero1_constrain``) shards each
client's moments the same way over the client's ``data`` ranks.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch

from . import dist as pdist


def zero1_partition_spec(shape: tuple[int, ...], n: int, axis: str = "data") -> tuple:
    """The spec sharding the first dim divisible by ``n`` (the data-axis
    size), as a tuple of axis names and ``None``; ``()`` (replicated) when
    no dim divides, scalars included."""
    for d, s in enumerate(shape):
        if s >= n and s % n == 0:
            spec = [None] * len(shape)
            spec[d] = axis
            return tuple(spec)
    return ()


def zero1_opt_shardings(named_shapes: Mapping[str, tuple[int, ...]], n: int,
                        axis: str = "data") -> dict[str, tuple]:
    """``zero1_partition_spec`` of every optimizer-state tensor, by the name
    of its parameter."""
    return {k: zero1_partition_spec(tuple(s), n, axis) for k, s in named_shapes.items()}


def zero1_state_shardings(named_shapes: Mapping[str, tuple[int, ...]], n: int,
                          axis: str = "data") -> dict[str, dict[str, tuple]]:
    """The whole train state's layout: parameters replicated, moments per
    :func:`zero1_opt_shardings`."""
    return {"params": {k: () for k in named_shapes},
            "opt_state": zero1_opt_shardings(named_shapes, n, axis)}


class Zero1:
    """The shards of named tensors over ``group`` (the ``data`` ranks).
    ``partial`` names the parameters whose local gradients are partial sums
    (reduce-scattered); the others' gradients are the same on every rank
    (sliced). ``skip`` names tensors that keep their own layout (the
    tensor-parallel shards under ``--fl_zero1 --model_mesh``)."""

    def __init__(self, named: Iterable[tuple[str, torch.Tensor]], group,
                 partial: Iterable[str], skip: Iterable[str] = ()):
        self.group = group
        self.n, self.r = pdist.group_size(group), pdist.group_rank(group)
        skip = set(skip)
        self.dims = {}
        for name, p in named:
            spec = () if name in skip else zero1_partition_spec(tuple(p.shape), self.n)
            self.dims[name] = spec.index("data") if spec else None
        self.partial = set(partial)

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.dims[name]
        if d is None:
            return t
        s = t.shape[d] // self.n
        return t.narrow(d, self.r * s, s)

    def scatter_grads(self, names, grads) -> list[torch.Tensor]:
        """This rank's shard of each summed gradient: one flat all-reduce of
        the partial gradients, then each shard sliced (a reduce-scatter in
        two collectives both backends provide)."""
        pdist.flat_all_reduce_([g for n, g in zip(names, grads) if n in self.partial],
                               self.group)
        return [self.shard(n, g).clone() for n, g in zip(names, grads)]

    def gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        d = self.dims[name]
        return shard if d is None else pdist.all_gather(shard, self.group, d)

    @torch.no_grad()
    def gather_into(self, names, params) -> None:
        """Every rank's updated shards (views of ``params``, AdamW's master
        tensors) into the whole parameters, with one all-gather of a flat
        buffer; the replicated parameters are already whole."""
        sharded = [(n, p, self.shard(n, p)) for n, p in zip(names, params)
                   if self.dims[n] is not None]
        if not sharded:
            return
        sizes = [s.numel() for _, _, s in sharded]
        flat = pdist.all_gather(torch.cat([s.reshape(-1) for _, _, s in sharded]), self.group)
        pieces = [row.split(sizes) for row in flat.view(self.n, -1)]
        for i, (n, p, s) in enumerate(sharded):
            p.copy_(torch.cat([pieces[r][i].view(s.shape) for r in range(self.n)],
                              self.dims[n]))

    def sharded(self, name: str) -> bool:
        return self.dims[name] is not None
