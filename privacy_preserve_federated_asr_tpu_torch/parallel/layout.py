"""One rank's part of a parallel layout: what the Trainer and the federated
engine install on a model and ask of its gradients.

``Layout(mesh, cfg, ...)`` over a bound mesh (``parallel/mesh.py``) with any
of the axes ``data``, ``model``, ``pipe``, ``seq``:

  * ``data``: the backbone runs on this rank's block of each batch's rows,
    told where they sit (``rows=``: row-shaped noise is drawn for the whole
    batch and sliced, the keep hash indexes global rows) and its output is gathered
    over ``data``; the heads and the loss then run on the whole batch on
    every rank, so the loss and its normalizers (sums of sample weights over
    the batch) are one device's, the Gumbel noise too. The backbone's
    gradients are partial sums over the ``data`` ranks and are all-reduced
    (one flat buffer per step), or reduce-scattered under ZeRO-1;
  * ``model``: tensor parallelism (``parallel/tp.py``);
  * ``pipe`` / ``seq``: the stack-parallel forwards (``parallel/pp.py``,
    ``parallel/sp.py``); gradients of everything up to the stack's exit are
    summed over these ranks.

Parameters after that point (the heads, and a stable-layer-norm backbone's
final LayerNorm under pipe / seq) get the same whole gradient on every rank
and are left alone. ``state_dict`` / ``load_state_dict`` convert between a
rank's tensor-parallel shards and the vanilla (whole) tensors that
checkpoints hold.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from . import dist as pdist
from .stacked import up_to_stack
from .tp import apply_tp
from .zero import Zero1


class Layout:
    def __init__(self, mesh, cfg, *, zero1: bool = False, num_microbatches: int = 1):
        self.mesh, self.cfg, self.zero1 = mesh, cfg, zero1
        g = {a: mesh.group(a) if mesh.axis_size(a) > 1 else None
             for a in ("data", "model", "pipe", "seq")}
        self.data, self.model, self.pipe, self.seq = (g[a] for a in ("data", "model",
                                                                      "pipe", "seq"))
        self.num_microbatches = num_microbatches
        self.tp_dims: dict[str, int] = {}

    def attach(self, model: torch.nn.Module) -> torch.nn.Module:
        """Install the layout on a model whose whole state is loaded."""
        if self.model is not None:
            self.tp_dims = apply_tp(model, self.model)
        if self.pipe is not None:
            from .pp import make_pp_forward

            make_pp_forward(model, self.mesh, num_microbatches=self.num_microbatches)
        if self.seq is not None:
            from .sp import make_sp_forward

            make_sp_forward(model, self.mesh)
        if self.data is not None:
            shard_rows(model.backbone, self.data)
        return model

    # ---- gradients ----

    def _partial(self, name: str, group) -> bool:
        if group is self.data:
            return name.startswith("backbone.")
        return up_to_stack(name, self.cfg.backbone)

    def reduce_grads(self, names: Sequence[str], grads: Sequence[torch.Tensor]) -> None:
        """Sum the partial gradients over the row groups, in place (the
        ``data`` sums are left to the ZeRO-1 reduce-scatter when on)."""
        for group in (None if self.zero1 else self.data, self.pipe, self.seq):
            if group is not None:
                pdist.flat_all_reduce_(
                    [g for n, g in zip(names, grads) if self._partial(n, group)], group)

    def make_zero1(self, named: Sequence[tuple[str, torch.Tensor]]) -> Zero1 | None:
        if not self.zero1:
            return None
        return Zero1(named, self.data, [n for n, _ in named if self._partial(n, self.data)],
                     skip=self.tp_dims)

    def grad_norm(self, names: Sequence[str], grads: Sequence[torch.Tensor],
                  zero: Zero1 | None = None) -> torch.Tensor:
        """The global norm of the whole gradient from this rank's part: the
        squares of tensor-parallel shards are summed over ``model``, those of
        ZeRO-1 shards over ``data``."""
        dev = grads[0].device
        sums = {"rep": torch.zeros((), device=dev), "tp": torch.zeros((), device=dev),
                "zero": torch.zeros((), device=dev)}
        for n, g in zip(names, grads):
            key = ("tp" if n in self.tp_dims else
                   "zero" if zero is not None and zero.sharded(n) else "rep")
            sums[key] = sums[key] + g.float().square().sum()
        if self.model is not None:
            pdist.all_reduce_(sums["tp"], self.model)
        if zero is not None:
            pdist.all_reduce_(sums["zero"], self.data)
        return (sums["rep"] + sums["tp"] + sums["zero"]).sqrt()

    # ---- whole tensors (checkpoints) ----

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.tp_dims.get(name)
        return t if d is None else pdist.all_gather(t, self.model, d)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.tp_dims.get(name)
        if d is None:
            return t
        n = t.shape[d] // pdist.group_size(self.model)
        return t.narrow(d, pdist.group_rank(self.model) * n, n)

    def state_dict(self, model: torch.nn.Module) -> dict[str, torch.Tensor]:
        """The vanilla state dict (collective under tensor parallelism)."""
        return {k: self.full(k, v) for k, v in model.state_dict().items()}

    def load_state_dict(self, model: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
        model.load_state_dict({k: self.local(k, v) for k, v in sd.items()})


def shard_rows(module: torch.nn.Module, group) -> None:
    """Run ``module`` (a backbone) on this rank's block of the batch rows of
    every tensor argument, with ``rows=(offset, batch)``, and gather its
    output over ``group``."""
    inner = module.forward
    n, r = pdist.group_size(group), pdist.group_rank(group)

    def forward(*args, **kwargs):
        b = next(a for a in (*args, *kwargs.values()) if torch.is_tensor(a)).shape[0]
        if b % n:
            raise ValueError(f"batch of {b} rows does not split over {n} data ranks")
        lo, hi = r * b // n, (r + 1) * b // n

        def mine(a):
            return a[lo:hi] if torch.is_tensor(a) and a.dim() and a.shape[0] == b else a

        h = inner(*map(mine, args), **{k: mine(v) for k, v in kwargs.items()}, rows=(lo, b))
        return pdist.gather_identical(h, group, 0)

    module.forward = forward
