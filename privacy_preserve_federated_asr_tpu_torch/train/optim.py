"""Optimizer with stage-based parameter freezing (the port's
``train/optim.py``).

The JAX package's optax chain — global-norm clipping, then AdamW with a
linear-warmup / linear-decay schedule, partitioned into trainable and frozen
leaves — on ``torch.optim.AdamW``:

  * frozen parameters (the recipe's stage predicate) get
    ``requires_grad_(False)`` and carry no optimizer state;
  * biases and LayerNorm / GroupNorm weights (flax's ``scale``) are in a
    no-decay group, chosen by module type;
  * ``LambdaLR`` gives each step the value of ``make_lr_schedule`` at the
    count of updates done so far, as optax evaluates its schedule;
  * clipping is optax's: unchanged below ``max_norm``, else scaled by
    ``max_norm / norm`` (no epsilon);
  * FedProx (``fedprox_mu``, JAX ``proximal_term``) adds ``mu * (w - w_ref)``
    to the gradient before the clip, ``w_ref`` the trainable parameters'
    values when the optimizer is built (or the ``prox_ref`` given);
  * gradient accumulation (``grad_accum = k``, optax ``MultiSteps`` with
    ``use_grad_mean=False``): micro-gradients are summed, and the clip and
    AdamW run once per k micro-steps on the sum;
  * a parallel ``layout`` (``parallel/layout.py``): the gradients are
    summed over the ranks that hold parts of them, the clip sees the norm of
    the whole gradient, and under ZeRO-1 (``parallel/zero.py``) AdamW runs
    on this rank's shards, whose updates are gathered into the parameters;
    ``state_dict`` holds the whole moments in every layout.

The defaults are the reference's: AdamW, max_grad_norm 1.0, weight decay
0.005, warmup 1000, stage LR 1e-5 / 1e-4 / 1e-3 (federated/src/update.py).
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch import nn

STAGE_LRS = {0: 1e-5, 1: 1e-4, 2: 1e-3}


def make_lr_schedule(peak_lr: float, warmup_steps: int = 1000,
                     total_steps: int = 10000) -> Callable[[int], float]:
    """HF default: linear warmup from 0 to ``peak_lr``, then linear decay to
    0 (optax ``join_schedules`` of two ``linear_schedule``s)."""
    warm = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def lr(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * min(count, warm) / warm
        return peak_lr * (1.0 - min(count - warmup_steps, decay) / decay)

    return lr


def path_of(name: str) -> tuple[str, ...]:
    """A parameter's dotted name as the path the stage predicates take."""
    return tuple(name.split("."))


def apply_trainable(model: nn.Module, pred: Callable[[tuple[str, ...]], bool]) -> None:
    """``requires_grad`` = the predicate, per parameter."""
    for name, p in model.named_parameters():
        p.requires_grad_(pred(path_of(name)))


def no_decay_names(model: nn.Module) -> set[str]:
    """Biases and LayerNorm / GroupNorm weights, as HF AdamW skips them."""
    out = set()
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            if pname == "bias" or isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                out.add(f"{mname}.{pname}" if mname else pname)
    return out


def global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """optax ``chain([proximal_term,] clip_by_global_norm, adamw)`` over a
    model's trainable parameters, optionally under ``MultiSteps``.
    :meth:`step` reads the gradients, clears them and returns their global
    norm (a device scalar: no sync); on an update step (every step, or every
    ``grad_accum``-th) it adds the proximal term, clips, updates the
    parameters and advances the schedule."""

    def __init__(self, model: nn.Module, lr: Callable[[int], float],
                 weight_decay: float, max_grad_norm: float, fedprox_mu: float = 0.0,
                 prox_ref: Mapping[str, torch.Tensor] | None = None,
                 grad_accum: int = 1, layout=None):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        skip = no_decay_names(model)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        if not named:
            raise ValueError("no trainable parameters")
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.layout = layout
        self.zero = layout.make_zero1(named) if layout is not None else None
        # what AdamW updates: the parameters, or under ZeRO-1 this rank's
        # shards of them (views: the update lands in the parameter)
        self.master = (self.params if self.zero is None else
                       [nn.Parameter(self.zero.shard(n, p.detach())) for n, p in named])
        self.fedprox_mu = fedprox_mu
        # the FedProx anchor: trainable parameters only (their local part)
        self.prox_ref = ([self._local(n, (p.detach() if prox_ref is None else prox_ref[n])
                                      ).to(p.device, torch.float32, copy=True)
                          for n, p in named] if fedprox_mu else None)
        self.grad_accum = grad_accum
        self.mini_step = 0    # micro-steps into the current accumulation
        self.acc = None       # summed micro-gradients (grad_accum > 1)
        by_name = dict(zip(self.names, self.master))
        groups = [{"params": [by_name[n] for n, _ in named if n not in skip],
                   "weight_decay": weight_decay},
                  {"params": [by_name[n] for n, _ in named if n in skip], "weight_decay": 0.0}]
        # torch's defaults are optax's: b1 0.9, b2 0.999, eps 1e-8
        # (the fused kernel takes dense tensors: a shard along a later dim is
        # strided, and then the foreach path runs)
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], lr=1.0,
                                       fused=self.params[0].is_cuda and all(
                                           m.is_contiguous() for m in self.master))
        # base lr 1.0: the lambda gives the absolute learning rate
        self.schedule = torch.optim.lr_scheduler.LambdaLR(self.adamw, lr)
        self.max_grad_norm = max_grad_norm

    def _norm(self, grads) -> torch.Tensor:
        if self.layout is None:
            return global_norm(grads)
        return self.layout.grad_norm(self.names, grads, self.zero)

    def _full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A tensor of the master's layout as the whole tensor."""
        if self.zero is not None:
            t = self.zero.gather(name, t)
        return t if self.layout is None else self.layout.full(name, t)

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A whole tensor in the master's layout."""
        if self.layout is not None:
            t = self.layout.local(name, t)
        return t if self.zero is None else self.zero.shard(name, t)

    def step(self) -> torch.Tensor:
        for p in self.params:  # an unused trainable param: zero grad, as optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.layout is not None:
            self.layout.reduce_grads(self.names, grads)
        if self.zero is not None:
            grads = self.zero.scatter_grads(self.names, grads)
            self.adamw.zero_grad(set_to_none=True)
            for p in self.params:
                p.grad = None
            for m, g in zip(self.master, grads):
                m.grad = g
        norm = self._norm(grads)
        if self.grad_accum > 1:
            if self.acc is None:
                self.acc = [g.clone() for g in grads]
            else:
                torch._foreach_add_(self.acc, grads)
            self.mini_step += 1
            self.adamw.zero_grad(set_to_none=True)
            for p in self.params:
                p.grad = None
            if self.mini_step < self.grad_accum:
                return norm
            for m, a in zip(self.master, self.acc):
                m.grad = a
            grads, self.acc, self.mini_step = self.acc, None, 0
        if self.fedprox_mu:
            torch._foreach_add_(grads, torch._foreach_sub(
                [m.detach() for m in self.master], self.prox_ref), alpha=self.fedprox_mu)
        # the clip sees what it is given: the summed, proximal gradient
        clip_norm = (self._norm(grads) if self.fedprox_mu or self.grad_accum > 1
                     else norm)
        scale = torch.where(clip_norm < self.max_grad_norm, torch.ones_like(clip_norm),
                            self.max_grad_norm / clip_norm)
        torch._foreach_mul_(grads, scale)
        self.adamw.step()
        self.schedule.step()
        self.adamw.zero_grad(set_to_none=True)
        if self.zero is not None:
            self.zero.gather_into(self.names, self.params)
        return norm

    def state_dict(self) -> dict:
        """AdamW's moments, the schedule and, under accumulation, the summed
        micro-gradients and their count (a resume mid-accumulation is
        exact, as MultiSteps' ``acc_grads`` in the JAX state). Under a
        layout the moments and sums are the whole tensors (collective)."""
        adamw = self.adamw.state_dict()
        if self.layout is not None:  # (new dicts: the packed state is the live one)
            adamw["state"] = {i: {**st, **{k: self._full(self.names[i], st[k])
                                           for k in ("exp_avg", "exp_avg_sq")}}
                              for i, st in adamw["state"].items()}
        sd = {"adamw": adamw, "schedule": self.schedule.state_dict()}
        if self.grad_accum > 1:
            acc = (self.acc if self.acc is None or self.layout is None else
                   [self._full(n, a) for n, a in zip(self.names, self.acc)])
            sd["accum"] = {"mini_step": self.mini_step, "acc": acc}
        return sd

    def load_state_dict(self, sd: dict) -> None:
        adamw = sd["adamw"]
        if self.layout is not None:
            adamw = {**adamw, "state": {
                i: {**st, **{k: self._local(self.names[int(i)], st[k]).clone()
                             for k in ("exp_avg", "exp_avg_sq")}}
                for i, st in adamw["state"].items()}}
        self.adamw.load_state_dict(adamw)
        self.schedule.load_state_dict(sd["schedule"])
        if self.grad_accum > 1:
            accum = sd.get("accum") or {"mini_step": 0, "acc": None}
            self.mini_step = int(accum["mini_step"])
            self.acc = (None if accum["acc"] is None else
                        [self._local(n, a).to(m.device, m.dtype).clone()
                         for n, a, m in zip(self.names, accum["acc"], self.master)])


def make_optimizer(model: nn.Module, stage: int,
                   learning_rate: float | Callable[[int], float] | None = None,
                   weight_decay: float = 0.005, max_grad_norm: float = 1.0,
                   warmup_steps: int = 1000, total_steps: int = 10000,
                   trainable_pred: Callable[[tuple[str, ...]], bool] | None = None,
                   fedprox_mu: float = 0.0,
                   prox_ref: Mapping[str, torch.Tensor] | None = None,
                   grad_accum: int = 1, layout=None) -> Optimizer:
    """AdamW with stage freezing, decay masking and global-norm clipping.

    ``learning_rate``: None -> the stage's warmup/decay schedule, a float ->
    that constant rate (as optax takes a float), a callable -> a schedule of
    the update count. ``trainable_pred`` overrides the DACS stage predicate.
    ``fedprox_mu > 0`` adds the FedProx proximal term, anchored on
    ``prox_ref`` (a state dict) or on the params as they are now.
    ``grad_accum > 1`` sums that many micro-gradients per update;
    ``layout`` is the model's parallel layout (``parallel/layout.py``).
    Sets ``requires_grad`` on every parameter of ``model``."""
    from ..models.recipes import stage_trainable_predicate

    if learning_rate is None:
        learning_rate = make_lr_schedule(STAGE_LRS.get(stage, 1e-4), warmup_steps,
                                         total_steps)
    elif not callable(learning_rate):
        constant = float(learning_rate)
        learning_rate = lambda count: constant  # noqa: E731
    apply_trainable(model, trainable_pred or stage_trainable_predicate(stage))
    return Optimizer(model, learning_rate, weight_decay, max_grad_norm, fedprox_mu,
                     prox_ref, grad_accum, layout)
