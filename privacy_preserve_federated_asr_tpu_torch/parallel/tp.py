"""Tensor (Megatron) parallelism for the encoder (the port's
``parallel/tp.py``).

Each transformer block becomes a column-parallel -> row-parallel pair over
the ``model`` axis:

  * column-parallel: ``q_proj``, ``k_proj``, ``v_proj``, ``intermediate_dense``
    hold their output features' shard: weight dim 0 of torch's ``[out, in]``
    layout and the bias (JAX shards the kernel's last dim of its
    ``[in, out]`` layout: the same features);
  * row-parallel: ``out_proj``, ``output_dense`` hold their input features'
    shard, weight dim 1 (JAX: the kernel's second-to-last dim); the bias
    stays whole and is added after the all-reduce;
  * everything else (LayerNorms, the conv frontend, the positional conv,
    heads, arbitrator) is replicated.

So each attention block and each FFN block makes one all-reduce forward
(Megatron's g; its gradient is the identity) and one backward (f, at the
block's input): ``apply_tp`` turns ``models/backbone.py``'s ``Attention``
and ``FeedForward`` into ``TPAttention`` and ``TPFeedForward``. The
attention runs this rank's ``H / tp`` heads through the flash kernels, with
the head offset that keeps the dropout keep masks one device's. The parameter names do not change: a rank's state dict holds the
same keys with shard shapes (``tp_split_state_dict`` /
``tp_gather_state_dict``), and checkpoints hold the whole tensors.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..models.backbone import Attention, FeedForward
from . import dist as pdist

_COL_MODULES = frozenset({"q_proj", "k_proj", "v_proj", "intermediate_dense"})
_ROW_MODULES = frozenset({"out_proj", "output_dense"})


def tp_partition_spec(path_names: Sequence[str], ndim: int, axis: str = "model") -> tuple:
    """The spec of one parameter (by its dotted-name path) in torch's
    layout: ``(axis, None)`` / ``(axis,)`` for a column-parallel weight /
    bias, ``(None, axis)`` for a row-parallel weight, ``()`` replicated."""
    if ndim >= 1 and len(path_names) >= 2:
        module, leaf = path_names[-2], path_names[-1]
        if module in _COL_MODULES and leaf in ("weight", "bias"):
            spec = [None] * ndim
            spec[0] = axis
            return tuple(spec)
        if module in _ROW_MODULES and leaf == "weight" and ndim >= 2:
            spec = [None] * ndim
            spec[1] = axis
            return tuple(spec)
    return ()


def tp_shardings(named_shapes: Mapping[str, Sequence[int]], axis: str = "model") -> dict:
    """:func:`tp_partition_spec` of every entry of a state dict (params or
    moments, by parameter name)."""
    return {k: tp_partition_spec(k.split("."), len(s), axis)
            for k, s in named_shapes.items()}


def tp_dim(name: str, ndim: int) -> int | None:
    spec = tp_partition_spec(name.split("."), ndim)
    return spec.index("model") if spec else None


def validate_tp_divisibility(cfg, tp: int) -> None:
    """The sharded feature dims must divide evenly over the model axis."""
    bad = []
    if cfg.hidden_size % tp:
        bad.append(f"hidden_size={cfg.hidden_size}")
    if cfg.intermediate_size % tp:
        bad.append(f"intermediate_size={cfg.intermediate_size}")
    if cfg.num_attention_heads % tp:
        bad.append(f"num_attention_heads={cfg.num_attention_heads}")
    if bad:
        raise ValueError(f"tp={tp} does not divide {', '.join(bad)}")


def _shard(t: torch.Tensor, d: int | None, index: int, size: int) -> torch.Tensor:
    if d is None:
        return t
    n = t.shape[d] // size
    return t.narrow(d, index * n, n)


def tp_split_state_dict(sd: Mapping[str, torch.Tensor], index: int, size: int) -> dict:
    """Rank ``index`` of ``size``'s shard of a vanilla state dict (views)."""
    return {k: _shard(v, tp_dim(k, v.dim()), index, size) for k, v in sd.items()}


def tp_gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]]) -> dict:
    """The vanilla state dict of every rank's shard, in rank order."""
    out = {}
    for k, v in shards[0].items():
        d = tp_dim(k, v.dim())
        out[k] = v if d is None else torch.cat([s[k] for s in shards], d)
    return out


class TPAttention(Attention):
    """This rank's ``H / tp`` heads (column-parallel q/k/v) and the matching
    input columns of ``out_proj`` (row-parallel: its partial products are
    all-reduced over ``group``, then the bias added). The head offset keeps
    the keep masks one device's."""

    group = None

    def forward(self, x, key_mask, seed: int = 0, b_offset: int = 0):
        b, t, _ = x.shape
        q, k, v = self.project(pdist.copy_to_group(x, self.group))
        h = q.shape[2]
        ctx = self.attend(q, k, v, key_mask, seed, b_offset=b_offset,
                          h_offset=pdist.group_rank(self.group) * h,
                          h_total=h * pdist.group_size(self.group))
        y = pdist.reduce_from_group(self.out_proj.matmul(ctx.reshape(b, t, -1)), self.group)
        return self.out_proj.add_bias(y)


class TPFeedForward(FeedForward):
    """This rank's intermediate features (column-parallel) and the matching
    input columns of ``output_dense`` (row-parallel, all-reduced before the
    bias)."""

    group = None

    def forward(self, x):
        x = self.activation_dropout(self.act(self.intermediate_dense(
            pdist.copy_to_group(x, self.group))))
        y = pdist.reduce_from_group(self.output_dense.matmul(x), self.group)
        return self.hidden_dropout(self.output_dense.add_bias(y))


_TP_FORMS = {Attention: TPAttention, FeedForward: TPFeedForward}


def apply_tp(model: torch.nn.Module, group) -> dict[str, int]:
    """Shard ``model`` (its whole state loaded) in place over ``group``:
    every column- and row-parallel parameter is replaced by this rank's
    shard, and the attention and FFN blocks become their tensor-parallel
    forms. Returns the sharded parameters' dims by name."""
    index, size = pdist.group_rank(group), pdist.group_size(group)
    dims = {}
    for name, p in list(model.named_parameters()):
        d = tp_dim(name, p.dim())
        if d is None:
            continue
        owner_name, leaf = name.rsplit(".", 1)
        owner = model.get_submodule(owner_name)
        setattr(owner, leaf, torch.nn.Parameter(_shard(p.detach(), d, index, size).clone(),
                                                requires_grad=p.requires_grad))
        dims[name] = d
    for m in model.modules():
        if type(m) in _TP_FORMS:
            m.__class__ = _TP_FORMS[type(m)]
            m.group = group
    return dims
