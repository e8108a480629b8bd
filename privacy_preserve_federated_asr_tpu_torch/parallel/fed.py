"""Federated weight operations on the port's flat state dicts (the port's
``parallel/fed.py``).

The JAX package works on stacked param pytrees (a leading client axis under
``vmap``). The port trains clients one after another on one card, so the
aggregate is built as clients finish: :class:`FedAvgAccumulator` keeps a
running fp32 sum of the keys the caller aggregates (the federated engine:
the stage's sub-network only, since ``graft_network`` discards every other
key of the mean), and never holds K client copies.

  * ``NETWORKS`` / ``network_mask`` / ``select_network`` / ``graft_network``:
    the sub-network surgery by top-level prefix (``backbone``, ``lm_head``,
    ``dementia_head``, ``arbitrator``, ``similar_fc``);
  * ``average_weights``: FedAvg, unweighted (the reference's mean) or
    sample-count weighted;
  * ``dp_fedavg``: DP-FedAvg (McMahan et al. 2018): each client's delta is
    clipped to ``clip_norm`` in global L2 norm over every parameter, the
    clipped deltas are averaged and Gaussian noise of std
    ``clip_norm * noise_multiplier / K`` drawn from an explicit
    ``torch.Generator`` is added.

Uplink compression, secure aggregation and top-k sparsification are not
ported yet (the federated engine refuses them).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch

# sub-network name -> top-level parameter-name prefixes
# (reference: update_network_weight's "ASR" = data2vec_audio + lm_head,
#  "AD" = dementia_head, "toggling_network" = arbitrator; update.py:246-266)
NETWORKS: dict[str, tuple[str, ...]] = {
    "ASR": ("backbone", "lm_head"),
    "AD": ("dementia_head",),
    "toggling_network": ("arbitrator",),
    "all": ("backbone", "lm_head", "dementia_head", "arbitrator", "similar_fc"),
}

StateDict = Mapping[str, torch.Tensor]


def _in_network(key: str, network: str) -> bool:
    top = key.split(".", 1)[0]
    return any(top.startswith(p) for p in NETWORKS[network])


def network_mask(params: StateDict, network: str) -> dict[str, bool]:
    """Key -> True where the parameter belongs to the sub-network."""
    return {k: _in_network(k, network) for k in params}


def select_network(params: StateDict, network: str) -> dict[str, torch.Tensor]:
    """The sub-network's entries (``get_model_weight``)."""
    return {k: v for k, v in params.items() if _in_network(k, network)}


def graft_network(target: StateDict, source: StateDict, network: str) -> dict:
    """``target`` with the sub-network's entries taken from ``source``, cast
    to the target's dtype (``update_network_weight``). Pure: no input is
    mutated; the entries outside the sub-network are the target's own."""
    return {k: source[k].to(v.dtype) if _in_network(k, network) else v
            for k, v in target.items()}


class FedAvgAccumulator:
    """FedAvg over clients that arrive one at a time.

    ``keys``: the entries aggregated (a running fp32 sum of each);
    ``weights``: per-client weights in arrival order (normalized here), or
    None for the unweighted mean. With ``clip_norm`` it is DP-FedAvg:
    ``global_params`` is the round's start, each client's delta from it is
    clipped in L2 norm over every entry the client passes to :meth:`add`
    (not only ``keys``), and :meth:`result` adds Gaussian noise of std
    ``clip_norm * noise_multiplier / K`` from ``generator``.
    """

    def __init__(self, keys: Sequence[str], num_clients: int,
                 weights: Sequence[float] | None = None,
                 global_params: StateDict | None = None,
                 clip_norm: float | None = None, noise_multiplier: float = 0.0,
                 generator: torch.Generator | None = None):
        if clip_norm is not None and (weights is not None or global_params is None):
            raise ValueError("DP-FedAvg is unweighted (uniform-contribution "
                             "accounting) and needs the round's global params")
        self.keys, self.k = list(keys), num_clients
        total = None if weights is None else float(sum(weights))
        self.weights = None if weights is None else [w / total for w in weights]
        self.global_params, self.clip_norm = global_params, clip_norm
        self.noise_multiplier, self.generator = noise_multiplier, generator
        self.sum: dict[str, torch.Tensor] = {}
        self.count = 0

    def add(self, client_params: StateDict) -> None:
        if self.count == self.k:
            raise ValueError(f"all {self.k} clients were already added")
        if self.clip_norm is not None:
            g, keys = self.global_params, set(self.keys)
            sq, deltas = 0.0, {}
            for k, v in client_params.items():
                d = v.float() - g[k].float()
                sq = sq + d.square().sum()
                if k in keys:
                    deltas[k] = d
            scale = _clip_scale(sq, self.clip_norm)
            terms = {k: deltas[k] * scale for k in self.keys}
        elif self.weights is not None:
            w = self.weights[self.count]
            terms = {k: client_params[k].float() * w for k in self.keys}
        else:
            terms = {k: client_params[k] for k in self.keys}
        for k, x in terms.items():
            if k not in self.sum:
                self.sum[k] = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            self.sum[k] += x
        self.count += 1

    def result(self) -> dict[str, torch.Tensor]:
        """The aggregate of ``keys`` (fp32): the (weighted) mean, or under
        DP the round's global params plus the noised mean clipped delta."""
        if self.count != self.k:
            raise ValueError(f"{self.count} of {self.k} clients added")
        if self.weights is not None:
            return dict(self.sum)
        mean = {k: s / self.k for k, s in self.sum.items()}
        if self.clip_norm is None:
            return mean
        std = self.clip_norm * self.noise_multiplier / self.k
        out = {}
        for k in self.keys:
            m = mean[k]
            if std:
                m = m + std * torch.randn(m.shape, generator=self.generator,
                                          device=m.device, dtype=torch.float32)
            out[k] = self.global_params[k].float() + m
        return out


def average_weights(params_list: Sequence[StateDict],
                    weights: Sequence[float] | None = None) -> dict[str, torch.Tensor]:
    """FedAvg over a list of client state dicts (fp32): unweighted like the
    reference, or weighted by e.g. sample counts."""
    acc = FedAvgAccumulator(list(params_list[0]), len(params_list), weights)
    for p in params_list:
        acc.add(p)
    return acc.result()


def dp_fedavg(params_list: Sequence[StateDict], global_params: StateDict,
              clip_norm: float, noise_multiplier: float,
              generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """Differentially-private FedAvg over a list of client state dicts: the
    JAX package's ``dp_fedavg_stacked``, with the noise from ``generator``."""
    acc = FedAvgAccumulator(list(global_params), len(params_list),
                            global_params=global_params, clip_norm=clip_norm,
                            noise_multiplier=noise_multiplier, generator=generator)
    for p in params_list:
        acc.add(p)
    return acc.result()


def _clip_scale(sq: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """A client's clip multiplier ``min(1, clip / ||delta||_2)`` from the
    squared norm ``sq`` of its whole delta (the JAX ``_l2_clip_scales``)."""
    return torch.clamp(clip_norm / torch.sqrt(torch.clamp(sq, min=1e-24)), max=1.0)
