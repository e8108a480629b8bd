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

The other aggregators of the JAX package, on round deltas ``client -
global`` in fp32, each as an accumulator of the same interface
(:meth:`add` per client, :meth:`result`) and as a function over a list of
client state dicts:

  * ``compressed_delta_fedavg`` (:class:`CompressedDeltaAccumulator`): each
    client's delta quantized per entry to ``bits``-bit integers with a
    symmetric abs-max scale, nearest rounding or stochastic rounding from an
    explicit ``torch.Generator`` (a JAX PRNG stream cannot be reproduced:
    the rounding keeps its distribution, not its bits);
  * ``secure_aggregate_fedavg`` (:class:`SecAggAccumulator`): each delta
    L2-clipped over every entry, quantized to the public fixed-point grid
    ``clip / (2^(bits-1) - 1)`` and masked with pairwise masks in
    wrap-around int32 arithmetic, which cancel exactly in the server's sum;
  * ``topk_delta_fedavg`` (:class:`TopKDeltaAccumulator`): only the largest
    ``fraction`` of each entry's error-corrected delta is sent; the rest
    stays in the client's residual for a later round.
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

    def add(self, client_params: StateDict, ki: int | None = None) -> None:
        """Add the next client's params (or client ``ki``'s: a ``client``
        rank adds its block of the round's clients)."""
        if ki is not None:
            self.count = ki
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

    def all_reduce(self, group, like: StateDict | None = None) -> None:
        """Sum every ``client`` rank's part over ``group``; then every
        client counts as added. ``like`` gives the shapes of sums a rank
        with no client lacks."""
        _all_reduce_sums(self, group, like or self.global_params, torch.float32)

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


def _all_reduce_sums(acc, group, like: StateDict, dtype: torch.dtype) -> None:
    from . import dist as pdist

    for k in acc.keys:
        if k not in acc.sum:
            acc.sum[k] = torch.zeros(like[k].shape, dtype=dtype, device=like[k].device)
    pdist.flat_all_reduce_([acc.sum[k] for k in acc.keys], group)
    acc.count = acc.k


def _clip_scale(sq: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """A client's clip multiplier ``min(1, clip / ||delta||_2)`` from the
    squared norm ``sq`` of its whole delta (the JAX ``_l2_clip_scales``)."""
    return torch.clamp(clip_norm / torch.sqrt(torch.clamp(sq, min=1e-24)), max=1.0)


class _DeltaAccumulator:
    """FedAvg of per-client terms of the round delta ``client - global``
    (fp32) over ``keys``; :meth:`result` is ``global + mean``."""

    def __init__(self, keys: Sequence[str], num_clients: int, global_params: StateDict,
                 weights: Sequence[float] | None = None):
        self.keys, self.k, self.global_params = list(keys), num_clients, global_params
        total = None if weights is None else float(sum(weights))
        self.weights = None if weights is None else [w / total for w in weights]
        self.sum: dict[str, torch.Tensor] = {}
        self.count = 0

    def _term(self, ki: int, deltas: dict[str, torch.Tensor],
              client_params: StateDict) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    sum_dtype = torch.float32

    def add(self, client_params: StateDict, ki: int | None = None) -> None:
        """Add the next client's params (or client ``ki``'s)."""
        if ki is not None:
            self.count = ki
        if self.count == self.k:
            raise ValueError(f"all {self.k} clients were already added")
        g = self.global_params
        deltas = {k: client_params[k].float() - g[k].float() for k in self.keys}
        terms = self._term(self.count, deltas, client_params)
        if self.weights is not None:
            terms = {k: t * self.weights[self.count] for k, t in terms.items()}
        for k, t in terms.items():  # every term is a fresh tensor: sum into the first
            if k in self.sum:
                self.sum[k] += t
            else:
                self.sum[k] = t
        self.count += 1

    def all_reduce(self, group, like: StateDict | None = None) -> None:
        """Sum every ``client`` rank's part over ``group`` (then every
        client counts as added)."""
        _all_reduce_sums(self, group, like or self.global_params, self.sum_dtype)

    def _mean(self) -> dict[str, torch.Tensor]:
        if self.weights is not None:
            return self.sum
        return {k: s / self.k for k, s in self.sum.items()}

    def result(self) -> dict[str, torch.Tensor]:
        if self.count != self.k:
            raise ValueError(f"{self.count} of {self.k} clients added")
        return {k: self.global_params[k].float() + m for k, m in self._mean().items()}


class CompressedDeltaAccumulator(_DeltaAccumulator):
    """FedAvg over int-quantized client deltas (the JAX
    ``compressed_delta_fedavg``): per client and entry a symmetric abs-max
    scale ``amax / (2^(bits-1) - 1)``, rounding to nearest or, with
    ``generator``, stochastic ``floor(x + u)``, u ~ U[0, 1) (unbiased); the
    int8 payload is dequantized and averaged."""

    def __init__(self, keys, num_clients, global_params, bits: int = 8,
                 generator: torch.Generator | None = None, weights=None):
        if not 2 <= bits <= 8:
            raise ValueError(f"bits must be in [2, 8], got {bits}")
        super().__init__(keys, num_clients, global_params, weights)
        self.qmax, self.generator = float(2 ** (bits - 1) - 1), generator

    def skip_draws(self, n: int) -> None:
        """Advance the rounding generator past ``n`` clients' draws (a
        ``client`` rank whose block starts at client ``n``)."""
        if self.generator is not None:
            for _ in range(n):
                for k in self.keys:
                    torch.rand(self.global_params[k].shape, generator=self.generator,
                               device=self.global_params[k].device)

    def _term(self, ki, deltas, client_params):
        out = {}
        for k, d in deltas.items():
            amax = d.abs().max()
            scale = torch.where(amax > 0, amax / self.qmax, torch.ones_like(amax))
            x = d / scale
            if self.generator is None:
                q = torch.round(x)
            else:
                q = torch.floor(x + torch.rand(x.shape, generator=self.generator,
                                               device=x.device))
            q = q.clamp(-self.qmax, self.qmax).to(torch.int8)  # the wire payload
            out[k] = q.float() * scale
        return out


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's range with two's-complement wrap."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


class SecAggAccumulator(_DeltaAccumulator):
    """FedAvg through secure aggregation (the JAX ``secagg_payloads`` and
    ``secure_aggregate_fedavg``; Bonawitz et al. 2017). Client k's payload
    per entry is ``q_k + M_k`` in wrap-around int32: ``q_k`` its delta,
    clipped to ``clip_norm`` in L2 over every entry it passes (not only
    ``keys``), on the grid ``s = clip_norm / (2^(bits-1) - 1)``, and ``M_k =
    sum_{j>k} PRG(k, j) - sum_{j<k} PRG(j, k)``, each pair's stream a
    ``torch.Generator`` seeded from ``seed``, the entry and the pair. The
    masks sum to 0 exactly, so the server's wrap-around sum of payloads is
    the sum of the ``q_k``; :attr:`payloads` keeps what crossed the wire
    when ``keep_payloads``. Unweighted."""

    def __init__(self, keys, num_clients, global_params, clip_norm: float, seed: int = 0,
                 bits: int = 20, keep_payloads: bool = False):
        if not 2 <= bits <= 24:
            raise ValueError(f"bits must be in [2, 24], got {bits}")
        if num_clients * (2 ** (bits - 1)) >= 2 ** 31:
            # the server-side wrap-around sum must be able to hold K * qmax
            # without aliasing back into the valid range
            raise ValueError(f"bits={bits} leaves no headroom for {num_clients} clients "
                             f"in int32 (need K * 2^(bits-1) < 2^31)")
        super().__init__(keys, num_clients, global_params)
        self.sum_dtype = torch.int64
        self.clip_norm, self.seed = clip_norm, seed
        self.scale = clip_norm / float(2 ** (bits - 1) - 1)
        self.payloads: list[dict[str, torch.Tensor]] | None = [] if keep_payloads else None

    def _pair_stream(self, entry: int, i: int, j: int, like: torch.Tensor) -> torch.Tensor:
        gen = torch.Generator(like.device).manual_seed(
            (self.seed * 1_000_003 + entry * self.k * self.k + i * self.k + j) % (2 ** 63))
        return torch.randint(-2 ** 31, 2 ** 31, like.shape, generator=gen,
                             dtype=torch.int64, device=like.device)

    def _term(self, ki, deltas, client_params):
        g, keys = self.global_params, set(self.keys)
        sq = 0.0
        for k, v in client_params.items():
            d = deltas[k] if k in keys else v.float() - g[k].float()
            sq = sq + d.square().sum()
        clip = _clip_scale(sq, self.clip_norm)
        out = {}
        for entry, (k, d) in enumerate(deltas.items()):
            q = torch.round(d * clip / self.scale).to(torch.int64)  # |q| <= qmax
            mask = torch.zeros_like(q)
            for j in range(self.k):
                if j > ki:
                    mask += self._pair_stream(entry, ki, j, q)
                elif j < ki:
                    mask -= self._pair_stream(entry, j, ki, q)
            out[k] = _wrap32(q + mask)
        if self.payloads is not None:
            self.payloads.append({k: v.to(torch.int32) for k, v in out.items()})
        return out

    def _mean(self):
        return {k: _wrap32(s).to(torch.int32).float() * (self.scale / self.k)
                for k, s in self.sum.items()}


class TopKDeltaAccumulator(_DeltaAccumulator):
    """FedAvg over top-k-sparsified client deltas with error feedback (the
    JAX ``topk_delta_fedavg``; Lin et al. 2018): per client and entry only
    the ``ceil(fraction * n)`` largest magnitudes of ``delta + residual_k``
    are sent; the rest becomes the client's new residual
    (:attr:`residuals`, in the order the clients were added). ``residuals``: per client a dict
    over ``keys`` (None: zeros)."""

    def __init__(self, keys, num_clients, global_params, fraction: float,
                 residuals: Sequence[Mapping[str, torch.Tensor]] | None = None,
                 weights=None):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        super().__init__(keys, num_clients, global_params, weights)
        self.fraction, self.prev = fraction, residuals
        self.residuals: list[dict[str, torch.Tensor]] = []

    def _term(self, ki, deltas, client_params):
        if self.prev is not None:
            deltas = {k: d + self.prev[ki][k].float() for k, d in deltas.items()}
        sent = {}
        for k, d in deltas.items():
            x = d.reshape(-1)
            kk = max(1, int(-(-self.fraction * x.numel() // 1)))  # ceil
            idx = torch.topk(x.abs(), kk).indices
            sent[k] = torch.zeros_like(x).index_copy_(0, idx, x[idx]).view_as(d)
        self.residuals.append({k: deltas[k] - sent[k] for k in deltas})
        return sent


def compressed_delta_fedavg(params_list: Sequence[StateDict], global_params: StateDict,
                            bits: int = 8, generator: torch.Generator | None = None,
                            weights: Sequence[float] | None = None) -> dict[str, torch.Tensor]:
    """FedAvg over int-quantized client deltas (:class:`CompressedDeltaAccumulator`)."""
    acc = CompressedDeltaAccumulator(list(global_params), len(params_list), global_params,
                                     bits, generator, weights)
    for p in params_list:
        acc.add(p)
    return acc.result()


def secure_aggregate_fedavg(params_list: Sequence[StateDict], global_params: StateDict,
                            clip_norm: float, seed: int = 0,
                            bits: int = 20) -> dict[str, torch.Tensor]:
    """FedAvg through secure aggregation (:class:`SecAggAccumulator`)."""
    acc = SecAggAccumulator(list(global_params), len(params_list), global_params,
                            clip_norm, seed, bits)
    for p in params_list:
        acc.add(p)
    return acc.result()


def topk_delta_fedavg(params_list: Sequence[StateDict], global_params: StateDict,
                      fraction: float,
                      residuals: Sequence[Mapping[str, torch.Tensor]] | None = None,
                      weights: Sequence[float] | None = None
                      ) -> tuple[dict[str, torch.Tensor], list[dict[str, torch.Tensor]]]:
    """Top-k sparsified FedAvg with error feedback
    (:class:`TopKDeltaAccumulator`): ``(new_global, new_residuals)``."""
    acc = TopKDeltaAccumulator(list(global_params), len(params_list), global_params,
                               fraction, residuals, weights)
    for p in params_list:
        acc.add(p)
    return acc.result(), acc.residuals
