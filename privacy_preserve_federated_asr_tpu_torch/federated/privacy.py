"""Renyi-DP accountant for DP-FedAvg rounds.

``parallel/fed.py:dp_fedavg_stacked`` clips each sampled client's round
delta to ``C`` and adds Gaussian noise of std ``C * z / m`` to the mean of
the ``m`` clipped deltas. One client's removal moves that mean by at most
``C / m`` in L2, so each round is exactly the *sampled Gaussian mechanism*
with noise multiplier ``sigma = z`` under client-level subsampling at rate
``q = m / K`` (m participants drawn uniformly without replacement from K
clients per round).

This module turns (q, sigma, rounds) into an (epsilon, delta) guarantee:

* per-step Renyi divergence of the sampled Gaussian mechanism at integer
  orders alpha (Mironov, Talwar & Zhang 2019, eq. for integer alpha):

      RDP(alpha) = 1/(alpha-1) * log( sum_{k=0..alpha} C(alpha,k)
                     (1-q)^(alpha-k) q^k exp(k(k-1) / (2 sigma^2)) )

  evaluated in log-space (log-binomials + logsumexp) so large alpha and
  tiny q are exact to float64;
* linear composition over rounds (RDP adds across sequential mechanisms);
* conversion to (epsilon, delta) with the improved bound of
  Canonne, Kamath & Steinke 2020 (tighter than the classic
  ``eps + log(1/delta)/(alpha-1)``), minimized over the alpha grid.

The reference has no DP mechanism at all (its privacy lever is the
representation-level toggling network); this accountant is the missing half
of the beyond-reference DP-FedAvg feature — noise without a reported
epsilon is not a privacy guarantee. Pure NumPy host math; nothing here
touches the device.

A copy of ``privacy_preserve_federated_asr_tpu/federated/privacy.py`` (the
port imports nothing of the JAX package); the port's ``dp_fedavg`` is in
``parallel/fed.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

# Default integer Renyi orders. Dense where the optimum usually lives
# (moderate alpha for moderate epsilon), sparse tail for very tight
# (high-noise) regimes.
DEFAULT_ALPHAS: tuple[int, ...] = tuple(range(2, 65)) + (
    80, 96, 128, 192, 256, 384, 512, 1024)


def _log_binom(n: int, ks: np.ndarray) -> np.ndarray:
    """log C(n, k) via lgamma, exact in float64 for the n we use."""
    n_ = float(n)
    return (math.lgamma(n_ + 1.0)
            - np.vectorize(math.lgamma)(ks + 1.0)
            - np.vectorize(math.lgamma)(n_ - ks + 1.0))


def rdp_sampled_gaussian(
    q: float, sigma: float,
    alphas: tuple[int, ...] = DEFAULT_ALPHAS,
) -> np.ndarray:
    """Per-step RDP of the sampled Gaussian mechanism at integer orders.

    ``q`` is the subsampling rate (Poisson/uniform client sampling
    fraction), ``sigma`` the noise multiplier (noise std / L2 sensitivity).
    Returns an array aligned with ``alphas``. ``q == 0`` releases nothing
    (RDP 0); ``q == 1`` reduces to the plain Gaussian ``alpha/(2 sigma^2)``;
    ``sigma == 0`` is infinite.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate q must be in [0, 1], got {q}")
    if sigma < 0.0:
        raise ValueError(f"noise multiplier must be >= 0, got {sigma}")
    a = np.asarray(alphas, dtype=np.int64)
    if np.any(a < 2):
        raise ValueError("integer RDP orders must be >= 2")
    if q == 0.0:
        return np.zeros(len(a), dtype=np.float64)
    if sigma == 0.0:
        return np.full(len(a), np.inf)
    if q == 1.0:
        return a.astype(np.float64) / (2.0 * sigma * sigma)
    out = np.empty(len(a), dtype=np.float64)
    log_q, log_1mq = math.log(q), math.log1p(-q)
    inv2s2 = 1.0 / (2.0 * sigma * sigma)
    for i, alpha in enumerate(a):
        k = np.arange(alpha + 1, dtype=np.float64)
        log_terms = (_log_binom(int(alpha), k)
                     + (alpha - k) * log_1mq + k * log_q
                     + k * (k - 1.0) * inv2s2)
        m = log_terms.max()
        log_moment = m + math.log(np.exp(log_terms - m).sum())
        out[i] = max(log_moment / (alpha - 1.0), 0.0)
    return out


def rdp_to_epsilon(
    rdp: np.ndarray, delta: float,
    alphas: tuple[int, ...] = DEFAULT_ALPHAS,
) -> tuple[float, int]:
    """(epsilon, best_alpha) from accumulated RDP via the improved
    conversion (Canonne-Kamath-Steinke 2020, Prop. 12):

        eps(alpha) = rdp(alpha) + log((alpha-1)/alpha)
                     - (log delta + log alpha) / (alpha - 1)
    """
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    a = np.asarray(alphas, dtype=np.float64)
    rdp = np.asarray(rdp, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        eps = (rdp + np.log((a - 1.0) / a)
               - (math.log(delta) + np.log(a)) / (a - 1.0))
    eps = np.where(np.isnan(eps), np.inf, eps)
    j = int(np.argmin(eps))
    return max(float(eps[j]), 0.0), int(alphas[j])


def epsilon_for_rounds(
    rounds: int, q: float, sigma: float, delta: float,
    alphas: tuple[int, ...] = DEFAULT_ALPHAS,
) -> float:
    """epsilon after ``rounds`` homogeneous DP-FedAvg rounds."""
    if rounds <= 0:
        return 0.0
    eps, _ = rdp_to_epsilon(
        rounds * rdp_sampled_gaussian(q, sigma, alphas), delta, alphas)
    return eps


def noise_for_epsilon(
    rounds: int, q: float, target_epsilon: float, delta: float,
    lo: float = 0.05, hi: float = 100.0, tol: float = 1e-4,
) -> float:
    """Smallest noise multiplier sigma with
    ``epsilon_for_rounds(rounds, q, sigma, delta) <= target_epsilon`` —
    the planning question practitioners actually ask ("what noise do I
    need for eps <= 8 over my run?"). Bisection on the (tested) fact that
    epsilon is monotone decreasing in sigma. Raises if the bracket can't
    reach the target (target too tight for [lo, hi])."""
    if target_epsilon <= 0.0:
        raise ValueError(f"target_epsilon must be > 0, got {target_epsilon}")
    if epsilon_for_rounds(rounds, q, hi, delta) > target_epsilon:
        raise ValueError(
            f"target epsilon {target_epsilon} unreachable even at "
            f"sigma={hi} for rounds={rounds}, q={q}, delta={delta}")
    if epsilon_for_rounds(rounds, q, lo, delta) <= target_epsilon:
        return lo
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if epsilon_for_rounds(rounds, q, mid, delta) <= target_epsilon:
            hi = mid
        else:
            lo = mid
    return hi


@dataclass
class DpAccountant:
    """Accumulates RDP across (possibly heterogeneous) DP rounds.

    The federated engine calls :meth:`step` once per noised round (q and
    sigma may differ across stages); :meth:`epsilon` converts the running
    total at any point. ``total_rdp`` composes linearly, so state is one
    float per alpha — checkpoint-friendly (``state_dict``/``load_state``).
    """
    delta: float = 1e-5
    alphas: tuple[int, ...] = DEFAULT_ALPHAS
    total_rdp: np.ndarray = field(default=None)  # type: ignore[assignment]
    steps: int = 0

    def __post_init__(self) -> None:
        if self.total_rdp is None:
            self.total_rdp = np.zeros(len(self.alphas), dtype=np.float64)

    def step(self, q: float, sigma: float, num_steps: int = 1) -> None:
        if num_steps < 0:
            raise ValueError("num_steps must be >= 0")
        if num_steps:
            self.total_rdp = (self.total_rdp
                              + num_steps * rdp_sampled_gaussian(
                                  q, sigma, self.alphas))
            self.steps += num_steps

    def epsilon(self, delta: float | None = None) -> float:
        d = self.delta if delta is None else delta
        if self.steps == 0:
            return 0.0
        eps, _ = rdp_to_epsilon(self.total_rdp, d, self.alphas)
        return eps

    def state_dict(self) -> dict:
        return {"delta": self.delta, "steps": self.steps,
                "alphas": list(self.alphas),
                "total_rdp": self.total_rdp.tolist()}

    @classmethod
    def from_state(cls, state: dict) -> "DpAccountant":
        return cls(delta=float(state["delta"]),
                   alphas=tuple(int(x) for x in state["alphas"]),
                   total_rdp=np.asarray(state["total_rdp"], np.float64),
                   steps=int(state["steps"]))
