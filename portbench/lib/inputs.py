"""What the benchmark makes from ``--seed``: weights, audio, labels and
request schedules. The same seed gives the same inputs; the program and the
reference are handed the same ones.

Where a traffic mix fixes a distribution, every seed gets the same set of
sizes and gaps (evenly spaced quantiles of the distribution) in its own
order, so seeds change the order of the work and not its amount.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.ssl_dacs import is_norm_weight, param_shapes

SR = 16000


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream per use of the seed."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def draw_weights(cfg: dict, seed: int, device,
                 dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Every parameter on ``device``, drawn in one call in float32 and
    rounded to ``dtype`` (the type they are served or trained in): N(0,
    std) for matrices, convolutions and biases, 1 + N(0, std) for LayerNorm
    weights."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(total, generator=g, device=device).mul_(cfg["init_std"])
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        if is_norm_weight(name):
            t.add_(1.0)
        out[name] = t
        off += n
    if dtype != torch.float32:
        return {k: v.to(dtype) for k, v in out.items()}
    return out


def audio(r: np.random.Generator, n: int) -> np.ndarray:
    """Speech-like noise: Gaussian noise under a syllable-rate (3-6 Hz)
    envelope, float32."""
    t = np.arange(n, dtype=np.float32) / SR
    rate = r.uniform(3.0, 6.0)
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rate * t + r.uniform(0, 2 * np.pi))
    return (r.standard_normal(n, dtype=np.float32) * env * r.uniform(0.05, 0.5)).astype(
        np.float32)


def quantiles_uniform(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def quantiles_lognormal(median: float, sigma: float, lo: float, hi: float,
                        n: int) -> np.ndarray:
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(median * np.exp(sigma * z), lo, hi)


def quantiles_exponential(mean: float, n: int) -> np.ndarray:
    return -mean * np.log(1.0 - (np.arange(n) + 0.5) / n)


def lengths_from(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths in seconds from a traffic file's length spec."""
    if spec["dist"] == "uniform":
        return quantiles_uniform(spec["lo_s"], spec["hi_s"], n)
    if spec["dist"] == "lognormal":
        return quantiles_lognormal(spec["median_s"], spec["sigma"], spec["lo_s"],
                                   spec["hi_s"], n)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def train_corpus(traffic: dict, seed: int) -> dict:
    """Utterances of the trainer mix: waveforms, labels of ``label_chars``
    characters drawn from the letters, the apostrophe and the delimiter,
    and dementia labels."""
    n = traffic["batches"] * traffic["batch_size"]
    r = rng(seed, 1)
    secs = r.permutation(lengths_from(traffic["lengths"], n))
    waves = [audio(r, int(s * SR)) for s in secs]
    labels = r.integers(4, 32, size=(n, traffic["label_chars"])).astype(np.int32)
    dementia = r.integers(0, 2, size=n).astype(np.int32)
    return {"waves": waves, "labels": labels, "dementia": dementia}


class ClipPool:
    """Requests cut from a pool of recorded-like clips: each request is a
    view of one clip at a seeded offset."""

    def __init__(self, seed: int, clips: int, seconds: float):
        r = rng(seed, 2)
        self.clips = [audio(r, int(seconds * SR)) for _ in range(clips)]
        self.r = rng(seed, 3)

    def cut(self, seconds: float) -> np.ndarray:
        n = int(round(seconds * SR))
        clip = self.clips[int(self.r.integers(len(self.clips)))]
        off = int(self.r.integers(0, len(clip) - n + 1))
        return clip[off:off + n]


def request_lengths(traffic: dict, seed: int, n: int) -> np.ndarray:
    """Request lengths in seconds: the mix's quantile grid of ``grid``
    sizes in a seeded order, cycled to ``n``."""
    grid = rng(seed, 4).permutation(lengths_from(traffic["lengths"], traffic["grid"]))
    return np.resize(grid, n)


def arrival_offsets(traffic: dict, seed: int, rate: float, seconds: float) -> np.ndarray:
    """Poisson arrivals at ``rate`` per second over ``seconds``: the
    exponential quantile gaps of ``rate * seconds`` requests, in a seeded
    order, summed."""
    n = max(int(round(rate * seconds)), 1)
    gaps = rng(seed, 5).permutation(quantiles_exponential(1.0 / rate, n))
    return np.cumsum(gaps) - gaps[0]
