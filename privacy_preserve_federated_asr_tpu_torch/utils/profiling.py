"""Tracing / profiling utilities (the port's ``utils/profiling.py``).

  * ``trace_profile`` — context manager around ``torch.profiler`` (host and,
    where there is a card, CUDA activity) that writes a Chrome trace
    (``trace.json``, loadable in Perfetto or chrome://tracing) into
    ``log_dir``,
  * ``StepProfiler`` — host-side per-step wall-clock histogram with
    percentile summary (catches stragglers that averages hide); a copy of
    the JAX package's.

The JAX module's ``enable_tpu_fast_rng`` (switch JAX's PRNG to the TPU's
hardware RBG) has no meaning in torch and is not ported.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np


@contextlib.contextmanager
def trace_profile(log_dir: str = "./saves/profile"):
    """Profile the ``with`` body; on exit ``<log_dir>/trace.json`` holds its
    Chrome trace. Yields the ``torch.profiler.profile`` object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepProfiler:
    def __init__(self):
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p90_ms": float(np.percentile(t, 90) * 1e3),
            "max_ms": float(t.max() * 1e3),
        }
