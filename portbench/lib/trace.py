"""A traced sub-window: ``torch.profiler`` over a short stretch of the
cell's own load, read in memory (no trace file is written).

From the profiler's events it gives the device's busy seconds (the union of
the device intervals, so overlapping kernels count once), the host-clock
length of the sub-window, kernel time by name, host time under named CPU
events, and the longest idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

SPAN = "portbench."  # the prefix of the harness's own spans


def busy_seconds(intervals) -> float:
    """Seconds in which at least one of the ``(start_us, end_us)``
    intervals ran (their union)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """The events of one profiled sub-window."""

    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.cpu = [(e.name, e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CPU]
        # a record_function range also shows on the device timeline as a user
        # annotation of the same name: it is no device work
        ranges = {name for name, _, _ in self.cpu}
        self.device = [(e.name, e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and e.name not in ranges
                       and not getattr(e, "is_user_annotation", False)]

    @property
    def busy_s(self) -> float:
        return busy_seconds((a, b) for _, a, b in self.device)

    def kernel_seconds(self, fragment: str) -> tuple[float, int]:
        """Summed time and count of the device events whose name holds
        ``fragment``."""
        hits = [b - a for name, a, b in self.device if fragment in name]
        return sum(hits) / 1e6, len(hits)

    def host_seconds(self, names: set[str]) -> tuple[float, int]:
        """Summed time and count of the CPU events named one of ``names``."""
        hits = [b - a for name, a, b in self.cpu if name in names]
        return sum(hits) / 1e6, len(hits)

    def breakdown(self, top: int = 10, min_gap_us: float = 10.0) -> dict:
        """The device operations that took most time, and the idle gaps by
        what the host ran during them: the outermost harness span and the
        innermost operation that is not a CUDA runtime call (among the last
        500 to start), at the gap's middle. Gaps under ``min_gap_us`` are
        launch spacing, summed apart."""
        by_kernel = defaultdict(float)
        for name, a, b in self.device:
            by_kernel[name[:120]] += (b - a) / 1e6
        device_ops = [[k, v] for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]]
        busy = merged((a, b) for _, a, b in self.device)
        ops = sorted((a, b, name) for name, a, b in self.cpu
                     if not name.startswith(("cuda", "cu", SPAN)))
        spans = [(a, b, name) for name, a, b in self.cpu if name.startswith(SPAN)]
        starts = [c[0] for c in ops]
        gaps = defaultdict(float)
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            width = s1 - e0
            if width < min_gap_us:
                gaps[f"launch spacing <{min_gap_us:g}us"] += width / 1e6
                continue
            gaps[self._host_at((e0 + s1) / 2, ops, starts, spans)] += width / 1e6
        idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": device_ops, "idle_gaps": [[k, v] for k, v in idle_gaps]}

    @staticmethod
    def _host_at(t: float, ops, starts, spans, scan: int = 500) -> str:
        i = bisect.bisect_right(starts, t)
        inner = [c for c in ops[max(0, i - scan):i] if c[1] >= t]
        outer = [c for c in spans if c[0] <= t <= c[1]]
        name = min(outer)[2] if outer else "outside harness spans"
        return f"{name} / {max(inner)[2] if inner else 'no operation'}"[:120]


def _all_threads():
    """Record CPU operations of every thread (the serving engine runs its
    forwards in the dispatcher's thread), where this torch can."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@contextmanager
def traced(out: dict, device: torch.device):
    """Profile the body; ``out["trace"]`` then holds its :class:`Trace`, or
    None when the profiler recorded no device activity (always so on the
    CPU)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities, experimental_config=_all_threads()) as prof:
        t0 = time.perf_counter()
        yield
        sync()
        window = time.perf_counter() - t0
    tr = Trace(prof.events(), window)
    out["trace"] = tr if tr.device else None
