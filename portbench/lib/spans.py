"""The card's idle time of a traced sub-window, split by the program's own
spans (``utils/profiling.py`` in the port: ``dacs.train.*``,
``dacs.ctc.*``), and the CTC loss's launches.

Each gap between the merged device intervals is split by time against the
span intervals of the profiler's CPU events, from whichever thread opened
them (the CTC backward runs on autograd's device thread). Where spans
overlap, one phase takes the time, in the order of ``PHASES``: the CTC
spans sit inside the loss and the backward, the optimizer after both. The
idle time outside every phase (the gather, between steps, the edges of the
sub-window) is ``other``, so the shares add up to ``idle.train``. A trace
without the program's spans (a program that has none) reads None.
"""

from __future__ import annotations

import bisect

from portbench.lib.trace import merged

# phase -> its spans, in precedence order
PHASES = {
    "ctc": ("dacs.ctc.forward", "dacs.ctc.backward"),
    "optim": ("dacs.train.optim",),
    "backward": ("dacs.train.backward",),
    "forward": ("dacs.train.forward", "dacs.train.loss"),
}
SPAN_PREFIX = "dacs."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def subtract(a: list, b: list) -> list:
    """The sorted disjoint intervals ``a`` less the sorted disjoint ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def overlap(a: list, b: list) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def gaps(trace) -> list:
    """The idle gaps between the merged device intervals (µs)."""
    busy = merged((a, b) for _, a, b in trace.device)
    return [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0]


def idle_split(obs) -> dict | None:
    """Percent of the sub-window the card idled in each phase of
    ``PHASES`` (None where the phase has no span in the trace) and in
    ``other``; None without a trace or without any of the spans."""
    tr = obs.get("trace")
    if tr is None:
        return None
    spans = [(n, a, b) for n, a, b in tr.cpu if n.startswith(SPAN_PREFIX)]
    if not spans:
        return None
    idle, taken, out = gaps(tr), [], {}
    for phase, names in PHASES.items():
        mine = merged((a, b) for n, a, b in spans if n in names)
        if not mine:
            out[phase] = None
            continue
        own = subtract(mine, taken)
        out[phase] = 100.0 * overlap(idle, own) / 1e6 / tr.window_s
        taken = merged(taken + mine)
    named = sum(v for v in out.values() if v is not None)
    out["other"] = 100.0 * (1.0 - tr.busy_s / tr.window_s) - named
    return out


def ctc_launches(obs) -> float | None:
    """Kernel launches (``cudaLaunchKernel*`` and ``cuLaunchKernel*``
    calls) that start inside a CTC span, per traced step; None without a
    trace or without the spans."""
    tr = obs.get("trace")
    if tr is None:
        return None
    ctc = merged((a, b) for n, a, b in tr.cpu if n in PHASES["ctc"])
    if not ctc:
        return None
    lefts = [a for a, _ in ctc]
    n = 0
    for name, a, _ in tr.cpu:
        if name.startswith(LAUNCHES):
            i = bisect.bisect_right(lefts, a) - 1
            n += i >= 0 and a <= ctc[i][1]
    return n / obs["trace_steps"]
