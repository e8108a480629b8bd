"""Traffic kind ``open_loop``: independent users, each sending one
recording, at Poisson arrivals of a fixed rate (``rate_rps``) whatever the
engine's pace. Each request is timed from when it was due to its answer, so
a stall counts against every request queued behind it; how late the sender
ran is printed on standard error.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import inputs
from portbench.lib.harness import Context, Outcome, free_memory, log
from portbench.lib.serving import Request, Served, judge, quantile, summary
from portbench.lib.trace import traced

WAIT_AFTER_S = 60.0  # how long past the schedule's end an answer may come


def open_loop(served: Served, pool: inputs.ClipPool, offsets, lengths,
              first: int) -> list[Request]:
    """Send one request at each offset (seconds from now); wait for all."""
    reqs = [Request(first + i, pool.cut(s)) for i, s in enumerate(lengths)]
    t0 = time.perf_counter() + 0.01
    for q, off in zip(reqs, offsets):
        q.t_due = t0 + float(off)
        delay = q.t_due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        served.submit(q)
    served.wait(len(reqs), t0 + float(offsets[-1]) + WAIT_AFTER_S)
    for q in reqs:
        if q.result is None:  # never came: it missed every limit
            q.t_done = t0 + float(offsets[-1]) + WAIT_AFTER_S
    return reqs


def lateness(reqs: list[Request]) -> str:
    late = np.array([q.t_sent - q.t_due for q in reqs]) * 1e3
    return (f"sender lateness ms: median {np.median(late):.3f}, p99 {quantile(late, 0.99):.3f},"
            f" max {late.max():.3f}")


def run(ctx: Context) -> Outcome:
    tr = ctx.traffic
    served = Served(ctx)
    pool = inputs.ClipPool(ctx.seed, tr["clips"], tr["clip_s"])
    rate = tr["rate_rps"]
    warm = inputs.arrival_offsets(tr, ctx.seed + 1, rate, tr["warmup_s"])
    open_loop(served, pool, warm, inputs.request_lengths(tr, ctx.seed + 1, len(warm)), 0)

    offsets = inputs.arrival_offsets(tr, ctx.seed, rate, ctx.seconds)
    lengths = inputs.request_lengths(tr, ctx.seed, len(offsets))
    forwards0 = served.engine.forwards
    reqs = open_loop(served, pool, offsets, lengths, len(served.requests))
    t0 = reqs[0].t_due
    forwards = served.engine.forwards - forwards0
    lat = [q.latency * 1e3 for q in reqs]
    log(f"window: {len(reqs)} requests at {rate} req/s over {ctx.seconds} s; {summary(reqs)}; "
        f"{lateness(reqs)}; {forwards} batch forwards")
    obs = {"requests": len(reqs), "forwards": forwards, "batch_size": tr["batch_size"],
           "latency_ms": lat}

    trace = None
    if ctx.trace:
        box: dict = {}
        part = offsets[offsets < tr["trace_s"]]
        with traced(box, ctx.device):
            open_loop(served, pool, part, lengths[:len(part)], len(served.requests))
        trace = box["trace"]
        obs["trace"] = trace

    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    served.stop()
    served.engine = None
    free_memory()
    checks = judge(ctx, served, reqs)
    obs["diag"] = served.diag
    failed = sum(q.result is None for q in reqs)
    return Outcome(e2e={"serve_p95_ms": quantile(lat, 0.95)}, attempted=len(reqs),
                   failed=failed, t_window=t0, memory_peak=peak, checks=checks, obs=obs,
                   trace=trace)
