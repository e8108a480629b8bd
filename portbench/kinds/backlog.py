"""Traffic kind ``backlog``: a closed loop that keeps ``outstanding``
requests queued at the engine, so full batches always wait (an offline
backlog being worked off).

The window starts with the first send; sends stop at ``--seconds`` and the
window ends with the last of the outstanding requests answered.
``serve_audio_s_per_s`` is the audio of every request of the window over
that wall time.
"""

from __future__ import annotations

import time

import torch

from portbench.lib import inputs
from portbench.lib.harness import Context, Outcome, free_memory, log
from portbench.lib.serving import Request, Served, forward_flops, judge, summary
from portbench.lib.trace import traced

ANSWER_WAIT_S = 120.0  # how long an outstanding request may take to come back


def closed_loop(served: Served, pool: inputs.ClipPool, lengths, first: int, depth: int,
                seconds: float) -> list[Request]:
    """Keep ``depth`` requests outstanding for ``seconds``, then drain."""
    reqs: list[Request] = []

    def send():
        q = Request(first + len(reqs), pool.cut(lengths[(first + len(reqs)) % len(lengths)]))
        reqs.append(q)
        served.submit(q)

    end = time.perf_counter() + seconds
    for _ in range(depth):
        send()
    outstanding = depth
    while outstanding:
        if served.wait(1, time.perf_counter() + ANSWER_WAIT_S) == 0:
            break  # what never came is counted as failed
        outstanding -= 1
        if time.perf_counter() < end:
            send()
            outstanding += 1
    return reqs


def run(ctx: Context) -> Outcome:
    tr = ctx.traffic
    served = Served(ctx)
    pool = inputs.ClipPool(ctx.seed, tr["clips"], tr["clip_s"])
    lengths = inputs.request_lengths(tr, ctx.seed, tr["grid"])
    closed_loop(served, pool, lengths, 0, tr["outstanding"], tr["warmup_s"])
    first = len(served.requests)

    t0 = time.perf_counter()
    reqs = closed_loop(served, pool, lengths, first, tr["outstanding"], ctx.seconds)
    done = [q for q in reqs if q.result is not None]
    window = max(q.t_done for q in done) - t0
    audio_s = sum(len(q.audio) for q in done) / inputs.SR
    log(f"window: {len(reqs)} requests, {audio_s:.1f} s of audio in {window:.3f} s; "
        f"{summary(reqs)}")
    obs = {"window_s": window, "flops": forward_flops(ctx, done)}

    trace = None
    if ctx.trace:
        start = len(served.batches)
        box: dict = {}
        with traced(box, ctx.device):
            closed_loop(served, pool, lengths, len(served.requests), tr["outstanding"],
                        tr["trace_s"])
        trace = box["trace"]
        batches = range(start, len(served.batches))
        obs.update(trace=trace, b1_least_s=served.b1_least_s(batches))

    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    served.stop()
    served.engine = None
    free_memory()
    checks = judge(ctx, served, reqs)
    obs["diag"] = served.diag
    failed = len(reqs) - len(done)
    return Outcome(e2e={"serve_audio_s_per_s": audio_s / window}, attempted=len(reqs),
                   failed=failed, t_window=t0, memory_peak=peak, checks=checks, obs=obs,
                   trace=trace)
