"""What the serving traffic kinds share: the engine under test behind its
micro-batching dispatcher, the record of which requests each batch held,
and the judgement of the answers against the plain reference.

Requests go in through ``InferenceEngine.submit`` and come back through
their futures. The harness wraps the engine's ``infer_batch`` (the
dispatcher's call into the forward) to note each batch's requests in row
order and to mark it as a span in traced runs; the stage-2 Gumbel noise of
a row depends on its batch's bucket and its row, so the reference needs
both.
"""

from __future__ import annotations

import queue
import statistics
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench.lib import inputs
from portbench.lib.counting import attention_call, serve_forward_flops
from portbench.lib.ctcgap import min_max_gap, text_ids
from portbench.lib.harness import Check, Context, log
from portbench.lib.program import dacs_config

SR = inputs.SR


@dataclass
class Request:
    i: int
    audio: np.ndarray
    t_due: float = 0.0      # when it was scheduled to be sent (perf_counter)
    t_sent: float = 0.0
    t_done: float = 0.0
    result: object = None   # the engine's InferenceResult
    error: str | None = None
    batch: int = -1         # index into Served.batches
    row: int = -1

    @property
    def latency(self) -> float:
        return self.t_done - self.t_due


class Served:
    """The port's ``InferenceEngine`` at stage 2, warmed on the mix's
    buckets, its dispatcher running."""

    def __init__(self, ctx: Context):
        from privacy_preserve_federated_asr_tpu_torch.serving.engine import (
            InferenceEngine,
            ServingConfig,
        )

        cfgj, tr = ctx.config, ctx.traffic
        self.ctx = ctx
        self.scfg = ServingConfig(
            batch_size=tr["batch_size"], time_multiple=tr["time_multiple"],
            max_seconds=tr["max_seconds"], batch_window_ms=tr["batch_window_ms"],
            compute_dtype="int8" if ctx.control else cfgj["compute_dtype"],
            transport=tr["transport"])
        weights = inputs.draw_weights(cfgj, ctx.seed, ctx.device, served_dtype(cfgj))
        self.engine = InferenceEngine(dacs_config(cfgj, stage=2), weights, scfg=self.scfg,
                                      device=ctx.device)
        del weights
        lo, hi = tr["warmup_buckets_s"]
        self.engine.warmup([s * SR for s in range(lo, hi + 1)])
        self.batches: list[list[int]] = []
        self.requests: dict[int, Request] = {}
        self._by_array: dict[int, Request] = {}
        self.done: queue.Queue = queue.Queue()
        self.diag: dict = {}  # numbers the judgement prints but does not compare
        forward = self.engine.infer_batch

        def infer_batch(arrays):
            rows = [self._by_array[id(a)] for a in arrays]
            for r, q in enumerate(rows):
                q.batch, q.row = len(self.batches), r
            self.batches.append([q.i for q in rows])
            with torch.profiler.record_function("portbench.engine.infer_batch"):
                return forward(arrays)

        self.engine.infer_batch = infer_batch
        self.engine.start()

    def submit(self, q: Request) -> None:
        self.requests[q.i] = q
        self._by_array[id(q.audio)] = q
        q.t_sent = time.perf_counter()
        if not q.t_due:
            q.t_due = q.t_sent
        self.engine.submit(q.audio).add_done_callback(lambda f, q=q: self._finish(q, f))

    def _finish(self, q: Request, fut) -> None:
        q.t_done = time.perf_counter()
        try:
            q.result = fut.result()
        except Exception as e:  # the request failed: counted, and its waiter told
            q.error = repr(e)
        self.done.put(q)

    def wait(self, n: int, deadline: float) -> int:
        """Wait for ``n`` completions until ``deadline``; returns how many came."""
        got = 0
        while got < n:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                self.done.get(timeout=left)
            except queue.Empty:
                break
            got += 1
        return got

    def stop(self) -> None:
        self.engine.stop()

    def batch_rows(self, batch: int) -> list[int]:
        """Valid frames of each request of a batch (the rows B1 attends)."""
        from portbench.reference.ssl_dacs import conv_out_frames

        cap = int(self.scfg.max_seconds * SR)
        return [conv_out_frames(self.ctx.config, min(len(self.requests[i].audio), cap))
                for i in self.batches[batch]]

    def b1_least_s(self, batches) -> float:
        """Least time of the B1 calls of ``batches`` (one per layer each)."""
        cfgj = self.ctx.config
        h = cfgj["num_attention_heads"]
        total = sum(attention_call(self.batch_rows(b), None, h, cfgj["hidden_size"] // h).least_s
                    for b in batches)
        return total * cfgj["num_hidden_layers"]


def served_dtype(cfgj: dict) -> torch.dtype:
    """The type the weights are served in: the engine stores its matmul and
    conv weights in the compute dtype."""
    return getattr(torch, cfgj["compute_dtype"])


def forward_flops(ctx: Context, reqs) -> float:
    cap = int(ctx.traffic["max_seconds"] * SR)
    return serve_forward_flops(ctx.config, [min(len(q.audio), cap) for q in reqs])


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0..1) by linear interpolation between order
    statistics."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def judge(ctx: Context, served: Served, reqs: list[Request]) -> list[Check]:
    """Compare a seeded sample of the finished requests, the longest among
    them, with the reference served the same way (same bucket, same row of
    the same noise). Call once the engine is freed.

    ``ctc_tail_share``: of the sample's served frames, the share whose token
    lies more than ``ctc_tail_over`` logits below the reference's best, on
    the path most favourable to the served transcript. The toggling masks
    are Gumbel argmaxes: rounding flips the near-ties, so the widest gap is
    set by a few flipped channels and barely grows with the error, while
    the share of frames past a fixed gap does (PERF.md gives the readings).
    ``frames_mismatch``: requests whose frame count differs (exact)."""
    from portbench.reference import ssl_dacs as ref

    cfgj, tr = ctx.config, ctx.traffic
    finished = [q for q in reqs if q.result is not None]
    if not finished:
        return [Check("finished_requests", 0.0, -1.0)]
    longest = max(finished, key=lambda q: len(q.audio))
    others = [q for q in finished if q is not longest]
    r = inputs.rng(ctx.seed, 6)
    pick = [longest] + [others[i] for i in
                        r.choice(len(others), min(tr["check_sample"] - 1, len(others)),
                                 replace=False)]
    ref.fp32_only()
    w = {k: v.float() for k, v in
         inputs.draw_weights(cfgj, ctx.seed, ctx.device, served_dtype(cfgj)).items()}
    q_t, cap = tr["time_multiple"], int(tr["max_seconds"] * SR)
    vocab = cfgj["vocab"]
    blank_like = tuple(vocab.index(t) for t in ("<pad>", "<s>", "</s>"))
    over = ctx.limits["ctc_tail_over"]
    delim = vocab.index("|")
    widest = ad_gap = 0.0
    frames_off = frames = tail = 0
    t0 = time.perf_counter()
    for q in pick:
        longest_in_batch = max(min(len(served.requests[i].audio), cap)
                               for i in served.batches[q.batch])
        bucket = min(-(-max(longest_in_batch, 1) // q_t) * q_t, cap)
        out = ref.serve_row(cfgj, w, q.audio, bucket, tr["batch_size"], q.row, ctx.device)
        ids = text_ids(q.result.transcript, vocab)
        logits = out["logits"].numpy()
        frames += out["frames"]
        tail += min_max_gap(logits, ids, blank_like, delim, total=True, over=over)
        widest = max(widest, min_max_gap(logits, ids, blank_like, delim))
        ad_gap = max(ad_gap, abs(q.result.ad_prob - out["ad_prob"]))
        frames_off += int(q.result.frames != out["frames"])
    log(f"reference: {len(pick)} requests ({frames} served frames, the longest "
        f"{len(longest.audio) / SR:.2f} s) in {time.perf_counter() - t0:.1f} s; not "
        f"compared (no separating reading): widest gap {widest:.4g}, AD prob gap {ad_gap:.4g}")
    served.diag = {"ctc_widest_gap": widest, "ad_prob_gap": ad_gap}
    return [Check("ctc_tail_share", tail / max(frames, 1), ctx.limits["ctc_tail_share"]),
            Check("frames_mismatch", frames_off, 0.0)]


def summary(reqs: list[Request]) -> str:
    lat = [q.latency * 1e3 for q in reqs if q.result is not None]
    if not lat:
        return "no request finished"
    return (f"{len(lat)} finished, latency ms p50 {statistics.median(lat):.1f} "
            f"p95 {quantile(lat, 0.95):.1f} max {max(lat):.1f}")
