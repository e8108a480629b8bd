"""Batched inference engine, the serving path (the port's
``serving/engine.py``).

* **Buckets**: incoming audio is padded up to quantized time buckets
  (multiples of ``time_multiple``, capped at ``max_seconds``) and batches
  are padded to a fixed ``batch_size``, as in the JAX engine, so the set of
  shapes the card sees is bounded and :meth:`InferenceEngine.warmup` can
  touch each one at startup.
* **Micro-batching**: concurrent requests are coalesced into one device
  batch (up to ``batch_size``, waiting at most ``batch_window_ms``) by a
  single dispatcher thread.

Outputs per utterance: the CTC transcript (greedy, or with ``beam_size > 0``
prefix beam search on the host over the forward's fp32 log-posteriors,
``ops/beam.py``, optionally with shallow LM fusion through ``lm_fn``), the
reference's frame-majority AD vote (federated/src/update.py:162-212
``map_to_result``) and the mean AD probability over valid frames.

**Stage-2 Gumbel noise.** The model draws its toggling masks from Gumbel
noise. Every forward reseeds the engine's own ``torch.Generator`` (on the
engine's device) with 0 and draws noise of the batch's shape
``[batch_size, T, D, 2]``, so a stage-2 answer is a function of the audio,
its bucket and its row in the batch, never of earlier requests. This is the
JAX engine's property (it passes ``PRNGKey(0)`` on every forward), but not
its stream: JAX's and torch's generators give different numbers, so stage-2
parity with JAX is held at the model level with injected noise. Stages 0
and 1 serve unmasked streams, where the noise plays no part.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``; with
the default device and no GPU it raises. Only ``transport="float32"`` is
ported; ``"int16"`` raises.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from ..data.audio import normalize_input_values
from ..data.tokenizer import CTCCharTokenizer
from ..models.config import DACSConfig
from ..models.recipes import get_recipe
from ..ops.beam import beam_search_batch
from ..ops.decode import ad_vote, greedy_ids


@dataclass
class ServingConfig:
    batch_size: int = 8
    time_multiple: int = 16000       # bucket quantum (1 s @ 16 kHz)
    max_seconds: float = 30.0        # longest accepted utterance
    batch_window_ms: float = 10.0    # micro-batch coalescing window
    normalize: bool = True           # feature-extractor normalization
    compute_dtype: str = "bfloat16"  # "float32" | "bfloat16"
    # 0 = greedy (reference parity); >0 = CTC prefix beam search on the
    # host over the device log-posteriors (ops/beam.py), optionally with
    # shallow LM fusion via ``lm_fn`` passed to InferenceEngine
    beam_size: int = 0
    lm_alpha: float = 0.3
    lm_beta: float = 0.0
    transport: str = "float32"       # "int16" waits for its slice


@dataclass
class InferenceResult:
    transcript: str
    ad_pred: int            # reference frame-majority vote
    ad_prob: float          # mean P(AD) over valid frames
    frames: int             # valid encoder frames
    samples: int            # input samples consumed


def resolve_device(device: str | torch.device) -> torch.device:
    """An entry point's device; a CUDA device without a GPU raises (the
    port never carries on quietly on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port runs on cuda by default and no CUDA "
                           "device is available; pass device='cpu' to run on "
                           "the CPU")
    return device


class InferenceEngine:
    """Bucketed, micro-batched forward over the method's model.

    ``state_dict`` holds the port's DACSModel weights (models/port.py);
    ``lm_fn`` is the beam search's shallow-fusion LM (``prefix ids -> [V]
    log P(next | prefix)``, e.g. ``ops.beam.CharBigramLM``).
    ``infer_batch`` is the synchronous core; ``submit``/``infer`` go through
    the micro-batching dispatcher (start it with :meth:`start`).
    """

    def __init__(self, cfg: DACSConfig, state_dict: Mapping[str, torch.Tensor],
                 tokenizer: CTCCharTokenizer | None = None,
                 scfg: ServingConfig | None = None,
                 lm_fn=None,
                 device: str | torch.device = "cuda"):
        scfg = scfg if scfg is not None else ServingConfig()
        if scfg.transport != "float32":
            raise NotImplementedError(
                f"transport={scfg.transport!r} is not ported yet (float32 only)")
        self.device = resolve_device(device)
        cfg, dtype = cfg.resolve_compute(scfg.compute_dtype)
        self.cfg, self.scfg = cfg, scfg
        self.tokenizer = tokenizer or CTCCharTokenizer()
        self._lm_fn = lm_fn
        self.recipe = get_recipe(cfg.method)
        with torch.device("meta"):
            model = self.recipe.make_model(cfg, dtype)
        model = model.to_empty(device=self.device)
        model.load_state_dict(state_dict, strict=True)
        self.model = model.eval().requires_grad_(False)
        self._generator = torch.Generator(self.device)
        # one forward at a time: the reseeded generator and the launch
        # counters must not interleave between threads
        self._forward_lock = threading.Lock()
        self.forwards = 0  # batch forwards run (each is one padded batch)
        self._queue: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()

    # ---- the device forward ----

    def _forward(self, iv: np.ndarray, il: np.ndarray):
        # inference_mode is thread-local: entered here, in whichever thread
        # (caller or dispatcher) runs the forward
        with self._forward_lock, torch.inference_mode():
            x = torch.from_numpy(iv).to(self.device)
            lengths = torch.from_numpy(il).to(self.device)
            self._generator.manual_seed(0)
            out = self.model(x, lengths, generator=self._generator)
            logits, dlog = self.recipe.eval_streams(out, self.cfg)
            fm = out.frame_mask
            pred = greedy_ids(logits, fm, self.cfg.backbone.pad_token_id)
            ad_pred = ad_vote(dlog, fm)
            probs = torch.softmax(dlog.float(), dim=-1)[..., 1]
            fmf = fm.float()
            ad_prob = (probs * fmf).sum(-1) / fmf.sum(-1).clamp_min(1.0)
            got = [pred, ad_pred, ad_prob, out.frame_lengths]
            if self.scfg.beam_size > 0:  # the host's beam decode reads them
                got.append(torch.log_softmax(logits.float(), dim=-1))
            self.forwards += 1
            return tuple(t.cpu().numpy() for t in got)

    # ---- shape management ----

    @property
    def max_samples(self) -> int:
        return int(self.scfg.max_seconds * 16000)

    def _bucket(self, n_samples: int) -> int:
        q = self.scfg.time_multiple
        return min(-(-max(n_samples, 1) // q) * q, self.max_samples)

    def _buckets(self) -> list[int]:
        q = self.scfg.time_multiple
        grid = list(range(q, self.max_samples + 1, q))
        if not grid or grid[-1] != self.max_samples:
            # max_seconds not on the grid: the capped bucket is reachable
            grid.append(self.max_samples)
        return grid

    def warmup(self, buckets: Sequence[int] | None = None) -> int:
        """Run one full batch per bucket shape up front (kernel build,
        cuDNN algorithm choice, allocator growth); returns the count."""
        buckets = list(buckets) if buckets is not None else self._buckets()
        bs = self.scfg.batch_size
        for t in buckets:
            self._forward(np.zeros((bs, t), np.float32), np.full((bs,), t, np.int32))
        return len(buckets)

    # ---- synchronous batched inference ----

    def infer_batch(self, arrays: Sequence[np.ndarray]) -> list[InferenceResult]:
        """Run padded device batches over ``arrays`` (float waveforms at
        16 kHz). Arrays longer than ``max_seconds`` are truncated; the batch
        is split into chunks of ``batch_size``."""
        out: list[InferenceResult] = []
        bs = self.scfg.batch_size
        for i in range(0, len(arrays), bs):
            out.extend(self._infer_chunk(arrays[i : i + bs]))
        return out

    def _infer_chunk(self, arrays: Sequence[np.ndarray]) -> list[InferenceResult]:
        bs = self.scfg.batch_size
        xs = []
        for a in arrays:
            a = np.asarray(a, np.float32).reshape(-1)[: self.max_samples]
            if self.scfg.normalize:
                a = normalize_input_values(a)
            xs.append(a)
        t = self._bucket(max(len(a) for a in xs))
        iv = np.zeros((bs, t), np.float32)
        il = np.zeros((bs,), np.int32)
        for i, a in enumerate(xs):
            n = min(len(a), t)
            iv[i, :n] = a[:n]
            il[i] = n
        got = self._forward(iv, il)
        pred, ad_pred, ad_prob, flen = got[:4]
        n = len(xs)
        if self.scfg.beam_size > 0:
            beams = beam_search_batch(
                got[4][:n], flen[:n], beam_size=self.scfg.beam_size,
                blank_id=self.cfg.backbone.pad_token_id, lm_fn=self._lm_fn,
                lm_alpha=self.scfg.lm_alpha, lm_beta=self.scfg.lm_beta)
            # beam ids are already CTC-collapsed: decode without grouping
            # (legitimate repeated characters must survive)
            texts = [self.tokenizer.decode(b[0].ids, group_tokens=False) for b in beams]
        else:
            texts = [self.tokenizer.decode(pred[i]) for i in range(n)]
        return [
            InferenceResult(
                transcript=texts[i],
                ad_pred=int(ad_pred[i]),
                ad_prob=float(ad_prob[i]),
                frames=int(flen[i]),
                samples=int(il[i]),
            )
            for i in range(len(xs))
        ]

    # ---- micro-batching dispatcher ----

    def start(self) -> None:
        """Start the micro-batching dispatcher thread (idempotent)."""
        if self._worker is not None and self._worker.is_alive():
            return
        self._stop.clear()
        self._worker = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._queue.put(None)  # wake the dispatcher
            self._worker.join(timeout=5)
            self._worker = None
        # fail any request still queued rather than leaving its Future
        # pending forever
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("inference engine stopped"))

    def submit(self, array: np.ndarray) -> "Future[InferenceResult]":
        """Enqueue one utterance; resolves when its micro-batch runs."""
        fut: Future = Future()
        self._queue.put((array, fut))
        return fut

    def infer(self, array: np.ndarray, timeout: float | None = 60.0) -> InferenceResult:
        if self._worker is None or not self._worker.is_alive():
            return self.infer_batch([array])[0]
        return self.submit(array).result(timeout=timeout)

    def _dispatch_loop(self) -> None:
        window = self.scfg.batch_window_ms / 1e3
        bs = self.scfg.batch_size
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                continue
            batch = [item]
            # the deadline is fixed from the FIRST item, so no request waits
            # more than batch_window_ms before its batch launches
            deadline = time.monotonic() + window
            while len(batch) < bs:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            futures = [f for _, f in batch]
            try:
                results = self.infer_batch([a for a, _ in batch])
                for f, r in zip(futures, results):
                    f.set_result(r)
            except Exception as e:  # propagate to every waiter
                for f in futures:
                    if not f.done():
                        f.set_exception(e)
