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

**Transport.** ``transport="float32"`` normalizes each utterance on the
host and uploads the padded fp32 batch; ``"int16"`` uploads each row as
abs-max-scaled int16 plus one fp32 scale, and dequantizes and normalizes on
the card (``_mask_normalize``, the masked twin of
``data/audio.normalize_input_values``). With ``normalize`` on, the row's
scale cancels in the normalization, so the only numeric effect is the int16
rounding.

**Resident streaming windows** (serving/streaming.py): a streaming session
keeps its audio window on the card (``alloc_stream_buffer``; a hub keeps
one row per member, ``alloc_stream_buffers``) and uploads only the audio
that arrived since its last pass (``append_stream``: pieces bucketed to
``STREAM_CHUNK_QUANTUM`` samples, split at ``STREAM_CHUNK_MAX``, int16 per
piece under the int16 transport; ``append_stream_batch``: one batched
frontier write for a hub). Every window is padded by ``STREAM_CHUNK_MAX``
samples, so a bucketed write never runs past its end, and the region beyond
a window's frontier stays zero, so a write of zeros there changes nothing.
``_forward_res`` / ``_forward_res_b`` slice the window(s) to the time bucket
and normalize on the card.

Every forward -- the numpy batch, the int16 batch and both resident ones --
goes through one tensor-in core (``_run``) that holds the forward lock,
reseeds the generator and counts ``forwards``; the dispatcher thread and the
HTTP stream threads share one engine. The window buffers are made and
written under ``torch.inference_mode``, like the forwards that read them.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``; with
the default device and no GPU it raises.
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
    # "float32" | "bfloat16" | "int8" (bf16 + W8A8 Dense matmuls, ops/quant.py)
    compute_dtype: str = "bfloat16"
    # 0 = greedy (reference parity); >0 = CTC prefix beam search on the
    # host over the device log-posteriors (ops/beam.py), optionally with
    # shallow LM fusion via ``lm_fn`` passed to InferenceEngine
    beam_size: int = 0
    lm_alpha: float = 0.3
    lm_beta: float = 0.0
    # sample-count buckets to warm at startup; () = every bucket of the grid
    warmup_buckets: tuple[int, ...] = ()
    # host->device waveform encoding of the batch path: "float32" | "int16"
    # (abs-max-scaled int16 + one fp32 scale per row, dequantized and
    # normalized on the card)
    transport: str = "float32"


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
        if scfg.transport not in ("float32", "int16"):
            raise ValueError(f"unknown transport {scfg.transport!r}")
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
        # bytes uploaded to the device (every path); stream threads upload
        # outside the forward lock, so the count has a lock of its own
        self.h2d_bytes = 0
        self._h2d_lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()

    # ---- the device forward ----

    def _run(self, x: torch.Tensor, lengths: torch.Tensor):
        """The tensor-in core of every forward: ``x [B, t]`` float32 model
        input on the device, ``lengths [B]`` int32. Returns numpy (pred,
        ad_pred, ad_prob, frame_lengths[, fp32 log-posteriors])."""
        # inference_mode is thread-local: entered here, in whichever thread
        # (caller, dispatcher or stream handler) runs the forward
        with self._forward_lock, torch.inference_mode():
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

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        with self._h2d_lock:
            self.h2d_bytes += a.nbytes
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _mask_normalize(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Masked zero-mean/unit-variance normalization of ``x [B, t]`` over
        each row's first ``lengths`` samples, zeros beyond (the device twin
        of data/audio.normalize_input_values; used by the int16 batch path
        and the resident forwards)."""
        t = x.shape[1]
        mask = (torch.arange(t, device=x.device)[None, :] < lengths[:, None]).float()
        if self.scfg.normalize:
            cnt = lengths.float().clamp_min(1.0)
            mean = (x * mask).sum(-1) / cnt
            var = ((x - mean[:, None]).square() * mask).sum(-1) / cnt
            x = (x - mean[:, None]) / torch.sqrt(var + 1e-7)[:, None]
        return x * mask

    def _forward(self, iv: np.ndarray, il: np.ndarray):
        """The float32 batch: ``iv [B, t]`` model input (host-normalized)."""
        with torch.inference_mode():
            return self._run(self._upload(iv), self._upload(il))

    def _forward_i16(self, iv: np.ndarray, scales: np.ndarray, il: np.ndarray):
        """The int16 batch: ``iv [B, t]`` int16 and ``scales [B]`` fp32,
        dequantized and mask-normalized on the device."""
        with torch.inference_mode():
            x = self._upload(iv).float() * self._upload(scales)[:, None]
            lengths = self._upload(il)
            return self._run(self._mask_normalize(x, lengths), lengths)

    def _forward_res(self, buf: torch.Tensor, n: int, t: int):
        """One resident window: the first ``t`` samples of ``buf``, ``n``
        of them valid (a one-row :meth:`_forward_res_b`)."""
        return self._forward_res_b(buf[None], [n], t)

    def _forward_res_b(self, bufs: torch.Tensor, ils: np.ndarray, t: int):
        """A hub's stacked windows: the first ``t`` samples of every row,
        ``ils[r]`` of row ``r`` valid (0 for a free row)."""
        with torch.inference_mode():
            lengths = self._upload(np.asarray(ils, np.int32))
            return self._run(self._mask_normalize(bufs[:, :t], lengths), lengths)

    # ---- shape management ----

    @property
    def max_samples(self) -> int:
        return int(self.scfg.max_seconds * 16000)

    def _bucket(self, n_samples: int) -> int:
        q = self.scfg.time_multiple
        return min(-(-max(n_samples, 1) // q) * q, self.max_samples)

    def _buckets(self) -> list[int]:
        if self.scfg.warmup_buckets:
            return sorted(set(self._bucket(b) for b in self.scfg.warmup_buckets))
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
            il = np.full((bs,), t, np.int32)
            if self.scfg.transport == "int16":
                self._forward_i16(np.zeros((bs, t), np.int16), np.ones((bs,), np.float32), il)
            else:
                self._forward(np.zeros((bs, t), np.float32), il)
        return len(buckets)

    # ---- resident streaming windows (serving/streaming.py) ----

    # chunk uploads are bucketed to STREAM_CHUNK_QUANTUM samples; feeds
    # larger than STREAM_CHUNK_MAX are split on the host, and every window
    # is padded by STREAM_CHUNK_MAX so a bucketed write stays inside it
    STREAM_CHUNK_QUANTUM = 2048
    STREAM_CHUNK_MAX = 65536

    @property
    def stream_window(self) -> int:
        return self.max_samples + self.STREAM_CHUNK_MAX

    def alloc_stream_buffer(self) -> torch.Tensor:
        """A zeroed device window for one resident streaming session."""
        with torch.inference_mode():
            return torch.zeros(self.stream_window, dtype=torch.float32, device=self.device)

    def alloc_stream_buffers(self, rows: int) -> torch.Tensor:
        """Stacked zeroed device windows for a :class:`StreamingHub`."""
        with torch.inference_mode():
            return torch.zeros((rows, self.stream_window), dtype=torch.float32,
                               device=self.device)

    @staticmethod
    def _quantize_i16(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Abs-max int16 of each row of ``a [R, n]``: (int16, fp32 scale);
        an all-zero row ships zeros with scale 1."""
        amax = np.max(np.abs(a), axis=1)
        sc = np.where(amax > 0.0, amax / 32767.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(a / sc[:, None]), -32767, 32767).astype(np.int16)
        return q, sc

    def _chunk_values(self, chunks: np.ndarray) -> torch.Tensor:
        """``chunks [R, c]`` fp32 on the host -> the device values to write,
        through the engine's transport (int16 per row under "int16")."""
        if self.scfg.transport == "int16":
            q, sc = self._quantize_i16(chunks)
            return self._upload(q).float() * self._upload(sc)[:, None]
        return self._upload(chunks.astype(np.float32))

    def append_stream(self, buf: torch.Tensor, audio: np.ndarray,
                      offset: int) -> torch.Tensor:
        """Write ``audio`` into ``buf`` at sample ``offset`` (in place) and
        return ``buf``: one-row :meth:`append_stream_batch` writes of pieces
        of at most STREAM_CHUNK_MAX samples, each zero-padded to a multiple
        of STREAM_CHUNK_QUANTUM; with ``transport="int16"`` each piece ships
        as int16 with its own scale."""
        q, cmax = self.STREAM_CHUNK_QUANTUM, self.STREAM_CHUNK_MAX
        audio = np.asarray(audio, np.float32).reshape(-1)
        for i in range(0, len(audio), cmax):
            piece = audio[i : i + cmax]
            pad = np.zeros((1, -(-len(piece) // q) * q), np.float32)
            pad[0, : len(piece)] = piece
            self.append_stream_batch(buf[None], pad, np.array([offset + i]))
        return buf

    def append_stream_batch(self, bufs: torch.Tensor, chunks: np.ndarray,
                            offsets: np.ndarray) -> torch.Tensor:
        """One batched frontier write for a hub: ``chunks[r]`` lands in
        ``bufs[r]`` at ``offsets[r]`` (one ``scatter_``; every row writes, so
        idle rows get zero chunks at their frontier, a no-op under the
        zero-beyond-frontier invariant). Returns ``bufs``, written in
        place."""
        c = chunks.shape[1]
        assert c <= self.STREAM_CHUNK_MAX, c
        offsets = np.asarray(offsets, np.int64)
        # never clamps: scatter_ raises out of range, a JAX update clamps
        assert int(offsets.max(initial=0)) + c <= bufs.shape[1], (offsets, c)
        with torch.inference_mode():
            idx = self._upload(offsets)[:, None] + torch.arange(c, device=self.device)
            bufs.scatter_(1, idx, self._chunk_values(chunks))
        return bufs

    def reset_stream_row(self, bufs: torch.Tensor, row: int) -> torch.Tensor:
        """Zero one hub row so it can be reused (the appends rely on the
        region beyond a frontier being zero)."""
        with torch.inference_mode():
            bufs[row].zero_()
        return bufs

    def warmup_streaming(self, buckets: Sequence[int] | None = None,
                         chunk_samples: int = 8000, hub: bool = False) -> int:
        """Run the resident-streaming forwards once per time bucket (and the
        append of a ``chunk_samples`` feed); with ``hub`` also the hub's
        batched append and forward per bucket. Returns the number of
        forwards run."""
        buckets = list(buckets) if buckets is not None else self._buckets()
        buf = self.append_stream(self.alloc_stream_buffer(),
                                 np.zeros((chunk_samples,), np.float32), 0)
        for t in buckets:
            self._forward_res(buf, t, t)
        if not hub:
            return len(buckets)
        q, bs = self.STREAM_CHUNK_QUANTUM, self.scfg.batch_size
        c = min(-(-max(chunk_samples, 1) // q) * q, self.STREAM_CHUNK_MAX)
        bufs = self.append_stream_batch(self.alloc_stream_buffers(bs),
                                        np.zeros((bs, c), np.float32),
                                        np.zeros((bs,), np.int32))
        for t in buckets:
            self._forward_res_b(bufs, np.zeros((bs,), np.int32), t)
        return 2 * len(buckets)

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
        i16 = self.scfg.transport == "int16"
        xs = []
        for a in arrays:
            a = np.asarray(a, np.float32).reshape(-1)[: self.max_samples]
            if self.scfg.normalize and not i16:  # int16: normalized on the device
                a = normalize_input_values(a)
            xs.append(a)
        t = self._bucket(max(len(a) for a in xs))
        iv = np.zeros((bs, t), np.float32)
        il = np.zeros((bs,), np.int32)
        for i, a in enumerate(xs):
            n = min(len(a), t)
            iv[i, :n] = a[:n]
            il[i] = n
        if i16:
            got = self._forward_i16(*self._quantize_i16(iv), il)
        else:
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
