"""Block-streaming inference sessions over the batched serving engine (the
port's ``serving/streaming.py``).

The models are bidirectional SSL encoders (every frame attends to the whole
utterance), so streaming here is **block streaming with bounded right
context**: the encoder re-runs as audio arrives, frames more than
``right_context_seconds`` behind the audio frontier are *final*, and the
frames inside that margin stay *partial* (re-decoded on every pass). How
fast labels settle behind the frontier is a property of the weights:
:func:`measure_finalization_flips` (``cli stream-report``) measures the flip
rate of would-be-finalized frames against the full-context decode for each
candidate right context.

Every pass is one engine forward at a time bucket: the resident forwards
(``_forward_res`` / ``_forward_res_b``, warmed by
``engine.warmup_streaming(hub=...)``; ``serve_forever`` warms them at
startup) or, with ``resident=False``, the engine's batch forward. CTC makes
the stitching exact: finalized frames keep the greedy ids of the pass that
finalized them, and the tokenizer's collapse runs over (finalized ids +
current partial tail), so repeats and blanks across the boundary collapse
correctly. With ``right_context`` >= the utterance nothing finalizes early
and ``finish()`` equals the batch path.

The engine's options apply: int8 compute (the engine's model), int16
transport (each uploaded piece as int16 with its own scale), and beam + LM
fusion, which carries one CTC prefix beam state over the finalized frames
(``ops/beam.py ctc_beam_advance``) and re-decodes only the partial tail per
pass; with no early finalization the finished hypothesis is the batch beam
decode's.

**Resident window** (``StreamingConfig.resident``, default on): the session's
audio lives in a device buffer (``engine.alloc_stream_buffer``); each pass
uploads only the new audio (``engine.append_stream``) and the forward slices
and normalizes on the device. Per-pass host-to-device traffic drops from the
whole padded ``(batch_size, t)`` window to the new chunk.

:class:`StreamingHub` keeps up to ``engine.scfg.batch_size`` sessions'
windows in one stacked buffer and advances them all with one batched append
and one batched forward per hop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..data.audio import normalize_input_values
from ..models.backbone import feat_extract_output_lengths
from ..ops.beam import beam_state_hypotheses, ctc_beam_advance, ctc_beam_init
from .engine import InferenceEngine, InferenceResult


@dataclass
class StreamingConfig:
    # frames farther than this behind the audio frontier are finalized:
    # the latency / stability knob. Measure the flip rate on the deployed
    # weights with `cli stream-report` before choosing it
    right_context_seconds: float = 0.4
    # run an incremental pass at most this often (seconds of new audio);
    # smaller = lower latency, more device passes
    min_hop_seconds: float = 0.5
    # keep the session's audio window on the device and upload only the
    # audio that arrived since the last pass; the normalization runs on
    # the device (masked twin of the host's, fp32 sums in another order).
    # False = re-upload the whole host window every pass
    resident: bool = True


@dataclass
class StreamingResult:
    """State after one ``feed``/``finish`` call."""

    transcript: str          # finalized + partial, CTC-collapsed together
    final_transcript: str    # finalized frames only (stable prefix)
    ad_prob: float           # mean P(AD) over the current window's frames
    ad_pred: int             # frame-majority vote over the current window
    final_frames: int        # frames finalized so far
    total_frames: int        # frames seen in the latest pass
    is_final: bool = False


def _empty(final: bool) -> StreamingResult:
    return StreamingResult("", "", 0.0, 0, 0, 0, final)


class StreamingSession:
    """One utterance's incremental decode over a shared ``InferenceEngine``.

    Not thread-safe; one session per stream (sessions share the engine).
    Audio beyond the engine's ``max_seconds`` is truncated like the batch
    path.
    """

    def __init__(self, engine: InferenceEngine, scfg: StreamingConfig | None = None):
        self.engine = engine
        self.scfg = scfg or StreamingConfig()
        self._audio = np.zeros((0,), np.float32)
        self._final_ids: list[int] = []
        self._tail_ids: list[int] = []
        self._last_pass_samples = 0
        self._last: StreamingResult | None = None
        self._finished = False
        # beam decode (engine beam_size > 0): one CTC prefix beam state over
        # the finalized frames; the partial tail advances from a copy
        self._beam_state = ctc_beam_init() if engine.scfg.beam_size > 0 else None
        # the device-resident window, allocated on the first pass
        self._buf = None
        self._uploaded = 0

    # ---- internals ----

    def _device_pass(self, audio: np.ndarray, n: int):
        """One bucketed engine forward over the current window: resident
        (upload ``audio[_uploaded:n]`` into the device window, forward on
        the device copy) or legacy (upload the whole padded window)."""
        eng = self.engine
        t = eng._bucket(n)
        if self.scfg.resident:
            if self._buf is None:
                self._buf = eng.alloc_stream_buffer()
            if n > self._uploaded:
                self._buf = eng.append_stream(self._buf, audio[self._uploaded : n],
                                              self._uploaded)
                self._uploaded = n
            return eng._forward_res(self._buf, min(n, t), t)
        bs = eng.scfg.batch_size
        il = np.zeros((bs,), np.int32)
        il[0] = min(n, t)
        if eng.scfg.transport == "int16":
            iv = np.zeros((bs, t), np.float32)
            iv[0, :n] = audio[:t]
            return eng._forward_i16(*eng._quantize_i16(iv), il)
        x = normalize_input_values(audio) if eng.scfg.normalize else audio
        iv = np.zeros((bs, t), np.float32)
        iv[0, :n] = x[:t]
        return eng._forward(iv, il)

    def _run_pass(self, finalize_all: bool = False) -> StreamingResult:
        audio = self._audio[: self.engine.max_samples]
        n = len(audio)
        return self._consume(n, self._device_pass(audio, n), 0, finalize_all)

    def _consume(self, n: int, got, row: int, finalize_all: bool) -> StreamingResult:
        """Fold one device pass's outputs (this session's ``row``) into the
        finalize/decode state: row 0 of a standalone pass, or one row of a
        hub's batched pass."""
        eng = self.engine
        pred, ad_pred, ad_prob, flen = got[:4]
        total = int(flen[row])
        ids = [int(i) for i in pred[row, :total]]
        if finalize_all:
            final_until = total
        else:
            rc = int(self.scfg.right_context_seconds * 16000)
            stable = max(n - rc, 0)
            final_until = int(feat_extract_output_lengths(eng.cfg.backbone, stable))
            final_until = max(min(final_until, total), len(self._final_ids))
        # finalized frames keep the ids of the pass that finalized them; the
        # tail is re-decoded every pass
        n_prev_final = len(self._final_ids)
        self._final_ids.extend(ids[n_prev_final:final_until])
        self._tail_ids = ids[final_until:]
        self._last_pass_samples = n
        tok = eng.tokenizer
        if self._beam_state is not None:
            transcript, final_transcript = self._beam_texts(
                got[4][row], n_prev_final, final_until, total)
        else:
            transcript = tok.decode(self._final_ids + self._tail_ids)
            final_transcript = tok.decode(self._final_ids)
        self._last = StreamingResult(
            transcript=transcript, final_transcript=final_transcript,
            ad_prob=float(ad_prob[row]), ad_pred=int(ad_pred[row]),
            final_frames=len(self._final_ids), total_frames=total,
            is_final=finalize_all)
        return self._last

    def _beam_texts(self, lp: np.ndarray, n_prev_final: int, final_until: int,
                    total: int) -> tuple[str, str]:
        """Advance the carried beam state over the newly finalized frames'
        log-posteriors, then decode the tail from a copy: with no early
        finalization the finish pass advances one state over the whole
        utterance, the batch beam decode."""
        eng = self.engine
        scfg = eng.scfg
        kw = dict(beam_size=scfg.beam_size, blank_id=eng.cfg.backbone.pad_token_id,
                  lm_fn=eng._lm_fn, lm_alpha=scfg.lm_alpha, lm_beta=scfg.lm_beta)
        lp = np.asarray(lp, np.float32)
        if final_until > n_prev_final:
            self._beam_state = ctc_beam_advance(lp[n_prev_final:final_until],
                                                self._beam_state, **kw)
        tail = (ctc_beam_advance(lp[final_until:total], self._beam_state, **kw)
                if total > final_until else self._beam_state)
        tok = eng.tokenizer
        # beam ids are already CTC-collapsed: decode without grouping
        return (tok.decode(beam_state_hypotheses(tail)[0].ids, group_tokens=False),
                tok.decode(beam_state_hypotheses(self._beam_state)[0].ids,
                           group_tokens=False))

    # ---- public API ----

    def _ingest(self, chunk: np.ndarray) -> bool:
        """Append the chunk and hop-gate (standalone sessions and hub
        members). True when a device pass is due."""
        if self._finished:
            raise RuntimeError("session already finished")
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        # passes only read the first max_samples: keep no more
        room = self.engine.max_samples - len(self._audio)
        if room > 0:
            self._audio = np.concatenate([self._audio, chunk[:room]])
        hop = int(self.scfg.min_hop_seconds * 16000)
        n = min(len(self._audio), self.engine.max_samples)
        return self._last is None or n - self._last_pass_samples >= hop

    def feed(self, chunk: np.ndarray) -> StreamingResult:
        """Append audio (float32 at 16 kHz); returns the updated state. A
        device pass runs once ``min_hop_seconds`` of new audio has
        accumulated (or on the first chunk); otherwise the previous state
        comes back."""
        if not self._ingest(chunk):
            assert self._last is not None
            return self._last
        return self._run_pass()

    def finish(self) -> StreamingResult:
        """Final pass over all audio: finalizes every frame. Idempotent."""
        if self._finished:
            assert self._last is not None
            return self._last
        self._finished = True
        if len(self._audio) == 0:
            self._last = _empty(True)
            return self._last
        return self._run_pass(finalize_all=True)

    def close(self) -> None:
        """Abandon the session without a finalize pass (idempotent; the
        HTTP server's idle reaper calls it). ``finish()``/``result()``
        afterwards return the last observed state, or an empty final
        result if no pass ran."""
        self._finished = True
        if self._last is None:
            self._last = _empty(True)

    def result(self) -> InferenceResult:
        """The finished session as the batch path's result type."""
        r = self.finish()
        return InferenceResult(
            transcript=r.transcript, ad_pred=r.ad_pred, ad_prob=r.ad_prob,
            frames=r.total_frames,
            samples=min(len(self._audio), self.engine.max_samples))


class HubStreamingSession(StreamingSession):
    """A :class:`StreamingHub` member: the public API of
    :class:`StreamingSession`, with shared device passes (``feed`` and
    ``finish`` trigger the hub's batched step, which advances every active
    member)."""

    def __init__(self, hub: "StreamingHub", row: int):
        super().__init__(hub.engine, hub.scfg)
        self._hub = hub
        self._row = row

    def feed(self, chunk: np.ndarray) -> StreamingResult:
        if self._ingest(chunk):
            self._hub._maybe_step(self)
        if self._last is None:  # nothing fed yet, or the pass deferred
            self._last = _empty(False)
        return self._last

    def finish(self) -> StreamingResult:
        if self._finished:
            assert self._last is not None
            return self._last
        self._finished = True
        if len(self._audio) == 0:
            self._last = _empty(True)
        else:
            self._hub._step(finalize=frozenset((self._row,)))
        self._hub._release(self._row)
        assert self._last is not None
        return self._last

    def close(self) -> None:
        if not self._finished:
            self._finished = True
            if self._last is None:
                self._last = _empty(True)
            self._hub._release(self._row)


class StreamingHub:
    """Many concurrent streaming sessions in shared device passes.

    A standalone session costs one append and one batch-1 forward per hop.
    The hub keeps up to ``engine.scfg.batch_size`` sessions' windows in one
    stacked device buffer; each step uploads every member's pending audio in
    one batched frontier write and runs one batched forward whose per-row
    lengths mask the free rows. Each member folds its row through the same
    ``_consume`` a standalone session uses.

    Member feeds coalesce: a due feed runs the shared pass once every active
    member has fresh audio (lockstep streams: one pass per fleet hop), or
    when the triggering member has fallen 2 hops behind (a stalled peer never
    starves the rest; staleness is bounded at 2 hops).
    ``min_hop_seconds == 0`` turns coalescing off.

    Not thread-safe; drive it under one lock. Rows free on ``finish()`` /
    ``close()`` and are zeroed before reuse."""

    def __init__(self, engine: InferenceEngine, scfg: StreamingConfig | None = None):
        self.engine = engine
        self.scfg = scfg or StreamingConfig()
        self.rows = engine.scfg.batch_size
        self._bufs = None
        self._sessions: list[HubStreamingSession | None] = [None] * self.rows
        self.passes = 0  # batched forwards run

    def open(self) -> HubStreamingSession:
        for r, s in enumerate(self._sessions):
            if s is None:
                self._sessions[r] = HubStreamingSession(self, r)
                return self._sessions[r]
        raise RuntimeError(f"hub full: {self.rows} concurrent sessions "
                           "(engine.scfg.batch_size)")

    def active_sessions(self) -> int:
        return sum(s is not None for s in self._sessions)

    def _release(self, row: int) -> None:
        if self._sessions[row] is None:
            return
        self._sessions[row] = None
        if self._bufs is not None:
            self._bufs = self.engine.reset_stream_row(self._bufs, row)

    def _maybe_step(self, trigger: HubStreamingSession) -> None:
        """Run the batched pass once every active member has fresh audio,
        or when ``trigger`` has 2 hops pending; with ``min_hop_seconds ==
        0`` any fresh audio runs it."""
        act = [s for s in self._sessions
               if s is not None and not s._finished and len(s._audio) > 0]
        if not act:
            return
        max_s = self.engine.max_samples

        def pending(s):
            base = s._last_pass_samples if s._last is not None else 0
            return min(len(s._audio), max_s) - base

        fresh = [s for s in act if s._last is None or pending(s) > 0]
        if not fresh:
            return
        hop = int(self.scfg.min_hop_seconds * 16000)
        if len(fresh) == len(act) or pending(trigger) >= max(2 * hop, 1):
            self._step()

    def _step(self, finalize: frozenset = frozenset()) -> None:
        eng = self.engine
        active = [(r, s) for r, s in enumerate(self._sessions)
                  if s is not None and len(s._audio) > 0]
        if not active:
            return
        if self._bufs is None:
            self._bufs = eng.alloc_stream_buffers(self.rows)
        # ---- one batched frontier write for every pending upload ----
        ns = {r: min(len(s._audio), eng.max_samples) for r, s in active}
        pend = {r: ns[r] - s._uploaded for r, s in active if ns[r] > s._uploaded}
        if pend:
            q = eng.STREAM_CHUNK_QUANTUM
            width = -(-max(pend.values()) // q) * q
            for lo in range(0, width, eng.STREAM_CHUNK_MAX):
                c = min(eng.STREAM_CHUNK_MAX, width - lo)
                chunks = np.zeros((self.rows, c), np.float32)
                offsets = np.zeros((self.rows,), np.int32)
                for r, s in active:
                    # rows with nothing (left) to upload write zeros at
                    # their frontier: a no-op under the zero invariant
                    offsets[r] = s._uploaded + min(pend.get(r, 0), lo)
                    take = pend.get(r, 0) - lo
                    if take > 0:
                        piece = s._audio[s._uploaded + lo : s._uploaded + lo + min(take, c)]
                        chunks[r, : len(piece)] = piece
                self._bufs = eng.append_stream_batch(self._bufs, chunks, offsets)
            for r, s in active:
                s._uploaded = ns[r]
        # ---- one batched forward over the shared buffer ----
        t = eng._bucket(max(ns.values()))
        ils = np.zeros((self.rows,), np.int32)
        for r, _ in active:
            ils[r] = min(ns[r], t)
        got = eng._forward_res_b(self._bufs, ils, t)
        self.passes += 1
        for r, s in active:
            s._consume(min(ns[r], t), got, r, finalize_all=(r in finalize))


def measure_finalization_flips(
    engine: InferenceEngine,
    audios,
    right_context_grid=(0.25, 0.5, 1.0, 2.0, 4.0),
    hop_seconds: float = 0.5,
    chunk_seconds: float = 0.25,
) -> list[dict]:
    """The data behind the ``right_context_seconds`` knob.

    For each candidate right context, stream every utterance through a real
    :class:`StreamingSession` and count the early-finalized frame labels
    that disagree with the labels of the one-shot full-context pass. One row
    per grid point::

        {"right_context_seconds": rc, "finalized_frames": F,
         "finalized_fraction": F / total, "flips": X, "flip_rate": X / F}

    ``flip_rate`` is the probability that a frame the session froze would
    read otherwise with full context. Run it on the deployed weights and
    take the smallest right context whose rate is acceptable.
    """
    if isinstance(audios, np.ndarray):
        audios = [audios]
    hop_cfg = StreamingConfig(right_context_seconds=1e9, min_hop_seconds=1e9)
    refs = []  # one full-context decode per utterance
    for audio in audios:
        s = StreamingSession(engine, hop_cfg)
        s.feed(audio)
        s.finish()
        refs.append(list(s._final_ids))
    chunk = max(int(chunk_seconds * 16000), 1)
    rows = []
    for rc in right_context_grid:
        finalized = flips = total = 0
        for audio, ref in zip(audios, refs):
            audio = np.asarray(audio, np.float32).reshape(-1)
            s = StreamingSession(engine, StreamingConfig(
                right_context_seconds=float(rc), min_hop_seconds=hop_seconds))
            for i in range(0, len(audio), chunk):
                s.feed(audio[i : i + chunk])
            early = list(s._final_ids)  # frozen before the finish pass
            s.finish()
            finalized += len(early)
            total += len(ref)
            flips += sum(int(a != b) for a, b in zip(early, ref))
        rows.append({
            "right_context_seconds": float(rc),
            "finalized_frames": finalized,
            "finalized_fraction": finalized / max(total, 1),
            "flips": flips,
            "flip_rate": flips / max(finalized, 1),
        })
    return rows
