"""Minimal stdlib HTTP front-end for the inference engine (the port's
``serving/server.py``). Endpoints:

* ``GET /healthz`` -> ``{"ok": true, "requests": N}``
* ``POST /asr`` with either
  - JSON body ``{"audio": [floats], "sample_rate": 16000}``, or
  - a RIFF/WAV body (``Content-Type: audio/wav``), PCM16/PCM32/float32, or
  - raw samples (``Content-Type: application/octet-stream``) —
    little-endian float32 by default; ``X-Audio-Format: s16`` for PCM16
    (scaled by 1/32768) and ``X-Sample-Rate`` for non-16k input
  -> ``{"transcript", "ad_pred", "ad_prob", "frames", "samples"}``
* streaming (serving/streaming.py block-streaming sessions):
  - ``POST /stream/start`` -> ``{"session": id}``
  - ``POST /stream/<id>`` with an audio chunk (the formats of /asr)
    -> ``{"transcript", "final_transcript", "ad_prob", "ad_pred",
    "final_frames", "total_frames", "is_final"}``
  - ``POST /stream/<id>/finish`` -> the final result; the session is deleted

Requests ride the engine's micro-batching dispatcher, so concurrent clients
share device batches. Streaming sessions join a shared
:class:`StreamingHub` while it has rows (up to ``engine.scfg.batch_size``
streams advance from one batched pass per hop) and fall back to standalone
:class:`StreamingSession` s beyond that. The session table holds at most
64 sessions; one idle for ``session_idle_ttl_s`` is reaped (closed) when a
new one starts, unless a request of it is in flight. Locks: the table lock
is always taken before the hub lock; hub members share the hub lock, a
standalone session has its own.
"""

from __future__ import annotations

import io
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .engine import InferenceEngine
from .streaming import StreamingConfig, StreamingHub, StreamingSession

_MAX_SESSIONS = 64
_SESSION_IDLE_TTL_S = 600.0


def _resample_to_16k(data: np.ndarray, sr: int) -> np.ndarray:
    """Linear resample to 16 kHz (request path; offline ingest uses the
    polyphase loader in data/audio.py)."""
    if sr == 16000:
        return np.asarray(data, np.float32)
    n = int(round(len(data) * 16000 / sr))
    return np.interp(
        np.linspace(0.0, len(data) - 1, n, dtype=np.float64),
        np.arange(len(data), dtype=np.float64), data,
    ).astype(np.float32)


def _decode_wav(body: bytes) -> np.ndarray:
    from scipy.io import wavfile

    sr, data = wavfile.read(io.BytesIO(body))
    if data.ndim > 1:  # downmix channels
        data = data.mean(axis=1)
    if np.issubdtype(data.dtype, np.integer):
        # scale by 2^(bits-1), matching the octet-stream s16 path
        data = data.astype(np.float32) / float(-np.iinfo(data.dtype).min)
    else:
        data = data.astype(np.float32)
    return _resample_to_16k(data, sr)


class _SessionEntry:
    """A streaming session, the lock its requests serialize on, and its
    idle clock (the reaper's)."""

    def __init__(self, sess: StreamingSession, lock: threading.Lock | None = None):
        self.sess = sess
        # hub members share the hub's lock (a hub step advances every
        # member); a standalone session has its own
        self.lock = lock if lock is not None else threading.Lock()
        self.touch()

    def touch(self) -> None:
        self.last_used = time.monotonic()


def make_server(engine: InferenceEngine, host: str = "127.0.0.1", port: int = 8008,
                stream_cfg: StreamingConfig | None = None,
                session_idle_ttl_s: float = _SESSION_IDLE_TTL_S,
                use_hub: bool = True) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server bound to ``host:port``.
    ``use_hub=False`` gives every stream a standalone session. The server's
    ``stream_sessions`` is its session table (id -> entry with ``sess``,
    ``lock`` and ``last_used``), ``stream_hub`` its hub."""
    counter = {"requests": 0}
    lock = threading.Lock()  # the request counter and the session table
    sessions: dict[str, _SessionEntry] = {}
    scfg = stream_cfg if stream_cfg is not None else StreamingConfig()
    hub = StreamingHub(engine, scfg) if (use_hub and scfg.resident) else None
    hub_lock = threading.Lock()

    def reap_idle_locked() -> None:
        cutoff = time.monotonic() - session_idle_ttl_s
        for sid in [s for s, e in sessions.items() if e.last_used < cutoff]:
            e = sessions[sid]
            # a held lock = a feed or finish in flight: never reap it
            if not e.lock.acquire(blocking=False):
                continue
            try:
                del sessions[sid]
                e.sess.close()  # hub members free (and zero) their row
            finally:
                e.lock.release()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "requests": counter["requests"]})
            else:
                self._reply(404, {"error": "not found"})

        def _read_audio(self) -> np.ndarray:
            body = self._body
            ctype = (self.headers.get("Content-Type") or "").lower()
            # an explicit octet-stream declaration wins over content
            # sniffing: raw PCM can legitimately start with b"RIFF"
            if "octet-stream" not in ctype and (
                    body[:4] == b"RIFF" or "audio/wav" in ctype):
                return _decode_wav(body)
            if "octet-stream" in ctype:
                fmt = (self.headers.get("X-Audio-Format") or "f32").lower()
                sr = int(self.headers.get("X-Sample-Rate", 16000))
                if fmt == "s16":
                    data = np.frombuffer(body, dtype="<i2").astype(
                        np.float32) / 32768.0
                elif fmt == "f32":
                    data = np.frombuffer(body, dtype="<f4").astype(np.float32)
                else:
                    raise ValueError(f"unknown X-Audio-Format {fmt!r} "
                                     "(want f32 or s16)")
                return _resample_to_16k(data, sr)
            obj = json.loads(body)
            return _resample_to_16k(
                np.asarray(obj["audio"], np.float32),
                int(obj.get("sample_rate", 16000)))

        def _do_stream(self) -> None:
            parts = self.path.strip("/").split("/")  # stream[/<id>[/finish]]
            if parts == ["stream", "start"]:
                with lock:
                    reap_idle_locked()
                    if len(sessions) >= _MAX_SESSIONS:
                        self._reply(429, {"error": "too many sessions"})
                        return
                    sid = uuid.uuid4().hex[:16]
                    sess = None
                    if hub is not None:
                        with hub_lock:  # lock order: table, then hub
                            try:
                                sess = hub.open()
                            except RuntimeError:  # hub full: standalone
                                sess = None
                    sessions[sid] = (_SessionEntry(sess, lock=hub_lock) if sess is not None
                                     else _SessionEntry(StreamingSession(engine, scfg)))
                self._reply(200, {"session": sid})
                return
            with lock:
                entry = sessions.get(parts[1]) if len(parts) >= 2 else None
                if entry is not None:
                    # restart the idle clock under the table lock, so no
                    # reap can drop the session before its lock is taken
                    entry.touch()
            if entry is None:
                self._reply(404, {"error": "unknown session"})
                return
            if len(parts) == 3 and parts[2] == "finish":
                with entry.lock:
                    r = entry.sess.finish()
                with lock:
                    sessions.pop(parts[1], None)
            else:
                audio = self._read_audio()
                if audio.size == 0:
                    self._reply(400, {"error": "empty audio"})
                    return
                with entry.lock:
                    r = entry.sess.feed(audio)
                    entry.touch()
            self._reply(200, {
                "transcript": r.transcript, "final_transcript": r.final_transcript,
                "ad_prob": r.ad_prob, "ad_pred": r.ad_pred,
                "final_frames": r.final_frames, "total_frames": r.total_frames,
                "is_final": r.is_final,
            })

        def do_POST(self):
            # read every body, also where the route ignores it: a socket
            # closed with unread bytes is reset, and the client can lose
            # the reply
            self._body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                if self.path.startswith("/stream"):
                    self._do_stream()
                    return
                if self.path != "/asr":
                    self._reply(404, {"error": "not found"})
                    return
                audio = self._read_audio()
                if audio.size == 0:
                    self._reply(400, {"error": "empty audio"})
                    return
                r = engine.infer(audio)
                with lock:
                    counter["requests"] += 1
                self._reply(200, {
                    "transcript": r.transcript, "ad_pred": r.ad_pred,
                    "ad_prob": r.ad_prob, "frames": r.frames,
                    "samples": r.samples,
                })
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.stream_sessions = sessions  # the session table, for inspection
    srv.stream_hub = hub            # the shared hub (None without one)
    return srv


def serve_forever(engine: InferenceEngine, host: str = "127.0.0.1",
                  port: int = 8008, warmup: bool = True,
                  stream_cfg: StreamingConfig | None = None,
                  use_hub: bool = True) -> None:
    """Start the dispatcher, optionally warm every bucket (the batch
    forward, and the resident streaming forwards, batched too with the
    hub), serve. ``use_hub=False`` gives every stream a standalone resident
    session."""
    engine.start()
    if warmup:
        n = engine.warmup()
        scfg = stream_cfg if stream_cfg is not None else StreamingConfig()
        if scfg.resident:
            n += engine.warmup_streaming(hub=use_hub)
        print(f"[serve] warmed {n} bucket forwards")
    srv = make_server(engine, host, port, stream_cfg=stream_cfg, use_hub=use_hub)
    print(f"[serve] listening on http://{host}:{port} (POST /asr, POST /stream/*, "
          f"GET /healthz)")
    try:
        srv.serve_forever()
    finally:
        engine.stop()
        srv.server_close()
