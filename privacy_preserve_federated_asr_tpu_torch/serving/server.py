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

Requests ride the engine's micro-batching dispatcher, so concurrent clients
share device batches. The ``/stream/*`` endpoints of the JAX server answer
404 until the streaming slice.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .engine import InferenceEngine


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


def make_server(engine: InferenceEngine, host: str = "127.0.0.1",
                port: int = 8008) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server bound to ``host:port``."""
    counter = {"requests": 0}
    lock = threading.Lock()

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
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
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

        def do_POST(self):
            try:
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

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(engine: InferenceEngine, host: str = "127.0.0.1",
                  port: int = 8008, warmup: bool = True) -> None:
    """Start the dispatcher, optionally warm every bucket, serve."""
    engine.start()
    if warmup:
        print(f"[serve] warmed {engine.warmup()} bucket shapes")
    srv = make_server(engine, host, port)
    print(f"[serve] listening on http://{host}:{port} (POST /asr, GET /healthz)")
    try:
        srv.serve_forever()
    finally:
        engine.stop()
        srv.server_close()
