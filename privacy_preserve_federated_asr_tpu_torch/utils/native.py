"""Shared loader for the repo's native C++ libraries (native/*.so); the
port's ``utils/native.py``.

One bootstrap used by every ctypes binding (data/native_audio.py,
ops/beam.py): resolve the library under ``native/``, build it on demand
with a single best-effort ``make`` (silent on toolchain-less machines),
``CDLL`` it, and cache the handle — including negative results, so a host
without g++ probes the toolchain once, not per call.

The libraries are the JAX package's (``native/wavio.cpp``,
``native/beam.cpp``, built by ``native/Makefile``); only this binding is the
port's own.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"

# so_name -> CDLL | None (None = tried and unavailable)
_CACHE: dict[str, ctypes.CDLL | None] = {}
# serializes first-load (and the on-demand `make`) across threads: the
# serving HTTP handlers run on a thread pool, and two concurrent `make`s
# racing on the same half-written .so would negative-cache a buildable lib
_LOCK = threading.Lock()

# set DACS_NO_NATIVE=1 to force the pure-Python fallbacks (e.g. to compare
# backends, or when a prebuilt .so is suspect on this host)
_DISABLE_ENV = "DACS_NO_NATIVE"


def _disabled() -> bool:
    return os.environ.get(_DISABLE_ENV, "").strip().lower() in (
        "1", "true", "yes", "on")


def load_native_lib(
    so_name: str,
    source_name: str,
    setup: Callable[[ctypes.CDLL], None],
) -> ctypes.CDLL | None:
    """Load ``native/<so_name>``, building it from ``source_name`` if needed.

    ``setup`` receives the freshly loaded CDLL to declare restype/argtypes;
    it runs once per process. Returns None when the library is unavailable
    (missing toolchain, build failure, load failure) — callers fall back to
    their Python paths. Thread-safe: concurrent first callers block on one
    build instead of racing it.
    """
    with _LOCK:
        if so_name in _CACHE:
            return _CACHE[so_name]
        lib = None
        try:
            lib = _load_uncached(so_name, source_name, setup)
        finally:
            # cache the verdict (positive or negative) exactly once, even
            # if the build/setup raised something unexpected
            _CACHE[so_name] = lib
        return lib


def _load_uncached(
    so_name: str, source_name: str,
    setup: Callable[[ctypes.CDLL], None],
) -> ctypes.CDLL | None:
    if _disabled():
        return None
    so = NATIVE_DIR / so_name
    if not so.exists() and (NATIVE_DIR / source_name).exists():
        try:  # one best-effort build
            subprocess.run(["make", "-C", str(NATIVE_DIR), so_name],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    if not so.exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
        setup(lib)
    except (OSError, AttributeError):
        return None
    return lib
