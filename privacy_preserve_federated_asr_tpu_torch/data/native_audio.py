"""ctypes binding for the native audio-ingest library (native/wavio.cpp);
the port's ``data/native_audio.py``.

The C++ side re-implements the Python loader's exact semantics
(data/audio.py `load_audio`: RIFF parse, channel-mean downmix, integer
scaling, scipy-parity polyphase resampling, peak normalization) plus a
threaded whole-corpus loader. If the shared library is absent and cannot be
built (`make -C native`), callers fall back to the scipy path.

Unlike the JAX package's binding, a path that is not a regular file never
reaches the library: ``native/wavio.cpp::read_file`` opens a directory,
reads a huge size from ``ftell`` and aborts the whole process with
``std::bad_alloc``. Here such a path fails like an unreadable file.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.native import load_native_lib


def _setup(lib: ctypes.CDLL) -> None:
    lib.dacs_load_wav.restype = ctypes.c_long
    lib.dacs_load_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    lib.dacs_free.restype = None
    lib.dacs_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.dacs_load_many.restype = ctypes.c_long
    lib.dacs_load_many.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long)]


def _load_lib():
    lib = load_native_lib("libdacsaudio.so", "wavio.cpp", _setup)
    if lib is None:
        raise RuntimeError("native audio library unavailable")
    return lib


def available() -> bool:
    """True when the native library is loadable (building it on demand)."""
    return load_native_lib("libdacsaudio.so", "wavio.cpp", _setup) is not None


def load_audio_native(path: str, target_sr: int = 16000,
                      normalize: bool = True) -> np.ndarray:
    """Native equivalent of data/audio.py `load_audio`. Raises RuntimeError
    when the library is unavailable or the file cannot be decoded (a path
    that is not a regular file included)."""
    lib = _load_lib()
    if not os.path.isfile(path):
        raise RuntimeError(f"native wav load failed (not a regular file): {path}")
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.dacs_load_wav(os.fsencode(path), target_sr, int(normalize),
                          ctypes.byref(out))
    if n < 0:
        raise RuntimeError(f"native wav load failed ({n}): {path}")
    try:
        return np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.dacs_free(out)


def load_many_native(paths: list[str], target_sr: int = 16000,
                     normalize: bool = True,
                     n_threads: int | None = None) -> list[np.ndarray | None]:
    """Threaded corpus load; element i is None when file i failed or is not
    a regular file."""
    lib = _load_lib()
    files = [i for i, p in enumerate(paths) if os.path.isfile(p)]
    result: list[np.ndarray | None] = [None] * len(paths)
    n = len(files)
    if n == 0:
        return result
    if n_threads is None:
        n_threads = min(max(os.cpu_count() or 1, 1) * 2, 16)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(paths[i]) for i in files])
    outs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_long * n)()
    lib.dacs_load_many(c_paths, n, target_sr, int(normalize), n_threads,
                       outs, lens)
    for j, i in enumerate(files):
        if lens[j] < 0:
            continue
        result[i] = np.ctypeslib.as_array(outs[j], shape=(lens[j],)).copy()
        lib.dacs_free(outs[j])
    return result
