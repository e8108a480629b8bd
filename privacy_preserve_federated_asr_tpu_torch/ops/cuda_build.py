"""Build and load the port's hand-written CUDA kernels.

``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/torch_kernels/lib<name>-<hash>.so``
under the repository root, and loaded with ``ctypes``. The hash covers the
source, every shared header ``csrc/*.cuh`` and the nvcc flags, so an edited
kernel, header or flag is rebuilt and a stale library is never loaded.
The build happens at first use, from the repository's sources only; a
missing ``nvcc`` or a failed build raises (there is no fallback).
The first load builds every source at once, one ``nvcc`` process each.
nvcc's report (``-Xptxas -v``: registers, shared memory and spills per
kernel) is kept beside each library as ``lib<name>-<hash>.log`` and read
into ``build_logs`` when the library is loaded.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# -Xptxas -v: registers, shared memory and spills per kernel, in build_logs
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc's output for each library loaded here


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


SOURCES = ("flash_fwd", "flash_bwd", "ctc", "pos_conv")  # every csrc/*.cu of the port


def _build(names) -> None:
    """Compile ``csrc/<name>.cu`` for each name, all nvcc processes at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log = proc.communicate()[0].strip()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc exited {proc.returncode} on {name}.cu\n{log}")
            continue
        out.with_suffix(".log").write_text(log)  # kept beside it for later loaders
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        build_logs[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``. The first call builds
    every source not built yet, one nvcc process each, all at once."""
    with _lock:
        if name not in _libs:
            missing = [n for n in SOURCES if not library_path(n).exists()]
            if missing:
                _build(missing)
            _libs[name] = ctypes.CDLL(str(library_path(name)))
            log = library_path(name).with_suffix(".log")
            if name not in build_logs and log.exists():
                build_logs[name] = log.read_text()
        return _libs[name]


def symbol(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``csrc/<lib>.cu``'s library, its argument
    types set and its return type ``int`` (a cudaError_t)."""
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
