#!/usr/bin/env python
"""Where the time of the fp32 attention kernels goes, on the card.

    python privacy_preserve_federated_asr_tpu_torch/tools/fp32_attention_probe.py

Needs an H100 and nvcc. Prints, each line with the card's name and power
limit, the time of the fp32 paths of kernels B1 (``csrc/flash_fwd.cu``) and
B2 (``csrc/flash_bwd.cu``) at B=8, H=16, T=1499 (B1 without dropout, as
``chip_smoke.py`` phase 2 times it; B2 at dropout 0.1, as phase 5 does)
beside copies of the source with one part switched off: a split pass, a
batch of products, the precise ``expf``. The difference is what that part
costs where it does not overlap the rest. A copy with a part switched off
computes wrong values; only its time is read.

The copies are written and built under ``build/fp32_probe/`` (git-ignored)
from the sources in ``csrc/``; a substitution that no longer matches its
source fails the run.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CSRC = REPO / "privacy_preserve_federated_asr_tpu_torch" / "csrc"
OUT = REPO / "build" / "fp32_probe"
T, H, BATCH = 1499, 16, 8

# (source, label, [(text in the source, its replacement)]); a product
# switched off leaves its accumulator as it was, or (the first product of a
# tile) sets every entry from its A operand
VARIANTS = [
    ("flash_fwd", "as built", []),
    ("flash_fwd", "no split pass",
     [("    split_rows_sw<kF32BK, kF32Threads, kDP>(sK, rawK, tid);\n"
       "    split_cols_sw<kF32BK, kF32Threads, kDP>(sVt, rawV, tid);\n", "")]),
    ("flash_fwd", "no S = q K^T",
     [("        wgmma_3xtf32(s, qa[kc], sK, kF32Plane, kc, kF32BK, kc == 0);",
       "        s[kc][0] = s[kc][1] = s[kc][2] = s[kc][3] = __uint_as_float(qa[kc].hi[0]);")]),
    ("flash_fwd", "no O += P V",
     [("        wgmma_3xtf32(oacc[nb], pa[kc], sVt + nb * kAtom * 128, kF32Plane, kc, kDP, false);",
       "        oacc[nb][kc][0] += __uint_as_float(pa[kc].hi[0]);")]),
    ("flash_fwd", "fast exp (__expf)", [("= expf(", "= __expf(")]),
    ("flash_bwd", "as built", []),
    ("flash_bwd", "dK/dV: no split pass",
     [("    split_rows_sw<kDkBQ, kDkThreads>(sq, rawQ, tid, scale);  // q is scaled in fp32\n"
       "    split_cols_sw<kDkBQ, kDkThreads>(sqt, rawQ, tid, scale);\n"
       "    split_rows_sw<kDkBQ, kDkThreads>(sd, rawD, tid);\n"
       "    split_cols_sw<kDkBQ, kDkThreads>(sdt, rawD, tid);\n", "")]),
    ("flash_bwd", "dK/dV: no S^T, dP^T",
     [("      wgmma_3xtf32(stt, xa[kc], sq, kDkPlane, kc, kDkBQ, kc == 0);",
       "      stt[kc & 3][0] = stt[kc & 3][1] = stt[kc & 3][2] = stt[kc & 3][3] = "
       "__uint_as_float(xa[kc].hi[0]);"),
      ("      wgmma_3xtf32(dpt, xa[kc], sd, kDkPlane, kc, kDkBQ, kc == 0);",
       "      dpt[kc & 3][0] = dpt[kc & 3][1] = dpt[kc & 3][2] = dpt[kc & 3][3] = "
       "__uint_as_float(xa[kc].hi[0]);")]),
    ("flash_bwd", "dK/dV: no dV, dK",
     [("      wgmma_3xtf32(dva, aa[kc], sdt, kDkPlane, kc, kD, false);",
       "      dva[kc][0] += __uint_as_float(aa[kc].hi[0]);"),
      ("      wgmma_3xtf32(dka, sa[kc], sqt, kDkPlane, kc, kD, false);",
       "      dka[kc][0] += __uint_as_float(sa[kc].hi[0]);")]),
    ("flash_bwd", "dQ: no split pass",
     [("    split_rows_sw<kDqBK, kDqThreads>(sk, rawK, tid);\n"
       "    split_cols_sw<kDqBK, kDqThreads>(skt, rawK, tid);\n"
       "    split_rows_sw<kDqBK, kDqThreads>(sv, rawV, tid);\n", "")]),
    ("flash_bwd", "dQ: no S, dP",
     [("wgmma_3xtf32(s, xa[kc], sk, kDqPlane, kc, kDqBK, kc == 0);",
       "s[kc][0] = s[kc][1] = s[kc][2] = s[kc][3] = __uint_as_float(xa[kc].hi[0]);"),
      ("wgmma_3xtf32(dp, xa[kc], sv, kDqPlane, kc, kDqBK, kc == 0);",
       "dp[kc][0] = dp[kc][1] = dp[kc][2] = dp[kc][3] = __uint_as_float(xa[kc].hi[0]);")]),
    ("flash_bwd", "dQ: no dQ += dS K",
     [("wgmma_3xtf32(dqa, sa[kc], skt, kDqPlane, kc, kD, false);",
       "dqa[kc][0] += __uint_as_float(sa[kc].hi[0]);")]),
    ("flash_bwd", "fast exp (__expf)", [("= expf(", "= __expf(")]),
]


def write_sources() -> list[Path]:
    """Each variant's copy of its source (and the shared header) under OUT."""
    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    paths = []
    for i, (source, label, subs) in enumerate(VARIANTS):
        text = (CSRC / f"{source}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{source}.cu no longer holds the text {label!r} replaces")
            text = text.replace(old, new)
        paths.append(OUT / f"{source}_{i}.cu")
        paths[-1].write_text(text)
    return paths


def build(paths: list[Path]) -> list[ctypes.CDLL]:
    from privacy_preserve_federated_asr_tpu_torch.ops.cuda_build import NVCC_FLAGS, nvcc_path

    procs = [subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(p.with_suffix(".so")), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p in paths]
    for p, proc in zip(paths, procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {p.name}:\n{log}")
    return [ctypes.CDLL(str(p.with_suffix(".so"))) for p in paths]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("fp32_attention_probe.py needs a CUDA device")
    sys.path.insert(0, str(REPO))
    from privacy_preserve_federated_asr_tpu_torch.ops import attention as port

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = build(write_sources())
    stream = torch.cuda.current_stream().cuda_stream

    def cuda_ms(fn, iters=20, windows=5):
        fn(), fn()
        torch.cuda.synchronize()
        means = []
        for _ in range(windows):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            means.append(start.elapsed_time(end) / iters)
        return sorted(means)[windows // 2]

    g = torch.Generator("cuda").manual_seed(1)
    q, k, v, do = (torch.randn((BATCH, T, H, 64), generator=g, device="cuda")
                   for _ in range(4))
    mask = torch.ones((BATCH, T), dtype=torch.int32, device="cuda")
    th = port.hash_stride(T)
    o, lse = port.flash_attention_fwd(q, k, v, mask, 0.1, 5, th, return_lse=True)
    res = [torch.empty_like(q) for _ in range(3)]
    delta = torch.empty((BATCH, H, T), device="cuda")
    for lib, (source, label, _) in zip(libs, VARIANTS):
        fn = getattr(lib, source)
        fn.restype = ctypes.c_int
        if source == "flash_fwd":
            fn.argtypes = port._FWD_ARGTYPES
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), res[0].data_ptr(),
                    0, BATCH, T, T, H, 64, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    0.125, *port._dropout_args(0.0, 0, T, None, (0, 0, 0, H)), None, stream)
        else:
            fn.argtypes = port._BWD_ARGTYPES
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(), None, None,
                    *(r.data_ptr() for r in res), 0, BATCH, T, T, H, 64,
                    *(x.stride()[j] for x in (q, k, v, o, do) for j in range(3)),
                    0.125, *port._dropout_args(0.1, 5, T, th, (0, 0, 0, H)), stream)

        def call():
            if fn(*args) != 0:
                raise RuntimeError(f"{source} ({label}) launch failed")

        print(f"[probe] {source} fp32 B={BATCH} H={H} T={T}, {label}: {cuda_ms(call):.4f} ms"
              f"  [{card}]", flush=True)


if __name__ == "__main__":
    main()
