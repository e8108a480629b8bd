#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py                  # every phase (the contract's run)
    python3 chip_smoke.py --kernels-only   # phases 1, 2 and 5: build and check

Drives the port's serving path (also streaming through the hub and
standalone sessions, int16 transport and int8 W8A8 compute), its stage-0
training path (also with grad_accum, remat and prefetch, and int8), its federated 3-stage pipeline (also with
FedProx, FedAdam, top-k, secure and compressed aggregation, a
semi-supervised N-best phase and round checkpoints with their sidecars), its
system-run chain (extract, svm, detail-wer, feat-scoring) and the tools
around it (the native loaders, transcribe, export-hf, sweep, teacher), the
method variants (single-toggle, FSM) and the SEW-D backbone
(privacy_preserve_federated_asr_tpu_torch) and holds its
hand-written kernels against their plain versions. It imports nothing of JAX or of the
JAX package. Phases, in order; any failure raises and ends the run with a
non-zero exit:

1. header: the card (nvidia-smi), torch and CUDA versions, and the nvcc
   builds of the kernels in csrc/ (one nvcc process per source, together);
   nvcc's register and spill lines of each fp32 kernel (3xTF32 on the
   tensor cores), and the run fails if any of them spills;
2. kernel B1 (csrc/flash_fwd.cu) against ``attention_ref`` at the serving
   shapes (B=8, H=16, D=64; T=249 and T=1499, and the ragged T=1, 63, 65,
   129; bf16 and fp32; mixed key lengths and one row with every key masked;
   dropout 0 and 0.1; q/k/v as separate tensors and as strided views of one
   [B, T, 3*H*64] projection), and its time beside the plain version's and
   PyTorch's SDPA (a yardstick only: the port never calls SDPA) and the
   bound: bf16 on the tensor cores, fp32 as three TF32 products on them
   (3xTF32), with the fp32 FMA bound printed beside;
3. serving at full width: data2vec-audio-large DACS at stage 2 in bf16 with
   seeded random weights, an InferenceEngine (batch 8) behind the HTTP
   server, a burst of concurrent /asr requests of 1-30 s (JSON and
   octet-stream bodies), a lone request checked against ``infer_batch``,
   24 kernel launches per batch forward, B1 against ``attention_ref`` on
   the inputs the first encoder layers of a served batch give it, and
   B1's share of a batch forward's device time (torch.profiler);
4. end to end against the CPU: the same model cut to 4 layers at fp32 with
   injected numpy Gumbel noise, on the card and on the CPU (where attention
   is the plain version);
5. kernel B2 (csrc/flash_bwd.cu) against ``attention_bwd_ref`` at the
   training shapes (B=16, T=249 and B=8, T=1499, and B=8 at the ragged
   T=1, 63, 65, 129; H=16, D=64; bf16 and fp32; dropout 0 and 0.1; mixed key
   lengths and a zero-length row, the cotangent zeroed on padded query rows
   and then whole; separate q/k/v and strided views of one projection),
   every call made twice and held bit-equal (B2 is deterministic in both
   dtypes), its time in both dtypes at both training shapes beside the plain
   version's, the bound and SDPA's backward; B1's time at the training shape
   with dropout 0.1;
6. training at full width: ``cli train`` (``cli.main``) of data2vec-audio-
   large DACS stage 0 in bf16, batch 16, on synthetic 4-5 s WAVs for 12
   steps and one evaluation: 24 B1 and 24 B2 calls per step, the frozen
   params bit-unchanged, every trainable one moved and all finite, a finite
   evaluation; then the loss and grad norm (finite), step ms and utt/s over
   further steps, and B1's and B2's share of one step's device time
   (torch.profiler);
7. one training step, card against CPU: the model cut to 4 layers at fp32,
   attention dropout 0.1 from the same seeds on both;
8. federated at full width: ``cli federated -fl_st 0`` of data2vec-audio-
   large DACS in bf16 on synthetic 4-5 s WAVs (24 train in 2 round-robin
   speaker clients, public = all, 8 test), one round per stage, global_ep 1,
   local_ep 1, batch 8: per stage the B1/B2 launches (B2 = 24 x stage-0
   steps and 0 in stages 1/2, B1 = 24 x the forwards of the steps, cache
   builds and evaluations), every param outside the stage's trainable set
   bit-unchanged, the stage's head moved, all finite; the wall time of each
   warm-start, cache build and round; the three finals loaded back through
   ``cli.load_weights``; one stage-1 round's device busy share
   (torch.profiler); then ``-fl_st 3`` with DP-FedAvg for 2 rounds, whose
   ``dp_epsilon`` is finite and grows;
9. one stage-1 round, card against CPU: the model cut to 4 layers at fp32,
   clients of 3 and 2 utterances (a padding step), phase 7's rule;
10. the system-run chain at full width, through ``cli.main``: ``extract -st
   2`` of phase 8's final global model over its 24 train and 8 test WAVs,
   batch 8, at the default fp32 (24 B1 launches per batch; row counts, the
   JAX column set, [1, T_valid, 1024] rows, binary finite masks), then
   ``svm -sq mean`` (the SVC fitted on the card), ``detail-wer -t 2``,
   ``feat-scoring`` and ``pkl2csv`` on its pickles, with neither
   scikit-learn nor pandas imported; the extraction again in bf16, held to
   the fp32 rows (hidden states atol 0.15, rtol 0.1, pred_AD equal); walls,
   utt/s, the SVM fit time and B1's share of one fp32 batch's device time;
11. extraction card against CPU: the model cut to 4 layers at fp32 with the
   same injected noise (phase 4's tolerance; masks, transcripts, AD votes
   equal), and phase 10's SVM on both (equal predictions, decision values
   within 1e-6 of their largest magnitude);
12. the native loaders: ``native/libdacsaudio.so`` and ``libdacsbeam.so``
   built by ``make`` where missing and loaded through the port's ctypes
   shims (the run fails if they do not load), phase 8's corpus loaded
   natively against the scipy loader (the same samples; both timed);
13. ``cli transcribe`` of phase 8's final model over the test WAVs at full
   width: greedy, then ``--beam_size 8`` with a bigram LM fitted on the train
   CSV (24 B1 launches per batch forward; the native beam's ids equal the
   Python decoder's on the same log-posteriors; utt/s and the host ms of the
   beam decode per batch), and at stage 1 against ``cli serve`` of the same
   weights and files (transcripts equal);
14. ``cli export-hf`` of that model, then ``cli transcribe`` from the
   exported ``pytorch_model.bin`` and from a directory holding only a
   ``model.safetensors`` of it: the model's own transcripts;
15. ``cli sweep svm --preset dementia-svm`` on phase 10's pickles: 4 rows,
   the mean row equal to phase 10's ``svm -sq mean``;
16. ``cli sweep asr -st 0 --grid learning_rate=1e-5,1e-4``, one epoch of the
   corpus per combo: two rows, both combos from bit-equal params, exact B1
   and B2 launch counts;
17. ``cli train -st 0 --grad_accum 2 --remat`` (prefetch 2, the default) at
   full width in bf16, batch 8: 8 micro-steps = 4 optimizer updates and one
   evaluation; B1 = 24 x (2 per micro-step: the forward and remat's
   recompute) + 24 per eval batch, B2 = 24 per micro-step; frozen params
   bit-unchanged, all finite; micro-step ms and utt/s beside phase 6's, and
   the peak memory one micro-step adds with and without remat;
18. grad_accum and remat card against CPU: phase 7's 4-layer fp32 model on
   cached features, one update from grad_accum 2 x B=2 on the card and on the
   CPU (phase 7's rule), the same at attention dropout 0 against one update
   of B=4 on the card, and a remat step against a plain step on the card
   (bit-equality reported);
19. ``cli federated -fl_st 0`` at full width from phase 8's final model with
   ``--fedprox_mu 0.01 --server_optimizer adam --topk_fraction 0.25 -sl 0.5
   --num_lms 2``, 8 unlabeled WAVs, one round per stage and round
   checkpoints: exact B1 / B2 launches per stage with the pseudo-label passes
   (24 x 2 passes x batches) and the N-best (``mt``) steps counted, only the
   stage's network moved, the ``-server`` and ``-topk`` sidecars written;
   then stage-2 round 2 resumed from round 1's checkpoint and sidecars equals
   the run that did not stop, bit for bit;
20. phase 9's stage-1 round card against CPU once each with ``compress_bits
   8`` (nearest), ``secagg_clip_norm`` and ``topk_fraction`` (phase 9's rule);
21. int8 (W8A8) at full width: ``torch._int_mm`` at the projection shapes in
   both layouts of its second operand (checked, timed beside bf16), ``cli
   extract -st 2 --compute_dtype int8`` of phase 8's final model against
   phase 10's bf16 rows (hidden-state cosine > 0.99 per row, the JAX rule;
   AD votes reported), ``cli transcribe --compute_dtype int8`` beside phase
   13's transcripts, the engine's batch forward at 8 x 5 s and 8 x 30 s in
   int8 beside bf16 (24 B1 per forward), then ``cli train -st 0 --int8`` at
   B=16 for 3 steps: 24 B1 and 24 B2 per step, frozen params bit-unchanged,
   all finite, step ms beside phase 6's;
22. int8 card against CPU: one W8A8 product and its int8 grad-input
   bit-equal; phase 4's 4-layer fp32 model with ``dense_impl="int8"``,
   teacher-forced: every W8A8 Linear of the card on the CPU model's input
   to it bit-equal to the CPU's output, every attention core (B1) on the
   CPU's q, k, v within 1e-4; end to end the AD vote equal and the output
   distances reported; one ``int8_train`` step by phase 7's rule
   widened to that noise (loss rtol 2e-3, grad norm 5e-3, 0.5% of the
   params beyond 0.5 lr);
23. streaming at full width behind ``cli serve`` (phase 8's final model,
   stage 2, bf16): 10 streams of 10 s paced at real time in 0.5 s binary
   chunks, 8 in the hub and 2 standalone (one is ``cli stream-client``):
   per-feed latency p50 and max, hub passes per hop, bytes uploaded per hub
   pass and per standalone pass, 24 B1 per pass, the standalone streams equal a replay; then ``cli
   serve --no_hub``; then ``transport="int16"`` batches against float32
   (at fp32: votes equal, transcripts within 0.5% edit distance; at bf16
   both forwards timed);
24. streaming exactness on the card (the 4-layer model, stage 1, fp32):
   ``finish()`` equals ``infer_batch`` when nothing finalizes early (greedy
   and beam + bigram LM), resident equals legacy on every pass, hub members
   equal standalone sessions; then ``cli stream-report`` prints its rows;
25. the method variants at full width (data2vec-audio-large, bf16, B=16 x
   4-5 s, 3 steps each, lr 1e-4) through ``cli.main``: ``train --method
   single_toggle -st 1`` from phase 14's ForCTC export of phase 8's final
   model (the DACS D->4D arbitrator skipped with its warning), ``-st 2``
   from its final, ``train --method fsm -st 1`` from the export: 24 B1 per
   step and per eval batch, 24 B2 per FSM step and none for single-toggle,
   everything outside the recipe's trainable set bit-unchanged; step ms,
   one step's idle share (torch.profiler) and peak memory; ``extract`` of
   both in bf16 with each method's mask columns; one /asr request through
   ``cli serve --method fsm -st 2``;
26. the variants card against CPU (4 layers, fp32): forward outputs
   (single-toggle with injected Gumbel noise: masks equal except at Gumbel
   margins below 1e-4; FSM masks equal except where the score is within
   1e-4 of the threshold, those elements counted), one train step each by
   phase 7's rule, FSM's machines' gradient exactly zero on the card;
27. SEW-D at full width (sew_d_mid: 12 layers, D=768, 13-conv GroupNorm
   frontend, squeeze 2, 256 buckets; bf16): ``train --model_type sewd -st
   0`` (no frontend cache), ``-st 1`` (the encoder cache), ``serve -st 2``
   answering 8 concurrent 5 s and 8 concurrent 30 s requests, the batch
   forward at 8 x 5 s and 8 x 30 s timed with its peak memory, ``extract``
   in fp32 and bf16 (cosine > 0.99); 0 B1 and 0 B2 launches on every SEW-D
   path;
28. SEW-D card against CPU: the HF golden (tests/fixtures/golden_sewd.npz)
   through the bridge on the card against HF's output (rtol 2e-3, atol
   3e-4), the 4-layer fp32 model's forward (1e-3) and one stage-0 step by
   phase 7's rule;
29. ``cli teacher --method grl -st 0`` of phase 8's final model on the 8 test
   WAVs: its transcripts equal ``cli transcribe``'s greedy at fp32, and its
   CSV feeds one ``cli federated -fl_st 1 -sl 0.5 --unsup_train_csv`` round
   of the model cut to 4 layers, with exact B1 / B2 launches;
30. one JSON line listing each kernel (launches on the main paths, in all
   and by dtype: each phase that drives a main path sets the wrappers'
   counts to 0 just before and reads them just after, the fp32 card-vs-CPU
   and exactness phases 4, 7, 9, 11, 18, 20, 22, 24, 26 and 28 included; error
   against the plain version, times and bound, and under "times" the same
   numbers at each main-path shape in both dtypes), the card's name and
   power limit, and last ``{"ok": true, "device": {...}}``.

``--kernels-only`` runs phases 1, 2 and 5 and prints neither of the last
two lines.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense TF32: the fp32 paths run 3 TF32 products each
PEAK_F32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores (the FMA bound, shown beside)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
B, H, D = 8, 16, 64        # serving batch, heads, head dim
TS = (249, 1499)           # frames of the 5 s and 30 s buckets
TS_RAGGED = (1, 63, 65, 129)  # lengths that end inside a kernel tile or fill one
LAYERS = 24


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2, windows: int = 5) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back runs between CUDA
    events, the median of ``windows`` such windows: near launch scale (T=249)
    the host's launches set the time, and one stall of the host would
    otherwise set the number."""
    for _ in range(warmup):
        fn()
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
    return float(np.median(means))


def wall_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean host-clock time of ``fn`` run to completion on the card (host
    work included, unlike ``cuda_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# Launches of the main paths by phase, kernel and dtype: each wrapper's
# counts are set to 0 just before a main path runs (reset_counts) and read
# just after (tally); launches made to compare a kernel with its plain
# version are never tallied.
COUNTS: dict[str, dict[str, dict[str, int]]] = {}


def _wrappers():
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)

    return {"flash_fwd": flash_attention_fwd, "flash_bwd": flash_attention_bwd}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        fn.dtype_launches.update(dict.fromkeys(fn.dtype_launches, 0))


def tally(phase: str) -> None:
    for name, fn in _wrappers().items():
        counts = COUNTS.setdefault(phase, {}).setdefault(name, {})
        for dt, n in fn.dtype_launches.items():
            counts[dt] = counts.get(dt, 0) + n


# ---------------------------------------------------------------------------
# 1. header and build
# ---------------------------------------------------------------------------

FP32_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_dkdv_f32_kernel", "flash_bwd_dq_f32_kernel")


def header() -> None:
    from privacy_preserve_federated_asr_tpu_torch.ops import cuda_build

    log(f"[card] {card_line()}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    log(f"[build] {', '.join(cuda_build.SOURCES)}: nvcc (concurrent) and load in "
        f"{time.perf_counter() - t0:.1f} s")
    # nvcc's -Xptxas -v report of each fp32 kernel (3xTF32 on the tensor
    # cores): its registers, and its spills, which must be 0
    seen = {}
    for name in cuda_build.SOURCES:
        kernel = None
        for line in cuda_build.build_logs[name].splitlines():
            if "Function properties for" in line:
                kernel = next((k for k in FP32_KERNELS if k in line), None)
            elif kernel and ("spill" in line or "registers" in line):
                log(f"[build]   {kernel}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m:
                    seen[kernel] = (int(m[1]), int(m[2]))
    assert set(seen) == set(FP32_KERNELS), seen
    assert all(v == (0, 0) for v in seen.values()), f"an fp32 kernel spills: {seen}"
    log(f"[build] fp32 kernels {', '.join(FP32_KERNELS)}: 0 bytes of spill stores and loads")


# ---------------------------------------------------------------------------
# 2. kernel B1 against its plain version
# ---------------------------------------------------------------------------

def _qkv(t: int, dtype: torch.dtype, seed: int, b: int = B, n: int = 3,
         views: bool = False):
    """``n`` seeded [b, t, H, D] tensors; with ``views`` the first three
    (q, k, v) are strided views of one [b, t, 3*H*D] projection, as the
    encoder hands them to the kernels."""
    g = torch.Generator("cuda").manual_seed(seed)
    out = []
    if views:
        qkv = torch.randn((b, t, 3 * H * D), generator=g, device="cuda").to(dtype)
        out = [qkv[..., i * H * D:(i + 1) * H * D].view(b, t, H, D) for i in range(3)]
    return out + [torch.randn((b, t, H, D), generator=g, device="cuda").to(dtype)
                  for _ in range(n - len(out))]


def _mask(lengths, t: int | None = None) -> torch.Tensor:
    """int32 [len(lengths), t] key mask, each length clipped to [0, t]."""
    t = max(lengths) if t is None else t
    lens = torch.tensor([min(max(n, 0), t) for n in lengths], device="cuda")
    return (torch.arange(t, device="cuda")[None] < lens[:, None]).to(torch.int32)


# bf16: about two bf16 ulps of the output (rtol) over a floor well under
# the ~0.04 magnitude of a full-length row's output at T=1499
TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=4e-3),
       torch.float32: dict(rtol=0.0, atol=1e-4)}


def check_kernel() -> dict:
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        attention_ref, flash_attention_fwd)

    worst = 0.0
    for t in TS_RAGGED + TS:
        # mixed key lengths (clipped to [0, t]); row 6 has every key masked
        mask = _mask(_lengths(B, t), t)
        has_key = mask.sum(1) > 0
        for dtype in (torch.bfloat16, torch.float32):
            errs = []
            for views in (False, True):
                q, k, v = _qkv(t, dtype, seed=t, views=views)
                for rate, seed in ((0.0, 0), (0.1, 20240917)):
                    got = flash_attention_fwd(q, k, v, mask, rate, seed).float()
                    ref = attention_ref(q, k, v, mask, rate, seed).float()
                    torch.cuda.synchronize()
                    assert torch.isfinite(got).all(), "kernel output not finite"
                    err = (got[has_key] - ref[has_key]).abs().max().item()
                    torch.testing.assert_close(got[has_key], ref[has_key], **TOL[dtype])
                    errs.append(err)
            worst = max(worst, *errs)
            log(f"[kernel] T={t} {str(dtype)[6:]}: max|err| {max(errs):.3e} on valid rows "
                f"over rate 0 and 0.1, q/k/v separate and as views of one projection "
                f"(strides {q.stride()}); all-masked row finite")

    times = {}
    for t in TS:
        full = _mask([t] * B)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(t, dtype, seed=1)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T, D] views
            sdpa_mask = full.bool()[:, None, None, :]
            row = {
                "ms": cuda_ms(lambda: flash_attention_fwd(q, k, v, full), 20),
                "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, full), 3, 1),
                "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask), 20),
            }
            flops = 4.0 * B * H * t * t * D
            nbytes = 4.0 * B * t * H * D * q.element_size() + B * t * 4
            row["bound_ms"], row["bound_by"] = _bound(flops, nbytes, dtype)
            times[(t, str(dtype)[6:])] = row
            log(f"[kernel-time] T={t} {str(dtype)[6:]}: kernel {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}"
                f"{_fma_note(flops, nbytes, dtype)})  [{card_line()}]")
    return {"max_abs_err": worst, "times": times}


# ---------------------------------------------------------------------------
# 3. serving at full width
# ---------------------------------------------------------------------------

def _utterance(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    tt = np.arange(n) / 16000.0
    f0 = rng.uniform(90, 250)
    wave = sum(np.sin(2 * np.pi * f0 * h * tt + rng.uniform(0, 6.3)) / h for h in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * tt)
    return (0.3 * wave * env + rng.normal(0, 0.02, n)).astype(np.float32)


def _post(url: str, audio: np.ndarray, kind: str) -> tuple[dict, float]:
    if kind == "json":
        body, headers = json.dumps({"audio": audio.tolist()}).encode(), {
            "Content-Type": "application/json"}
    elif kind == "f32":
        body, headers = audio.astype("<f4").tobytes(), {
            "Content-Type": "application/octet-stream"}
    else:
        body, headers = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes(), {
            "Content-Type": "application/octet-stream", "X-Audio-Format": "s16"}
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(url, data=body, headers=headers),
                                timeout=300) as r:
        assert r.status == 200, r.status
        out = json.load(r)
    return out, time.perf_counter() - t0


def check_on_served_inputs(engine, n_layers: int = 4) -> float:
    """B1 against ``attention_ref`` on what the serving forward hands it:
    the q/k/v views of the bf16 projections and the int32 key mask (with
    zero-length padding rows) of the first ``n_layers`` encoder layers of
    one mixed-length batch. Returns the largest error on rows with a key."""
    from privacy_preserve_federated_asr_tpu_torch.models import backbone
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        attention_ref, flash_attention_fwd)

    mha, seen = backbone.multihead_attention, []

    def recording(q, k, v, key_mask, *dropout):
        out = mha(q, k, v, key_mask, *dropout)
        if len(seen) < n_layers:
            seen.append((q, k, v, key_mask, out))
        return out

    launches = flash_attention_fwd.launches
    backbone.multihead_attention = recording  # what Attention.forward calls
    try:
        engine.infer_batch([_utterance(s, 300 + i)
                            for i, s in enumerate((30.0, 21.0, 7.5, 1.0))])
    finally:
        backbone.multihead_attention = mha
    assert flash_attention_fwd.launches - launches == LAYERS  # the kernel ran
    assert len(seen) == n_layers, len(seen)
    worst = 0.0
    for layer, (q, k, v, key_mask, got) in enumerate(seen):
        assert q.dtype == torch.bfloat16 and torch.isfinite(got).all()
        has_key = key_mask.sum(1) > 0
        assert 0 < int(has_key.sum()) < len(has_key)  # includes padding rows
        ref = attention_ref(q, k, v, key_mask)
        got, ref = got[has_key].float(), ref[has_key].float()
        err = (got - ref).abs().max().item()
        torch.testing.assert_close(got, ref, **TOL[torch.bfloat16])
        worst = max(worst, err)
        log(f"[kernel-served] layer {layer} q{tuple(q.shape)} strides {q.stride()}: "
            f"max|err| {err:.3e}, max|out| {ref.abs().max().item():.3f}")
    return worst


def _busy_ms(events) -> float:
    """Milliseconds in which at least one of the device ``events`` ran (the
    union of their intervals: a sum counts overlapping kernels twice)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def profile_forward(engine, batch) -> dict | None:
    """Device time of one ``infer_batch`` under torch.profiler: all device
    work, B1's launches and their sum, and the host wall time (None when the
    profiler records no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.infer_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    b1 = [e for e in dev if "flash_fwd" in e.name]
    return {"device_ms": _busy_ms(dev),
            "b1_ms": sum(e.time_range.elapsed_us() for e in b1) / 1e3,
            "b1_launches": len(b1), "wall_ms": wall * 1e3}


def serve_full_width() -> dict:
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, feat_extract_output_lengths, init_dacs_state_dict)
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import flash_attention_fwd
    from privacy_preserve_federated_asr_tpu_torch.serving import (
        InferenceEngine, ServingConfig, make_server)

    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large(), stage=2)
    t0 = time.perf_counter()
    sd = init_dacs_state_dict(cfg, torch.Generator("cuda").manual_seed(0))
    engine = InferenceEngine(cfg, sd, scfg=ServingConfig(batch_size=8,
                                                         compute_dtype="bfloat16"))
    del sd
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"[serve] data2vec-audio-large DACS stage 2 bf16: {n_params / 1e6:.1f} M "
        f"params, built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine.warmup([5 * 16000, 30 * 16000])
    torch.cuda.synchronize()
    log(f"[serve] warmed the 5 s and 30 s buckets in {time.perf_counter() - t0:.1f} s")

    srv = make_server(engine, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{srv.server_address[1]}/asr"
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    engine.start()
    th.start()
    try:
        seconds = (1.0, 2.5, 4.0, 5.0, 7.0, 9.5, 12.0, 15.0, 18.0, 22.0, 26.0, 30.0)
        kinds = ("json", "f32", "s16")
        audios = [_utterance(s, 100 + i) for i, s in enumerate(seconds)]
        reset_counts()   # counts of the main path's run
        f0 = engine.forwards
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(audios)) as pool:
            replies = list(pool.map(lambda ia: _post(url, ia[1], kinds[ia[0] % 3]),
                                    enumerate(audios)))
        wall = time.perf_counter() - t0
        launches, forwards = flash_attention_fwd.launches, engine.forwards - f0
        tally("serving")
        for a, (out, _) in zip(audios, replies):
            assert out["samples"] == len(a), (out["samples"], len(a))
            assert out["frames"] == feat_extract_output_lengths(cfg.backbone, len(a))
            assert isinstance(out["transcript"], str) and out["ad_pred"] in (0, 1)
        assert forwards >= 2 and launches == LAYERS * forwards, (launches, forwards)
        lat = sorted(l for _, l in replies)
        log(f"[serve] {len(audios)} concurrent /asr -> 200 in {wall:.3f} s over "
            f"{forwards} batch forwards: {len(audios) / wall:.2f} utt/s, "
            f"{sum(seconds) / wall:.1f} s of audio per s; latency p50 "
            f"{lat[len(lat) // 2]:.3f} s, max {lat[-1]:.3f} s  [{card_line()}]")

        lone = audios[4]
        out, lone_lat = _post(url, lone, "json")
        want = engine.infer_batch([lone])[0]
        assert (out["transcript"], out["ad_pred"], out["frames"]) == (
            want.transcript, want.ad_pred, want.frames), (out, want)
        log(f"[serve] lone 7 s request ({lone_lat:.3f} s) equals infer_batch: "
            f"frames {out['frames']}, ad_pred {out['ad_pred']}, transcript "
            f"{out['transcript'][:40]!r}...")
        served_err = check_on_served_inputs(engine)

        # full batches through infer_batch (host clock; the forward ends in
        # a device-to-host copy, so the time includes the whole forward)
        forward_s = {}
        for secs in (5, 30):
            batch = [_utterance(secs, 200 + i) for i in range(B)]
            engine.infer_batch(batch)
            t0 = time.perf_counter()
            for _ in range(3):
                engine.infer_batch(batch)
            forward_s[secs] = (time.perf_counter() - t0) / 3
            log(f"[serve] infer_batch of {B} x {secs} s: {forward_s[secs] * 1e3:.1f} ms "
                f"({B / forward_s[secs]:.1f} utt/s, {B * secs / forward_s[secs]:.0f} s "
                f"of audio per s)  [{card_line()}]")
            prof = profile_forward(engine, batch)
            if prof is None:
                log(f"[share] {secs} s bucket: B1's share not measured (the "
                    f"profiler recorded no device activity)")
                continue
            assert prof["b1_launches"] == LAYERS, prof
            log(f"[share] {secs} s bucket, one infer_batch under torch.profiler: "
                f"device busy {prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} ms "
                f"wall (idle {1 - prof['device_ms'] / prof['wall_ms']:.1%}); "
                f"{LAYERS} B1 launches {prof['b1_ms']:.2f} ms = "
                f"{prof['b1_ms'] / prof['device_ms']:.1%} of device time  [{card_line()}]")
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
        th.join(timeout=10)
    del engine
    torch.cuda.empty_cache()
    return {"launches": launches, "forward_s": forward_s, "served_err": served_err}


# ---------------------------------------------------------------------------
# 4. end to end against the CPU
# ---------------------------------------------------------------------------

def end_to_end_vs_cpu() -> None:
    from privacy_preserve_federated_asr_tpu_torch.data.audio import normalize_input_values
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, DACSModel, feat_extract_output_lengths,
        init_dacs_state_dict)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large().replace(
        num_hidden_layers=4), stage=2)
    sd = init_dacs_state_dict(cfg, torch.Generator("cpu").manual_seed(1))
    x = normalize_input_values(_utterance(5.0, 7))[None]
    lengths = np.array([x.shape[1]], np.int32)
    t = feat_extract_output_lengths(cfg.backbone, x.shape[1])
    rng = np.random.default_rng(3)
    noise = [rng.gumbel(size=(1, t, cfg.hidden_size, 2)).astype(np.float32)
             for _ in range(2)]
    outs = {}
    reset_counts()  # the CPU runs the plain version: only the card's launches count
    for dev in ("cuda", "cpu"):
        with torch.device("meta"):
            model = DACSModel(cfg, torch.float32)
        model = model.to_empty(device=dev)
        model.load_state_dict(sd, strict=True)
        model.eval()
        with torch.inference_mode():
            out = model(torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev),
                        gumbel_noise=tuple(torch.from_numpy(n).to(dev) for n in noise))
        outs[dev] = {k: getattr(out, k).float().cpu()
                     for k in ("hidden_states", "logits_unmask", "logits")}
    tally("serving, card vs CPU")
    g, c = outs["cuda"], outs["cpu"]
    errs = {k: (g[k] - c[k]).abs().max().item() for k in ("hidden_states", "logits_unmask")}
    for k, e in errs.items():
        assert e <= 1e-3, (k, e)
    top2 = c["logits"][0].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    ids_g, ids_c = g["logits"][0].argmax(-1), c["logits"][0].argmax(-1)
    assert torch.equal(ids_g[clear], ids_c[clear])
    log(f"[e2e] 4-layer fp32 stage 2, 5 s: card vs CPU max|err| hidden "
        f"{errs['hidden_states']:.2e}, logits_unmask {errs['logits_unmask']:.2e}; "
        f"greedy ids equal on {int(clear.sum())}/{clear.numel()} clear frames")


# ---------------------------------------------------------------------------
# 5. kernel B2 against its plain version
# ---------------------------------------------------------------------------

BWD_SHAPES = ((16, 249), (8, 1499))   # (B, T): the training batch, a 30 s batch
BWD_RAGGED = tuple((8, t) for t in TS_RAGGED)
TRAIN_RATE, TRAIN_SEED = 0.1, 20240917
# B2's gradients against attention_bwd_ref, as max|err| over max|ref| per
# gradient: bf16 2e-2 (P and dS are rounded to bf16 as operands of the
# tensor-core products), fp32 1e-4 (sums in another order). A gradient
# that is 0 in exact arithmetic (dq and dk at T=1 without dropout: one key,
# so dS = dP - delta = 0) holds only rounding noise on both sides: where
# max|ref| < NOISE_REF, max|err| is held at NOISE_ATOL instead.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
NOISE_REF, NOISE_ATOL = 1e-3, 1e-4


def _lengths(b: int, t: int) -> list[int]:
    """Mixed key lengths with one zero-length (batch-padding) row (clip them
    to [0, t] with ``_mask``)."""
    base = [t, t - 17, t // 2, t // 3 + 1, 1, t - 1, 0, t // 4 + 5]
    return (base * (b // len(base) + 1))[:b]


def _bound(flops: float, nbytes: float, dtype: torch.dtype,
           peak: float | None = None) -> tuple[float, str]:
    """The least time for the work: its bytes at 3.35 TB/s, or its
    operations at the tensor cores' rate, bf16 or, for fp32, three TF32
    products (3xTF32) per product."""
    if peak is None:
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_TF32_FLOPS / 3
    ops_s, bytes_s = flops / peak, nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _fma_note(flops: float, nbytes: float, dtype: torch.dtype) -> str:
    """For fp32: the bound of the same work on FMA outside the tensor cores
    (67 TFLOP/s), shown beside the 3xTF32 bound."""
    if dtype != torch.float32:
        return ""
    return f"; FMA bound {_bound(flops, nbytes, dtype, PEAK_F32_FLOPS)[0]:.4f} ms"


def check_bwd_kernel() -> dict:
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        attention_bwd_ref, attention_ref, flash_attention_bwd, flash_attention_fwd,
        hash_stride)

    worst_abs, rows, n_equal = 0.0, {}, 0
    for b, t in BWD_RAGGED + BWD_SHAPES:
        mask = _mask(_lengths(b, t), t)
        th = hash_stride(t)
        for dtype in (torch.bfloat16, torch.float32):
            for views in (False, True):
                q, k, v, do = _qkv(t, dtype, seed=b * t, b=b, n=4, views=views)
                # the cotangent as training gives it (none on padded query rows),
                # then whole, so the zero-length row's 1/T weights are held too
                zeroed = do * mask[:, :, None, None].to(dtype)
                for cot_name, cot in (("padded rows zeroed", zeroed), ("whole", do)):
                    for rate in (0.0, TRAIN_RATE):
                        o, lse = flash_attention_fwd(q, k, v, mask, rate, TRAIN_SEED, th,
                                                     return_lse=True)
                        got = flash_attention_bwd(q, k, v, mask, o, cot, lse, rate,
                                                  TRAIN_SEED, th)
                        again = flash_attention_bwd(q, k, v, mask, o, cot, lse, rate,
                                                    TRAIN_SEED, th)
                        want = attention_bwd_ref(q, k, v, mask, o, cot, rate, TRAIN_SEED, th)
                        torch.cuda.synchronize()
                        ratios = []
                        for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
                            assert torch.equal(a, a2), f"B2 {name} differs between two calls"
                            n_equal += 1
                            a, w = a.float(), w.float()
                            assert torch.isfinite(a).all(), f"B2 {name} not finite"
                            if cot is zeroed:
                                assert not a[mask.sum(1) == 0].any(), \
                                    f"B2 {name}: zero-length row"
                            err = (a - w).abs().max().item()
                            worst_abs = max(worst_abs, err)
                            if w.abs().max().item() < NOISE_REF:
                                assert err <= NOISE_ATOL, (b, t, dtype, name, err)
                                ratios.append(0.0)  # held absolutely
                                continue
                            ratios.append(err / w.abs().max().item())
                            assert ratios[-1] <= BWD_TOL[dtype], (b, t, dtype, views, rate,
                                                                  cot_name, name, ratios[-1])
                        log(f"[bwd] B={b} T={t} {str(dtype)[6:]} "
                            f"{'qkv views' if views else 'separate'} rate={rate} cotangent "
                            f"{cot_name}: max|err|/max|ref| dq {ratios[0]:.2e} dk "
                            f"{ratios[1]:.2e} dv {ratios[2]:.2e} (tolerance "
                            f"{BWD_TOL[dtype]:.0e}); two calls bit-equal")
    log(f"[bwd] deterministic: {n_equal} gradients bit-equal between two calls")

    for b, t in BWD_SHAPES:
        full = _mask([t] * b)
        th = hash_stride(t)
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator("cuda").manual_seed(1)
            q, k, v, do = (torch.randn((b, t, H, D), generator=g, device="cuda").to(dtype)
                           for _ in range(4))
            rate = TRAIN_RATE
            o, lse = flash_attention_fwd(q, k, v, full, rate, TRAIN_SEED, th, return_lse=True)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            dot = do.transpose(1, 2)
            sdpa_mask = full.bool()[:, None, None, :]

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask, dropout_p=rate)

            row = {
                "ms": cuda_ms(lambda: flash_attention_bwd(q, k, v, full, o, do, lse, rate,
                                                          TRAIN_SEED, th), 20),
                "plain_ms": cuda_ms(lambda: attention_bwd_ref(q, k, v, full, o, do, rate,
                                                              TRAIN_SEED, th), 3, 1),
                "library_ms": cuda_ms(lambda: sdpa().backward(dot), 20) - cuda_ms(sdpa, 20),
            }
            flops = 10.0 * b * H * t * t * D
            nbytes = 8.0 * b * t * H * D * q.element_size() + b * t * 4
            row["bound_ms"], row["bound_by"] = _bound(flops, nbytes, dtype)
            rows[(b, t, str(dtype)[6:])] = row
            log(f"[bwd-time] B={b} T={t} {str(dtype)[6:]} rate={rate}: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa backward "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}{_fma_note(flops, nbytes, dtype)})  [{card_line()}]")

    # B1 at the training shape with dropout, saving the LSE as training does
    b, t = BWD_SHAPES[0]
    full = _mask([t] * b)
    q, k, v = (torch.randn((b, t, H, D), device="cuda").to(torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    fwd = {
        "ms": cuda_ms(lambda: flash_attention_fwd(q, k, v, full, TRAIN_RATE, TRAIN_SEED,
                                                  256, return_lse=True), 20),
        "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, full, TRAIN_RATE, TRAIN_SEED,
                                                  256), 3, 1),
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=full.bool()[:, None, None, :], dropout_p=TRAIN_RATE), 20),
    }
    fwd["bound_ms"], fwd["bound_by"] = _bound(4.0 * b * H * t * t * D,
                                              4.0 * b * t * H * D * 2 + b * t * 4,
                                              torch.bfloat16)
    log(f"[fwd-time] B1 at B={b} T={t} bf16 rate={TRAIN_RATE} (LSE saved): kernel "
        f"{fwd['ms']:.4f} ms, plain {fwd['plain_ms']:.4f} ms, sdpa {fwd['library_ms']:.4f} "
        f"ms, bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']})  [{card_line()}]")
    return {"max_abs_err": worst_abs, "times": rows, "fwd_train": fwd, "n_equal": n_equal}


# ---------------------------------------------------------------------------
# 6. training at full width through cli train
# ---------------------------------------------------------------------------

TRAIN_STEPS = 12
FROZEN_AT_STAGE0 = ("backbone.feature_extractor.", "dementia_head.", "arbitrator.",
                    "similar_fc.")
SENTENCES = ["THE BOY IS STEALING COOKIES", "WATER IS OVERFLOWING IN THE SINK",
             "SHE IS DRYING THE DISHES", "HE IS ON A STOOL", "THE WINDOW IS OPEN",
             "MOTHER IS STANDING BY THE SINK", "THE JAR IS ON THE SHELF"]


def _write_corpus(root: Path, n_train: int, n_test: int) -> None:
    """16 kHz int16 WAVs of 4-5 s, train/test CSVs and a speaker->label
    table, as scripts/make_synthetic_data.py lays them out."""
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    (root / "clips").mkdir(parents=True)
    rows, spk2label = {"train": [], "test": []}, {}
    for i in range(n_train + n_test):
        spk = f"S{i // 4:03d}"
        spk2label[spk] = (i // 4) % 2
        name = f"{spk}_PAR_{i}_0_5000.wav"
        audio = _utterance(float(rng.uniform(4.0, 5.0)), 1000 + i)
        wavfile.write(root / "clips" / name, 16000,
                      (np.clip(audio, -1, 1) * 32767).astype(np.int16))
        rows["train" if i < n_train else "test"].append(
            f"{name},{SENTENCES[i % len(SENTENCES)].lower()}")
    for split, r in rows.items():
        (root / f"{split}.csv").write_text("path,sentence\n" + "\n".join(r) + "\n")
    np.save(root / "spk2label.npy", spk2label)


def profile_step(fn, args) -> dict | None:
    """Device time of one train step under torch.profiler: all device work,
    B1's and B2's kernels, and the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3

    return {"device_ms": _busy_ms(dev), "wall_ms": wall * 1e3,
            "b1_ms": ms(e for e in dev if "flash_fwd" in e.name),
            "b2_ms": ms(e for e in dev if "flash_bwd" in e.name)}


def train_full_width() -> dict:
    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)

    b = BWD_SHAPES[0][0]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        _write_corpus(root / "data", b * TRAIN_STEPS, b)
        log(f"[train] wrote {b * TRAIN_STEPS} train and {b} test WAVs of 4-5 s in "
            f"{time.perf_counter() - t0:.1f} s")
        args = ["train", "--model_type", "data2vec", "-st", "0",
                "--compute_dtype", "bfloat16", "--train_batch_size", str(b),
                "--eval_batch_size", str(b), "--epochs", "1", "--seed", "0",
                "--audio_dir", "data/clips", "--train_csv", "data/train.csv",
                "--test_csv", "data/test.csv", "--spk2label", "data/spk2label.npy",
                "--dataset_cache", "cache", "-model_out", "out", "--device", "cuda"]
        cwd, out = os.getcwd(), io.StringIO()
        os.chdir(root)
        try:
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                tr = cli.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
            tally("cli train")
        finally:
            os.chdir(cwd)
    steps, n_eval = tr.state.step, len(tr.eval_batcher)
    ev = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"[train] cli train: {steps} steps + evaluate() in {wall:.1f} s (model init, "
        f"frontend cache and data load included); eval {ev}")
    assert steps == TRAIN_STEPS, steps
    assert all(np.isfinite(v) for v in ev.values()), ev
    assert b2 == LAYERS * steps and b1 == LAYERS * (steps + n_eval), (b1, b2, steps, n_eval)
    log(f"[train] launches: B1 {b1} = {LAYERS} x ({steps} steps + {n_eval} eval "
        f"forward), B2 {b2} = {LAYERS} x {steps} steps")

    init = cli.load_weights(tr.cfg, None, 0, "cuda")  # cmd_train's own init
    final = tr.state.model.state_dict()
    frozen = [k for k in final if k.startswith(FROZEN_AT_STAGE0)]
    for k, v in final.items():
        same = torch.equal(v, init[k])
        assert same == (k in frozen), (k, same)
        # a non-finite loss or gradient at any step would have reached them
        assert torch.isfinite(v).all(), k
    log(f"[train] {len(frozen)} frozen tensors bit-unchanged; all "
        f"{len(final) - len(frozen)} trainable tensors moved and finite (lr 0 at step 1, "
        f"then warmup to 1e-5 over 1000 steps)")

    # step time over further steps (the first two dropped), then one profiled
    times, metrics, batches = [], [], tr.train_batches(1)
    for _ in range(10):
        n_real, (fn, fn_args) = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(fn(tr.state, *fn_args))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    metrics = [{k: float(m[k]) for k in ("loss", "grad_norm")} for m in metrics]
    assert all(np.isfinite(list(m.values())).all() for m in metrics), metrics
    log(f"[train] steps {steps + 1}-{steps + len(metrics)}: loss {metrics[0]['loss']:.1f} "
        f"-> {metrics[-1]['loss']:.1f}, grad norm {metrics[0]['grad_norm']:.1f} -> "
        f"{metrics[-1]['grad_norm']:.1f}, all finite")
    step_s = float(np.mean(times[2:]))
    log(f"[train] stage-0 step (B={b} x 5 s bucket, T=249, bf16, cached frontend): "
        f"{step_s * 1e3:.1f} ms mean over {len(times) - 2} steps (min "
        f"{min(times[2:]) * 1e3:.1f}, max {max(times[2:]) * 1e3:.1f}), "
        f"{b / step_s:.1f} utt/s  [{card_line()}]")
    n_real, (fn, fn_args) = next(batches)
    prof = profile_step(fn, (tr.state, *fn_args))
    if prof is None:
        log("[share] training step: B1/B2 shares not measured (the profiler recorded no "
            "device activity)")
    else:
        log(f"[share] one training step under torch.profiler: device busy "
            f"{prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} ms wall (idle "
            f"{1 - prof['device_ms'] / prof['wall_ms']:.1%}); B1 {prof['b1_ms']:.2f} ms = "
            f"{prof['b1_ms'] / prof['device_ms']:.1%}, B2 {prof['b2_ms']:.2f} ms = "
            f"{prof['b2_ms'] / prof['device_ms']:.1%} of device time  [{card_line()}]")
    # two parts of the step alone, host clock: the CTC loss (Python loops
    # over the frames) and the optimizer (clip + fused AdamW)
    from privacy_preserve_federated_asr_tpu_torch.ops.ctc import ctc_loss

    g = torch.Generator("cuda").manual_seed(5)
    lp = torch.randn((b, 249, 32), generator=g, device="cuda").log_softmax(-1)
    lp.requires_grad_()
    lab = torch.randint(1, 32, (b, 32), generator=g, device="cuda")
    ll = torch.full((b,), 30, device="cuda")
    fl = torch.full((b,), 249, device="cuda")
    ctc_ms = wall_ms(lambda: ctc_loss(lp, lab, fl, ll).backward(), 5)
    opt_ms = wall_ms(tr.state.tx.step, 5)
    log(f"[train] parts of a step alone (host clock): CTC loss forward + backward "
        f"{ctc_ms:.1f} ms, clip + fused AdamW {opt_ms:.1f} ms, so the encoder and heads "
        f"forward + backward take about {step_s * 1e3 - ctc_ms - opt_ms:.1f} ms  "
        f"[{card_line()}]")
    del tr, init, final
    torch.cuda.empty_cache()
    return {"b1": b1, "b2": b2, "step_s": step_s}


# ---------------------------------------------------------------------------
# 7. one training step, card against CPU
# ---------------------------------------------------------------------------

def train_step_vs_cpu(dense_impl: str = "fp", rtols: tuple = (1e-4, 1e-3),
                      apart: float = 1e-2) -> None:
    """Phase 7 (and, with ``dense_impl="int8_train"``, phase 22's step):
    loss and grad norm held to ``rtols``, at most 0.5% of the param elements
    further apart than ``apart`` x lr."""
    from privacy_preserve_federated_asr_tpu_torch.data.audio import normalize_input_values
    from privacy_preserve_federated_asr_tpu_torch.data.tokenizer import CTCCharTokenizer
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, DACSModel, init_dacs_state_dict)
    from privacy_preserve_federated_asr_tpu_torch.train import (
        FeatureBatch, create_train_state, frontend_forward_fn, make_feature_train_step,
        make_optimizer)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lr, n_steps = 1e-4, 2
    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large().replace(
        num_hidden_layers=4, hidden_dropout=0.0, activation_dropout=0.0,
        feat_proj_dropout=0.0, attention_dropout=TRAIN_RATE, dense_impl=dense_impl), stage=0)
    tag = "train-e2e" if dense_impl == "fp" else f"train-e2e {dense_impl}"
    sd = init_dacs_state_dict(cfg, torch.Generator("cpu").manual_seed(2))
    x = np.zeros((2, 80000), np.float32)
    x[0] = normalize_input_values(_utterance(5.0, 11))
    x[1, :67200] = normalize_input_values(_utterance(4.2, 12))
    il = np.array([80000, 67200], np.int32)
    tok = CTCCharTokenizer()
    ids = [tok.encode(s) for s in SENTENCES[:2]]
    labels = np.full((2, 32), -100, np.int64)
    for i, s in enumerate(ids):
        labels[i, : len(s)] = s
    host = dict(labels=labels, label_lengths=np.array([len(s) for s in ids]),
                dementia_labels=np.array([1, 0]), sample_mask=np.ones(2, np.float32))

    def run(dev, feats, fl):
        with torch.device("meta"):
            model = DACSModel(cfg, torch.float32)
        model = model.to_empty(device=dev)
        model.load_state_dict(sd)
        state = create_train_state(model, make_optimizer(model, 0, learning_rate=lr), 3)
        batch = FeatureBatch(feats.to(dev), fl.to(dev),
                             **{k: torch.from_numpy(v).to(dev) for k, v in host.items()})
        step = make_feature_train_step(cfg)
        metrics = [{k: float(v) for k, v in step(state, batch).items()}
                   for _ in range(n_steps)]
        return metrics, {k: v.cpu() for k, v in model.state_dict().items()}

    # the frozen frontend (the stage-0 cache) on each device, compared
    # alone; the steps under test then take the same (CPU) features
    feats, fl = {}, {}
    reset_counts()  # the CPU runs the plain versions: only the card's launches count
    for dev in ("cuda", "cpu"):
        with torch.device("meta"):
            fe = DACSModel(cfg, torch.float32)
        fe = fe.to_empty(device=dev)
        fe.load_state_dict(sd)
        feats[dev], fl[dev] = (t.cpu() for t in frontend_forward_fn(fe)(
            torch.from_numpy(x).to(dev), torch.from_numpy(il).to(dev)))
    fe_err = ((feats["cuda"] - feats["cpu"]).abs().max() / feats["cpu"].abs().max()).item()
    assert torch.equal(fl["cuda"], fl["cpu"]) and fe_err <= 1e-4, fe_err
    m_gpu, p_gpu = run("cuda", feats["cpu"], fl["cpu"])
    m_cpu, p_cpu = run("cpu", feats["cpu"], fl["cpu"])
    m_own, _ = run("cuda", feats["cuda"], fl["cuda"])
    tally("training step, card vs CPU" if dense_impl == "fp"
          else f"{dense_impl} training step, card vs CPU")
    log(f"[{tag}] frontend card vs CPU max|err|/max|ref| {fe_err:.2e}; per step "
        f"(loss, grad norm) card {[(m['loss'], m['grad_norm']) for m in m_gpu]}, CPU "
        f"{[(m['loss'], m['grad_norm']) for m in m_cpu]}, card on its own frontend "
        f"{[(m['loss'], m['grad_norm']) for m in m_own]}")
    # loss rtol 1e-4; grad norm rtol 1e-3: the CTC posterior of this
    # near-uniform random model moves by ~1e-4 with the exp/log of another
    # library (tests/test_torch_losses.py::test_ctc_long_sequence_matches_jax)
    for a, c in zip(m_gpu, m_cpu):
        for k, rtol in zip(("loss", "grad_norm"), rtols):
            assert abs(a[k] - c[k]) <= rtol * abs(c[k]), (k, a[k], c[k])
    # Adam divides by |g|, so an element whose gradient is at rounding level
    # moves by up to lr on either device: no bound on the largest difference
    # can fail (every element moves at most about lr per step). What holds a
    # wrong gradient to account is the share of elements further apart than
    # 1e-2 lr: at most 0.5%.
    worst, off = 0.0, 0
    for k, c in p_cpu.items():
        assert torch.isfinite(p_gpu[k]).all(), k
        diff = (p_gpu[k] - c).abs()
        worst = max(worst, diff.max().item())
        off += int((diff > apart * lr).sum())
    frac = off / sum(v.numel() for v in p_cpu.values())
    log(f"[{tag}] 4-layer fp32 stage 0, attention dropout {TRAIN_RATE}, {n_steps} "
        f"AdamW steps at lr {lr}: card vs CPU loss {m_gpu[-1]['loss']:.4f} / "
        f"{m_cpu[-1]['loss']:.4f}, grad norm {m_gpu[-1]['grad_norm']:.4f} / "
        f"{m_cpu[-1]['grad_norm']:.4f} (rtol {rtols[0]:g}, {rtols[1]:g}); params max|diff| "
        f"{worst:.2e}, {frac:.2e} of elements beyond {apart:g} lr (limit 5e-3)")
    assert frac <= 5e-3, frac


# ---------------------------------------------------------------------------
# 8. the federated pipeline at full width through cli federated
# ---------------------------------------------------------------------------

FL_TRAIN, FL_TEST, FL_BATCH = 24, 8, 8
FL_ARGS = ["--model_type", "data2vec", "--compute_dtype", "bfloat16",
           "--train_batch_size", str(FL_BATCH), "--eval_batch_size", str(FL_BATCH),
           "--num_users", "2", "--local_ep", "1", "--global_ep", "1", "--seed", "0",
           "--audio_dir", "data/clips", "--train_csv", "data/train.csv",
           "--test_csv", "data/test.csv", "--spk2label", "data/spk2label.npy",
           "--dataset_cache", "cache", "--device", "cuda"]


@contextlib.contextmanager
def _cwd(root: Path):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        yield
    finally:
        os.chdir(cwd)


def _run_cli(root: Path, args: list[str]):
    """``cli.main(args)`` in ``root``, its stdout captured; returns (its
    return value, the stdout, host seconds)."""
    from privacy_preserve_federated_asr_tpu_torch import cli

    out = io.StringIO()
    with _cwd(root), contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        ret = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return ret, out.getvalue(), wall


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def federated_full_width(root: Path) -> dict:
    """``cli federated -fl_st 0`` (the three stages) at full width in
    ``root`` with the per-stage checks, one stage-1 round under
    torch.profiler, then a short DP-FedAvg run of stage 3. Leaves the corpus
    in ``root/data`` and the finals in ``root/out`` for phase 10."""
    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.federated.engine import FederatedEngine
    from privacy_preserve_federated_asr_tpu_torch.models.recipes import (
        stage_trainable_predicate)
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)
    from privacy_preserve_federated_asr_tpu_torch.train.optim import path_of

    n_train_batches, n_eval_batches = -(-FL_TRAIN // FL_BATCH), -(-FL_TEST // FL_BATCH)
    stages, originals = {}, {}

    def checked(name: str, stage: int):
        """``FederatedEngine.run_stage{stage + 1}`` with the stage's launch
        counts (read, not reset), its log rows and the frozen / moved /
        finite checks of its params."""
        def run(eng):
            before = {k: v.clone() for k, v in eng.global_params.items()}
            b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
            n_rows = len(eng.logger.history)
            out = originals[name](eng)
            pred, moved = stage_trainable_predicate(stage), []
            for k, v in eng.global_params.items():
                assert torch.isfinite(v).all(), (stage, k)
                if not torch.equal(v, before[k]):
                    assert pred(path_of(k)), f"stage {stage}: frozen {k} changed"
                    moved.append(k)
            stages[stage] = {"b1": flash_attention_fwd.launches - b1,
                             "b2": flash_attention_bwd.launches - b2,
                             "rows": eng.logger.history[n_rows:], "moved": moved,
                             "trainable": sum(map(pred, map(path_of, before)))}
            return out
        return run

    for name, stage in (("run_stage1", 0), ("run_stage2", 1), ("run_stage3", 2)):
        originals[name] = getattr(FederatedEngine, name)
        setattr(FederatedEngine, name, checked(name, stage))
    t0 = time.perf_counter()
    _write_corpus(root / "data", FL_TRAIN, FL_TEST)
    log(f"[federated] wrote {FL_TRAIN} train and {FL_TEST} test WAVs of 4-5 s in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        reset_counts()
        eng, out, wall = _run_cli(root, ["federated", *FL_ARGS, "--epochs", "1",
                                         "-fl_st", "0", "-model_out", "out/fl"])
        ev = _last_json(out)
        b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
        tally("cli federated")
    finally:
        for name, fn in originals.items():
            setattr(FederatedEngine, name, fn)
    log(f"[federated] cli federated -fl_st 0 (data2vec-audio-large DACS bf16, 2 "
        f"clients of {FL_TRAIN // 2}, public = all {FL_TRAIN}, 1 round per stage, global_ep 1, "
        f"local_ep 1, batch {FL_BATCH}): {wall:.1f} s of host time (model init, data "
        f"load and the three finals included); final eval {ev}  [{card_line()}]")
    assert all(np.isfinite(v) for v in ev.values()), ev

    for stage, s in stages.items():
        rows = s["rows"]
        ws = sum(r["warm_start_steps"] for r in rows if "warm_start_steps" in r)
        local = sum(r["local_steps"] for r in rows if "local_steps" in r)
        cache_fwd = sum(r["hidden_cache_forwards"] for r in rows
                        if "hidden_cache_forwards" in r)
        n_evals = sum("eval_loss" in r for r in rows)
        if stage == 0:
            want = (LAYERS * (ws + local + n_evals * n_eval_batches), LAYERS * (ws + local))
        else:  # the Trainer's train cache, the round cache and the eval cache
            want = (LAYERS * (n_train_batches + cache_fwd + n_eval_batches), 0)
        assert (s["b1"], s["b2"]) == want, (stage, s["b1"], s["b2"], want, rows)
        assert {r["phase"] for r in rows if "local_steps" in r} == {
            "res" if stage == 0 else "res_h"}, rows
        head = {0: "lm_head.weight", 1: "dementia_head.weight", 2: "arbitrator.weight"}
        assert head[stage] in s["moved"], (stage, len(s["moved"]))
        times = [f"warm-start {r['warm_start_s']:.2f} s ({r['warm_start_steps']:.0f} "
                 f"steps, its train cache {r['train_cache_s']:.2f} s)"
                 for r in rows if "warm_start_s" in r]
        times += [f"hidden cache {r['hidden_cache_s']:.2f} s "
                  f"({r['hidden_cache_forwards']:.0f} forwards of {FL_BATCH})"
                  for r in rows if "hidden_cache_s" in r]
        times += [f"round {r['fl_round']:.0f} {r['round_s']:.2f} s ({r['local_steps']:.0f} "
                  f"{r['phase']} steps, clients "
                  + ", ".join(f"{r[k]:.3f}" for k in r if k.endswith("_loss")) + ")"
                  for r in rows if "local_steps" in r]
        log(f"[federated] stage {stage}: B1 {s['b1']}, B2 {s['b2']} launches (as "
            f"expected); {len(s['moved'])} of {s['trainable']} trainable tensors moved, "
            f"every other one bit-unchanged, all finite; " + "; ".join(times)
            + f"  [{card_line()}]")

    cfg = eng.cfg
    for name in ("FLASR", "FLAD", "final"):
        sd = cli.load_weights(cfg, str(root / f"out/fl_{name}_global/final"), 0, "cuda")
        assert set(sd) == set(eng.global_params), name
    assert all(torch.equal(sd[k], v.cpu()) for k, v in eng.global_params.items())
    log("[federated] the three finals (FLASR, FLAD, final) load back through "
        "cli.load_weights; the last equals the engine's global params")

    # one more stage-1 round (plan round 0 again) on the cached encoder
    # output, its evaluation included, under torch.profiler
    with _cwd(root), contextlib.redirect_stdout(io.StringIO()):
        prof = profile_step(eng.run_rounds, (1, 1))
    if prof is None:
        log("[share] stage-1 round: device busy not measured (the profiler recorded "
            "no device activity)")
    else:
        log(f"[share] one stage-1 round (4 head-only steps on the cached encoder output "
            f"+ FedAvg + graft + evaluation) under torch.profiler: device busy "
            f"{prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} ms wall (idle "
            f"{1 - prof['device_ms'] / prof['wall_ms']:.1%}); B1 {prof['b1_ms']:.2f} ms, "
            f"B2 {prof['b2_ms']:.2f} ms  [{card_line()}]")
    del eng
    torch.cuda.empty_cache()

    # DP-FedAvg: stage 3 alone, two rounds
    b1_dp = flash_attention_fwd.launches
    dp_eng, out, dp_wall = _run_cli(root, [
        "federated", *FL_ARGS, "--epochs", "2", "-fl_st", "3", "--dp_clip_norm", "1.0",
        "--dp_noise_multiplier", "1.0", "-model_out", "out/dp"])
    dp_ev = _last_json(out)
    eps = [r["dp_epsilon"] for r in dp_eng.logger.history if "local_steps" in r]
    assert len(eps) == 2 and all(np.isfinite(eps)) and eps[0] < eps[1], eps
    assert all(np.isfinite(v) for v in dp_ev.values()), dp_ev
    assert all(torch.isfinite(v).all() for v in dp_eng.global_params.values())
    log(f"[federated-dp] cli federated -fl_st 3 --dp_clip_norm 1.0 "
        f"--dp_noise_multiplier 1.0, 2 rounds: dp_epsilon {eps} (delta 1e-5, q = 1), "
        f"finite and growing; {dp_wall:.1f} s of host time, "
        f"{flash_attention_fwd.launches - b1_dp} B1 launches; final eval {dp_ev}  "
        f"[{card_line()}]")
    del dp_eng
    torch.cuda.empty_cache()
    return {"b1": b1, "b2": b2, "stages": {s: (v["b1"], v["b2"]) for s, v in stages.items()}}


# ---------------------------------------------------------------------------
# 9. one stage-1 round, card against CPU
# ---------------------------------------------------------------------------

def federated_round_vs_cpu() -> None:
    """One stage-1 round of the 4-layer fp32 model on the card and on the
    CPU, held to phase 7's rule."""
    from privacy_preserve_federated_asr_tpu_torch.data import (
        AsrExample, CTCCharTokenizer, prepare_examples)
    from privacy_preserve_federated_asr_tpu_torch.federated import (
        FederatedConfig, FederatedEngine)
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, init_dacs_state_dict)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = 1e-4
    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large().replace(
        num_hidden_layers=4, hidden_dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, final_dropout=0.0), stage=1)
    sd = init_dacs_state_dict(cfg, torch.Generator("cpu").manual_seed(4))
    tok = CTCCharTokenizer()

    def client(n, base):
        return prepare_examples([AsrExample(
            path=f"C{base}_{i}.wav", array=_utterance(1.5 + 0.4 * i, base + i),
            text=SENTENCES[(base + i) % len(SENTENCES)], dementia_label=(base + i) % 2)
            for i in range(n)], tok)

    clients = {0: client(3, 40), 1: client(2, 50)}
    out = {}
    reset_counts()  # the CPU runs the plain versions: only the card's launches count
    for dev in ("cuda", "cpu"):
        eng = FederatedEngine(cfg, FederatedConfig(
            num_rounds=1, local_ep=1, batch_size=2, eval_batch_size=2, learning_rate=lr,
            log_dir="."), clients, [], None, tok, sd, device=dev)
        params = eng.run_rounds(stage=1, num_rounds=1)
        row = [r for r in eng.logger.history if "local_steps" in r][0]
        assert row["phase"] == "res_h" and row["dead_step_frac"] > 0, row
        out[dev] = (row, {k: v.cpu() for k, v in params.items()})
        del eng
    tally("federated round, card vs CPU")
    (rg, pg), (rc, pc) = out["cuda"], out["cpu"]
    losses = [(rg[f"client{c}_loss"], rc[f"client{c}_loss"]) for c in (0, 1)]
    for g, c in losses:
        assert abs(g - c) <= 1e-4 * abs(c), losses
    worst, off = 0.0, 0
    for k, c in pc.items():
        assert torch.isfinite(pg[k]).all(), k
        assert k.startswith("dementia_head.") or torch.equal(pg[k], c), k
        diff = (pg[k] - c).abs()
        worst = max(worst, diff.max().item())
        off += int((diff > 1e-2 * lr).sum())
    frac = off / sum(v.numel() for v in pc.values())
    assert frac <= 5e-3, frac
    log(f"[federated-e2e] one stage-1 round, 4-layer fp32, clients of 3 and 2 (a padding "
        f"step), lr {lr}: client losses card / CPU {losses} (rtol 1e-4); params max|diff| "
        f"{worst:.2e}, {frac:.2e} of elements beyond 1e-2 lr (limit 5e-3); only "
        f"dementia_head moved")


# ---------------------------------------------------------------------------
# 10. the system-run chain at full width: extract -> svm -> detail-wer ->
#     feat-scoring -> pkl2csv
# ---------------------------------------------------------------------------

EXTRACT_ARGS = ["extract", "--model_type", "data2vec", "-st", "2",
                "-model_in", "out/fl_final_global/final", "--audio_dir", "data/clips",
                "--train_csv", "data/train.csv", "--test_csv", "data/test.csv",
                "--spk2label", "data/spk2label.npy", "--dataset_cache", "cache",
                "--eval_batch_size", str(FL_BATCH), "--device", "cuda"]
ROW_COLUMNS = {"path", "text", "dementia_labels", "hidden_states", "pred_str", "pred_AD",
               "dementia_logits", "lm_mask", "dementia_mask"}


def profile_extraction_batch(root: Path, model_dir: str) -> dict | None:
    """Device time of one fp32 extraction batch forward (the model, the
    recipe's streams, greedy ids and the AD vote) under torch.profiler; the
    model is built and loaded before the profiled window."""
    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.data import (
        CTCCharTokenizer, LengthBucketBatcher, csv_to_examples, load_spk2label,
        prepare_examples)
    from privacy_preserve_federated_asr_tpu_torch.evaluation.extract import (
        batch_inputs, load_model)
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, get_recipe)
    from privacy_preserve_federated_asr_tpu_torch.ops.decode import ad_vote, greedy_ids

    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large(), stage=2)
    recipe = get_recipe(cfg.method)
    model = load_model(recipe.make_model, cfg, cli.load_weights(cfg, str(root / model_dir)),
                       torch.float32, torch.device("cuda"))
    exs = prepare_examples(csv_to_examples(
        str(root / "data/clips"), str(root / "data/test.csv"),
        load_spk2label(str(root / "data/spk2label.npy"))), CTCCharTokenizer())
    b = next(LengthBucketBatcher(exs, FL_BATCH).epoch(epoch_seed=0))
    gen = torch.Generator("cuda")

    def forward():
        with torch.inference_mode():
            x, lengths, noise = batch_inputs(cfg, b, 0, gen, None, torch.device("cuda"))
            out = model(x, lengths, gumbel_noise=noise)
            ctc, dlog, _, _ = recipe.extract_streams(out, cfg)
            return greedy_ids(ctc, out.frame_mask), ad_vote(dlog, out.frame_mask)

    forward()
    prof = profile_step(forward, ())
    del model
    torch.cuda.empty_cache()
    return prof


def extraction_chain(root: Path) -> dict:
    """``cli extract -st 2`` (fp32, the default) of phase 8's final global
    model over its 24 train and 8 test WAVs, then ``svm``, ``detail-wer``,
    ``feat-scoring`` and ``pkl2csv`` on the pickles, all through
    ``cli.main``; then the extraction in bf16, held to the fp32 rows."""
    from privacy_preserve_federated_asr_tpu_torch.evaluation import read_records
    from privacy_preserve_federated_asr_tpu_torch.evaluation.svm_ad import (
        RbfSVC, _features, standard_scale)
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, feat_extract_output_lengths)
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import flash_attention_fwd
    from scipy.io import wavfile

    bb = BackboneConfig.data2vec_audio_large()
    n_batches = -(-FL_TEST // FL_BATCH) + -(-FL_TRAIN // FL_BATCH)
    frames = {p.name: feat_extract_output_lengths(bb, len(wavfile.read(p)[1]))
              for p in (root / "data/clips").iterdir()}
    runs = {}
    for dtype in ("float32", "bfloat16"):
        reset_counts()   # counts of the main path's run
        _, _, wall = _run_cli(root, [*EXTRACT_ARGS, "--compute_dtype", dtype,
                                     "--csv_out_dir", f"res_{dtype}"])
        launches = flash_attention_fwd.launches
        tally("cli extract")
        assert launches == LAYERS * n_batches, (dtype, launches, n_batches)
        test = read_records(str(root / f"res_{dtype}/extract.pkl"))
        train = read_records(str(root / f"res_{dtype}/extract_train.pkl"))
        assert (len(test), len(train)) == (FL_TEST, FL_TRAIN), (len(test), len(train))
        for r in test + train:
            assert set(r) == ROW_COLUMNS, sorted(r)
            t = frames[Path(r["path"]).name]
            for k in ("hidden_states", "lm_mask", "dementia_mask"):
                assert r[k].shape == (1, t, bb.hidden_size) and r[k].dtype == np.float32, \
                    (k, r[k].shape, t)
                assert np.isfinite(r[k]).all(), k
            for k in ("lm_mask", "dementia_mask"):
                assert set(np.unique(r[k])) <= {0.0, 1.0}, k
            assert r["dementia_logits"].shape == (1, t, 2) and r["pred_AD"] in (0, 1)
        on = float(np.mean([r["lm_mask"].mean() for r in test]))
        runs[dtype] = {"wall": wall, "launches": launches, "test": test, "train": train}
        log(f"[extract] cli extract -st 2 --compute_dtype {dtype} (data2vec-audio-large DACS, "
            f"phase 8's final global model, batch {FL_BATCH}): {FL_TEST} test + {FL_TRAIN} "
            f"train rows in {wall:.2f} s of host time (model load and data included), "
            f"{(FL_TEST + FL_TRAIN) / wall:.1f} utt/s; B1 {launches} launches = {LAYERS} x "
            f"{n_batches} batches; rows [1, T_valid, 1024] fp32, binary masks (lm on-rate "
            f"{on:.3f}), all finite  [{card_line()}]")

    r32 = {r["path"]: r for r in runs["float32"]["test"] + runs["float32"]["train"]}
    worst = 0.0
    for r in runs["bfloat16"]["test"] + runs["bfloat16"]["train"]:
        a = r32[r["path"]]
        np.testing.assert_allclose(r["hidden_states"], a["hidden_states"], atol=0.15, rtol=0.1)
        worst = max(worst, float(np.abs(r["hidden_states"] - a["hidden_states"]).max()))
        assert r["pred_AD"] == a["pred_AD"], r["path"]
    log(f"[extract] bf16 rows against fp32: hidden states max|diff| {worst:.3e} (atol 0.15, "
        f"rtol 0.1), pred_AD equal on all {FL_TEST + FL_TRAIN}")

    prof = profile_extraction_batch(root, "out/fl_final_global/final")
    if prof is None:
        log("[share] extraction batch: B1's share not measured (the profiler recorded no "
            "device activity)")
    else:
        log(f"[share] one fp32 extraction batch forward (B={FL_BATCH}, 5 s bucket) under "
            f"torch.profiler: device busy {prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} "
            f"ms wall (idle {1 - prof['device_ms'] / prof['wall_ms']:.1%}); {LAYERS} B1 "
            f"launches {prof['b1_ms']:.2f} ms = {prof['b1_ms'] / prof['device_ms']:.1%} of "
            f"device time  [{card_line()}]")

    res = root / "res_float32"
    _, svm_text, svm_wall = _run_cli(root, [
        "svm", "--train_pkl", str(res / "extract_train.pkl"), "--test_pkl",
        str(res / "extract.pkl"), "--spk2label", "data/spk2label.npy", "-sq", "mean",
        "--results_csv", str(res / "svm.csv"), "--device", "cuda"])
    svm = json.loads(svm_text)
    assert set(svm) == {"ACC", "BACC", "F1", "Sens", "Spec", "UAR"} and all(
        0.0 <= v <= 1.0 for v in svm.values()), svm
    x_train, y_train = _features(runs["float32"]["train"], "mean", False)
    x_test, _ = _features(runs["float32"]["test"], "mean", False)
    xs = standard_scale(*(torch.from_numpy(x).to("cuda", torch.float64)
                          for x in (x_train, x_test)))
    y = torch.from_numpy(y_train).to("cuda")
    RbfSVC().fit(xs[0], y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = RbfSVC().fit(xs[0], y)
    fit_ms = (time.perf_counter() - t0) * 1e3
    log(f"[svm] cli svm -sq mean on the card: {svm} in {svm_wall:.2f} s of host time; "
        f"RbfSVC fit on {len(x_train)} x {x_train.shape[1]} fp64 features: {model.n_iter} "
        f"SMO updates, {len(model.dual_coef)} support vectors, {fit_ms:.1f} ms  "
        f"[{card_line()}]")

    wer = json.loads(_run_cli(root, ["detail-wer", "--pkl", str(res / "extract.pkl"),
                                     "-t", "2"])[1])
    test = runs["float32"]["test"]
    n_words = sum(len(r["text"].split()) for r in test)
    o = wer["overall"]
    assert o["hits"] + o["substitutions"] + o["deletions"] == n_words and o["n_utts"] == FL_TEST
    fsm = json.loads(_run_cli(root, ["feat-scoring", "--pkl", str(res / "extract.pkl"),
                                     "--out_dir", str(res / "fsm")])[1])
    assert all(0.0 <= fsm[k] <= 1.0 for k in ("lm_on_rate", "ad_on_rate", "rate_11", "mex_rate"))
    assert (res / "fsm/node_stats.npz").exists() and (res / "fsm/utt_on_rates.npz").exists()
    assert json.loads(_run_cli(root, ["pkl2csv", "--pkl", str(res / "extract.pkl")])[1])[
        "rows"] == FL_TEST
    assert len((res / "extract.csv").read_text().splitlines()) == FL_TEST + 1
    assert (res / "Result.csv").exists()
    assert not {"sklearn", "pandas"} & set(sys.modules), "the chain imported sklearn/pandas"
    log(f"[chain] detail-wer -t 2: overall WER {o['wer']:.3f} over {n_words} reference "
        f"words (hits + subs + dels = {n_words}), groups {sorted(wer)}; feat-scoring: lm on "
        f"{fsm['lm_on_rate']:.3f}, AD on {fsm['ad_on_rate']:.3f}, both {fsm['rate_11']:.3f}, "
        f"mutual info {fsm['mutual_info']:.2e}; pkl2csv {FL_TEST} rows; Result.csv written; "
        f"neither sklearn nor pandas imported")
    return {"launches": {k: v["launches"] for k, v in runs.items()},
            "walls": {k: v["wall"] for k, v in runs.items()}, "svm": svm,
            "features": (x_train, y_train, x_test)}


# ---------------------------------------------------------------------------
# 11. extraction and the SVM, card against CPU
# ---------------------------------------------------------------------------

NEAR_TIE = 1e-4  # a Gumbel argmax margin within the devices' rounding of the scores


def extraction_vs_cpu(features) -> None:
    """The extraction of the model cut to 4 layers at fp32 with the same
    injected Gumbel noise on the card and on the CPU (phase 4's tolerance;
    masks equal except where the CPU's Gumbel margin is below ``NEAR_TIE``;
    transcripts and AD votes equal), and phase 10's SVM on both."""
    from privacy_preserve_federated_asr_tpu_torch.data import (
        AsrExample, CTCCharTokenizer, LengthBucketBatcher, prepare_examples)
    from privacy_preserve_federated_asr_tpu_torch.evaluation import extract_embeddings
    from privacy_preserve_federated_asr_tpu_torch.evaluation.extract import (
        batch_inputs, load_model)
    from privacy_preserve_federated_asr_tpu_torch.evaluation.svm_ad import (
        RbfSVC, standard_scale)
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, DACSModel, init_dacs_state_dict)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large().replace(
        num_hidden_layers=4), stage=2)
    sd = init_dacs_state_dict(cfg, torch.Generator("cpu").manual_seed(6))
    tok = CTCCharTokenizer()
    exs = prepare_examples([AsrExample(
        path=f"S{i:03d}_PAR_{i}.wav", array=_utterance(s, 60 + i), text=SENTENCES[i],
        dementia_label=i % 2) for i, s in enumerate((0.5, 0.8, 0.3))], tok)

    def noise(shape):
        rng = np.random.default_rng(list(shape))
        return tuple(rng.gumbel(size=shape).astype(np.float32) for _ in range(2))

    reset_counts()  # the CPU runs the plain version: only the card's launches count
    rows = {dev: extract_embeddings(cfg, sd, exs, tok, batch_size=2, device=dev,
                                    gumbel_noise=noise) for dev in ("cuda", "cpu")}
    tally("extraction, card vs CPU")
    # each mask element's Gumbel argmax margin (s0 + g0) - (s1 + g1) in the
    # CPU run: the scores differ by rounding between the devices, so an
    # element whose margin is within rounding may take either side
    model = load_model(DACSModel, cfg, sd, torch.float32, torch.device("cpu"))
    margin = {}
    for b in LengthBucketBatcher(exs, 2).epoch(epoch_seed=0):
        with torch.inference_mode():
            x, lengths, (gl, ga) = batch_inputs(cfg, b, 0, None, noise, torch.device("cpu"))
            out = model(x, lengths, gumbel_noise=(gl, ga))
        for key, score, g in (("lm_mask", out.lm_score, gl), ("dementia_mask", out.ad_score, ga)):
            m = ((score + g)[..., 0] - (score + g)[..., 1]).numpy()
            for i, path in enumerate(b.paths):
                margin[path, key] = m[i, : int(out.frame_lengths[i])]
    err, n_mask, flips, smallest = 0.0, 0, [], float("inf")
    for g, c in zip(rows["cuda"], rows["cpu"]):
        assert g.path == c.path
        err = max(err, float(np.abs(g.hidden_states - c.hidden_states).max()))
        for k in ("lm_mask", "dementia_mask"):
            m, differ = margin[c.path, k], getattr(g, k)[...] != getattr(c, k)
            assert np.array_equal(getattr(c, k), (m > 0).astype(np.float32)), (c.path, k)
            flips += list(np.abs(m[differ]))
            smallest = min(smallest, float(np.abs(m).min()))
            n_mask += m.size
        assert (g.pred_str, g.pred_AD) == (c.pred_str, c.pred_AD), g.path
    assert err <= 1e-3, err
    assert all(f < NEAR_TIE for f in flips), flips
    log(f"[extract-e2e] 4-layer fp32 extraction of 3 utterances (0.3-0.8 s, batch 2, a "
        f"padding row), same injected noise: card vs CPU hidden states max|err| {err:.2e} "
        f"(limit 1e-3); of {n_mask} mask elements {len(flips)} differ, all at Gumbel "
        f"margins |m| < {NEAR_TIE:.0e} ({[f'{f:.1e}' for f in flips]}; the smallest margin "
        f"{smallest:.1e}); pred_str and pred_AD equal")

    x_train, y_train, x_test = features
    dec, pred = {}, {}
    for dev in ("cuda", "cpu"):
        a, b = standard_scale(*(torch.from_numpy(x).to(dev, torch.float64)
                                for x in (x_train, x_test)))
        svc = RbfSVC().fit(a, torch.from_numpy(y_train).to(dev))
        dec[dev] = svc.decision_function(b).cpu().numpy()
        pred[dev] = svc.predict(b).cpu().numpy()
    gap = float(np.abs(dec["cuda"] - dec["cpu"]).max())
    scale = float(np.abs(dec["cpu"]).max())
    assert np.array_equal(pred["cuda"], pred["cpu"]) and gap <= 1e-6 * scale, (gap, scale)
    log(f"[svm-e2e] phase 10's SVM (fp64) card vs CPU: predictions equal, decision values "
        f"max|diff| {gap:.2e} of max|f| {scale:.3f} (limit 1e-6 of it)")


# ---------------------------------------------------------------------------
# 12. the native loaders on the card's host
# ---------------------------------------------------------------------------

def native_loaders(root: Path) -> dict:
    """``native/libdacsaudio.so`` and ``native/libdacsbeam.so`` built with
    ``make`` (where the checkout lacks them) and loaded through the port's
    ctypes shims, with no fallback; the corpus of phase 8 loaded natively
    (threaded) against the scipy loader, the same samples, both timed."""
    from privacy_preserve_federated_asr_tpu_torch.data import native_audio
    from privacy_preserve_federated_asr_tpu_torch.data.audio import load_audio
    from privacy_preserve_federated_asr_tpu_torch.ops import beam
    from privacy_preserve_federated_asr_tpu_torch.utils.native import NATIVE_DIR

    libs = ("libdacsaudio.so", "libdacsbeam.so")
    had = {so: (NATIVE_DIR / so).exists() for so in libs}
    t0 = time.perf_counter()
    ok = native_audio.available(), beam.native_available()
    build_s = time.perf_counter() - t0
    if not all(ok):
        raise RuntimeError(f"native libraries did not build or load: {dict(zip(libs, ok))}")
    paths = sorted(str(p) for p in (root / "data/clips").iterdir())
    times = {"native": [], "python": []}
    for _ in range(3):
        t0 = time.perf_counter()
        nat = native_audio.load_many_native(paths)
        times["native"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = [load_audio(p) for p in paths]
        times["python"].append(time.perf_counter() - t0)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(nat, ref))
    assert all(a is not None and a.shape == b.shape for a, b in zip(nat, ref)), paths
    assert diff <= 2e-6, diff
    ms = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    seconds = sum(len(a) for a in ref) / 16000
    state = ", ".join(f"{so} ({'present' if had[so] else 'built by make'})" for so in libs)
    log(f"[native] {state} loaded in {build_s:.2f} s; corpus of {len(paths)} WAVs "
        f"({seconds:.0f} s of audio): native threaded {ms['native']:.1f} ms, scipy per file {ms['python']:.1f} ms (median of "
        f"3; {ms['python'] / ms['native']:.1f}x), max|diff| {diff:.1e}  [{card_line()}]")
    return {"native_ms": ms["native"], "python_ms": ms["python"]}


# ---------------------------------------------------------------------------
# 13. cli transcribe greedy and with beam search; cli serve on the same files
# ---------------------------------------------------------------------------

FINAL = "out/fl_final_global/final"
MODEL_ARGS = ["--model_type", "data2vec", "--eval_batch_size", str(FL_BATCH),
              "--device", "cuda"]


def _transcribe(root: Path, model_in: str, *extra: str,
                phase: str = "cli transcribe") -> tuple[list, float, int]:
    """``cli transcribe`` of the test WAVs; (rows, host s, B1 launches)."""
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import flash_attention_fwd

    reset_counts()
    rows, _, wall = _run_cli(root, ["transcribe", *MODEL_ARGS, "-model_in", model_in,
                                    "--audio", "test_wavs", *extra])
    tally(phase)
    return rows, wall, flash_attention_fwd.launches


def _serve_transcripts(root: Path, paths: list[str], stage: str) -> tuple[list, int]:
    """``cli serve`` (``cli.main`` in a thread) of phase 8's final model; each
    file's samples (as ``transcribe`` loads them) posted alone, so each is
    row 0 of its own batch. Returns the transcripts and B1 launches."""
    import socket

    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.data.audio import load_audio
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import flash_attention_fwd
    from privacy_preserve_federated_asr_tpu_torch.serving import server

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    made, make = [], server.make_server
    server.make_server = lambda *a, **kw: made.append(make(*a, **kw)) or made[-1]
    reset_counts()
    th = threading.Thread(target=lambda: cli.main(
        ["serve", *MODEL_ARGS, "-st", stage, "-model_in", str(root / FINAL),
         "--port", str(port), "--no_warmup"]), daemon=True)
    th.start()
    try:
        deadline = time.time() + 300
        while not made and th.is_alive() and time.time() < deadline:
            time.sleep(0.1)
        assert made, "cli serve did not start"
        url = f"http://127.0.0.1:{port}/asr"
        out = [_post(url, load_audio(p), "f32")[0]["transcript"] for p in paths]
    finally:
        server.make_server = make
        if made:
            made[0].shutdown()
        th.join(timeout=60)
    assert not th.is_alive(), "cli serve did not stop"
    tally("cli serve")
    return out, flash_attention_fwd.launches


def transcribe_phase(root: Path) -> dict:
    """``cli transcribe`` of phase 8's final model over the test WAVs: greedy,
    then ``--beam_size 8`` with a bigram LM fitted on the train CSV (the
    beam's ids against the port's Python decoder on the same
    log-posteriors, its host time per batch); ``cli serve`` of the same
    weights gives the greedy transcripts of the same files (at stage 1,
    whose streams carry no Gumbel noise, so a file's row in its batch
    cannot matter)."""
    import shutil

    from privacy_preserve_federated_asr_tpu_torch.ops import beam
    from privacy_preserve_federated_asr_tpu_torch.serving import engine as engine_mod

    wavs = root / "test_wavs"
    wavs.mkdir()
    names = [line.split(",")[0] for line in (root / "data/test.csv").read_text().splitlines()[1:]]
    for n in names:
        shutil.copy(root / "data/clips" / n, wavs / n)
    n_batches = -(-len(names) // FL_BATCH)
    launches = {}
    greedy, wall, launches["greedy"] = _transcribe(root, FINAL, "-st", "2")
    assert launches["greedy"] == LAYERS * n_batches, launches
    assert [Path(r["path"]).name for r in greedy] == sorted(names)
    assert all(r["ad_pred"] in (0, 1) and 0.0 <= r["ad_prob"] <= 1.0 for r in greedy)
    log(f"[transcribe] cli transcribe -st 2 (greedy, data2vec-audio-large DACS bf16, phase 8's "
        f"final model, batch {FL_BATCH}) of {len(names)} test WAVs: {wall:.2f} s of host time "
        f"(model load included), {len(names) / wall:.1f} utt/s; B1 {launches['greedy']} "
        f"launches = {LAYERS} x {n_batches} batch forwards  [{card_line()}]")

    calls, search = [], engine_mod.beam_search_batch

    def timed(lp, flen, **kw):
        t0 = time.perf_counter()
        out = search(lp, flen, **kw)
        calls.append((time.perf_counter() - t0, lp.copy(), np.array(flen), kw, out))
        return out

    engine_mod.beam_search_batch = timed
    try:
        beamed, bwall, launches["beam"] = _transcribe(
            root, FINAL, "-st", "2", "--beam_size", "8", "--lm_train_csv", "data/train.csv")
    finally:
        engine_mod.beam_search_batch = search
    assert launches["beam"] == LAYERS * n_batches and len(calls) == n_batches, launches
    # the engine's decode is the native one (a CharBigramLM, the library
    # loaded): the same ids as a direct call of the native decoder on the
    # captured log-posteriors. The Python decoder is the same search in
    # fp64, where the native one runs in fp32: at a near-tie on the beam's
    # edge the two keep different prefixes, so their results are read side
    # by side, not held equal (the JAX package's pair behaves the same).
    same, gaps = 0, []
    for _, lp, flen, kw, out in calls:
        assert isinstance(kw["lm_fn"], beam.CharBigramLM) and beam.native_available()
        for b, hyps in enumerate(out):
            args = dict(beam_size=8, lm_alpha=kw["lm_alpha"], lm_beta=kw["lm_beta"])
            x = lp[b, : int(flen[b])]
            nat = beam.ctc_prefix_beam_search_native(x, lm=kw["lm_fn"], **args)
            assert (hyps[0].ids, hyps[0].score) == (nat.ids, nat.score), b
            py = beam.ctc_prefix_beam_search(x, lm_fn=kw["lm_fn"], **args)[0]
            same += py.ids == nat.ids
            if py.ids != nat.ids:
                gaps.append(f"row {b}: native {nat.score:.3f}, Python {py.score:.3f}")
    host_ms = [c[0] * 1e3 for c in calls]
    changed = sum(a["transcript"] != b["transcript"] for a, b in zip(greedy, beamed))
    log(f"[transcribe] --beam_size 8 with a bigram LM fitted on the train CSV: {bwall:.2f} s "
        f"of host time, {len(names) / bwall:.1f} utt/s; B1 {launches['beam']} launches; the "
        f"engine's ids equal the native decoder's on the captured log-posteriors; the Python "
        f"decoder gives the same ids on {same} of {len(names)} (best fused scores where not: "
        f"{gaps}); host beam decode {', '.join(f'{m:.1f}' for m in host_ms)} ms per batch of "
        f"{FL_BATCH}; {changed} of {len(names)} transcripts differ from greedy  "
        f"[{card_line()}]")

    st1, _, launches["st1"] = _transcribe(root, FINAL, "-st", "1")
    served, launches["serve"] = _serve_transcripts(root, [str(root / r["path"]) for r in st1],
                                                   "1")
    assert served == [r["transcript"] for r in st1], (served, st1)
    assert launches["serve"] == LAYERS * len(names), launches
    log(f"[transcribe] -st 1: cli transcribe's greedy transcripts equal cli serve's for the "
        f"same {len(names)} files and weights (each request alone in its batch; serve B1 "
        f"{launches['serve']} launches = {LAYERS} x {len(names)} requests)")
    return {"greedy": greedy, "launches": launches, "utt_s": len(names) / wall,
            "beam_utt_s": len(names) / bwall, "beam_host_ms": host_ms}


# ---------------------------------------------------------------------------
# 14. cli export-hf, then transcribe from the export (.bin and .safetensors)
# ---------------------------------------------------------------------------

def _write_safetensors(path: Path, sd: dict) -> None:
    """F32 tensors in the safetensors layout: an 8-byte little-endian header
    length, the JSON header (padded with spaces to 8 bytes), the bytes."""
    header, offset, blobs = {}, 0, []
    for k, v in sd.items():
        b = v.detach().to("cpu", torch.float32).contiguous().numpy().tobytes()
        header[k] = {"dtype": "F32", "shape": list(v.shape),
                     "data_offsets": [offset, offset + len(b)]}
        offset += len(b)
        blobs.append(b)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h)
        for b in blobs:
            f.write(b)


def export_phase(root: Path, greedy: list) -> dict:
    """``cli export-hf`` of phase 8's final model; ``cli transcribe`` from the
    exported ``pytorch_model.bin`` and from a directory holding only
    ``model.safetensors`` of it gives the final model's transcripts."""
    t0 = time.perf_counter()
    out = _last_json(_run_cli(root, ["export-hf", *MODEL_ARGS, "-st", "2", "-model_in", FINAL,
                                     "--out", "export/pytorch_model.bin"])[1])
    export_s = time.perf_counter() - t0
    sd = torch.load(root / "export/pytorch_model.bin", map_location="cpu", weights_only=True)
    assert out["keys"] == len(sd) and all(k.startswith(("data2vec_audio.", "lm_head.",
                                                        "dementia_head.", "arbitrator.",
                                                        "criterion_similar.")) for k in sd)
    (root / "export_st").mkdir()
    _write_safetensors(root / "export_st/model.safetensors", sd)
    launches = {}
    want = [r["transcript"] for r in greedy]
    for name, model_in in (("bin", "export/pytorch_model.bin"), ("safetensors", "export_st")):
        rows, _, launches[name] = _transcribe(root, model_in, "-st", "2",
                                              phase="cli export-hf reloads")
        assert [r["transcript"] for r in rows] == want, name
        assert [r["ad_pred"] for r in rows] == [r["ad_pred"] for r in greedy], name
    log(f"[export] cli export-hf of phase 8's final model: {len(sd)} ForCTC keys in "
        f"{export_s:.1f} s; cli transcribe -model_in the exported pytorch_model.bin and -model_in "
        f"a directory holding only model.safetensors of it: transcripts and AD votes equal the "
        f"final model's  [{card_line()}]")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# 15. cli sweep svm on phase 10's pickles; 16. cli sweep asr at stage 0
# ---------------------------------------------------------------------------

def sweep_svm_phase(root: Path, svm: dict) -> None:
    res = root / "res_float32"
    rows = _run_cli(root, ["sweep", "svm", "--train_pkl", str(res / "extract_train.pkl"),
                           "--test_pkl", str(res / "extract.pkl"), "--spk2label",
                           "data/spk2label.npy", "--preset", "dementia-svm", "--results_csv",
                           str(res / "sweep_svm.csv"), "--device", "cuda"])[0]
    assert [r["pooling"] for r in rows] == ["min", "max", "mean", "median"], rows
    mean = next(r for r in rows if r["pooling"] == "mean")
    assert {k: mean[k] for k in svm} == svm, (mean, svm)
    assert len((res / "sweep_svm.csv").read_text().splitlines()) == 5
    accs = ", ".join(f"{r['pooling']} ACC {r['ACC']:.3f}" for r in rows)
    log(f"[sweep-svm] cli sweep svm --preset dementia-svm on phase 10's pickles: 4 rows "
        f"({accs}); the mean row equals phase 10's svm -sq mean  [{card_line()}]")


def _train_args(args: list[str]) -> list[str]:
    """``args`` without the flags that only ``cli federated`` takes."""
    fl_only = {"--num_users", "--local_ep", "--global_ep"}
    pairs = list(zip(args[::2], args[1::2]))
    return [x for flag, value in pairs if flag not in fl_only for x in (flag, value)]


def sweep_asr_phase(root: Path) -> dict:
    """``cli sweep asr -st 0 --grid learning_rate=1e-5,1e-4`` at full width,
    one epoch of the smoke corpus per combo: two rows, each combo from
    bit-equal initial params, the exact B1/B2 launch counts."""
    import csv

    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)
    from privacy_preserve_federated_asr_tpu_torch.train.trainer import Trainer

    inits, trainers, real_init = [], [], Trainer.__init__

    def init(self, cfg, state_dict, *a, **kw):
        inits.append({k: v.clone() for k, v in state_dict.items()})
        trainers.append(self)
        real_init(self, cfg, state_dict, *a, **kw)

    Trainer.__init__ = init
    reset_counts()
    try:
        rows, _, wall = _run_cli(root, [
            "sweep", "asr", *_train_args(FL_ARGS), "-st", "0", "--epochs", "1",
            "--grid", "learning_rate=1e-5,1e-4", "--results_csv", "sweep/asr.csv"])
    finally:
        Trainer.__init__ = real_init
    b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
    tally("cli sweep asr")
    assert [r["learning_rate"] for r in rows] == [1e-5, 1e-4], rows
    assert all(np.isfinite(r["eval_loss"]) for r in rows), rows
    assert len(inits) == 2 and all(torch.equal(v, inits[1][k]) for k, v in inits[0].items())
    steps = sum(len(t.train_batcher) for t in trainers)
    evals = sum(len(t.eval_batcher) for t in trainers)
    assert (b1, b2) == (LAYERS * (steps + evals), LAYERS * steps), (b1, b2, steps, evals)
    with open(root / "sweep/asr.csv", newline="") as f:
        assert [float(r["learning_rate"]) for r in csv.DictReader(f)] == [1e-5, 1e-4]
    shown = ", ".join(f"lr {r['learning_rate']:g}: eval_loss {r['eval_loss']:.3f}, eval_wer "
                      f"{r['eval_wer']:.3f}" for r in rows)
    log(f"[sweep-asr] cli sweep asr -st 0 --grid learning_rate=1e-5,1e-4 (data2vec-audio-large "
        f"DACS bf16, batch {FL_BATCH}, 1 epoch of {FL_TRAIN} train WAVs, eval on {FL_TEST}): 2 "
        f"rows ({shown}) in {wall:.1f} s ({wall / 2:.1f} s per combo, model init and caches "
        f"included); both combos from bit-equal params; B1 {b1} = {LAYERS} x ({steps} steps + {evals} eval "
        f"batches), B2 {b2} = {LAYERS} x {steps}  [{card_line()}]")
    return {"b1": b1, "b2": b2, "combo_s": wall / 2}


# ---------------------------------------------------------------------------
# 17. training at full width with grad_accum, remat and prefetch
# ---------------------------------------------------------------------------

ACCUM_BATCH, ACCUM_K, ACCUM_MICRO = 8, 2, 8


def _step_memory(tr, fn_args_list, remat: bool) -> float:
    """Peak device memory (GiB) one micro-step adds over what is allocated
    before it, with the encoder's remat switched as asked."""
    enc = tr.state.model.backbone.encoder
    was, enc.remat = enc.remat, remat
    try:
        fn, args = fn_args_list
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(tr.state, *args)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    finally:
        enc.remat = was


def train_accum_remat_full_width(root: Path, phase6: dict) -> dict:
    """``cli train -st 0 --grad_accum 2 --remat`` (prefetch 2, the
    default) at full width, bf16, batch 8: 8 micro-steps = 4 optimizer
    updates, then one evaluation. Exact launches (B1 twice per layer per
    micro-step: the forward and remat's recompute), frozen params
    bit-unchanged, all finite; micro-step ms and utt/s beside phase 6's; the
    peak memory of one micro-step with and without remat at the same
    batch."""
    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)

    b = ACCUM_BATCH
    data = root / "accum"
    _write_corpus(data / "data", b * ACCUM_MICRO // 2, b)
    args = ["train", "--model_type", "data2vec", "-st", "0", "--compute_dtype", "bfloat16",
            "--train_batch_size", str(b), "--eval_batch_size", str(b), "--epochs", "2",
            "--seed", "0", "--grad_accum", str(ACCUM_K), "--remat", "-lr", "1e-5",
            "--audio_dir", "data/clips", "--train_csv", "data/train.csv",
            "--test_csv", "data/test.csv", "--spk2label", "data/spk2label.npy",
            "--dataset_cache", "cache", "-model_out", "out", "--device", "cuda"]
    reset_counts()
    tr, out, wall = _run_cli(data, args)
    b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
    tally("cli train --grad_accum --remat")
    micro, n_eval, tx = tr.state.step, len(tr.eval_batcher), tr.state.tx
    ev = _last_json(out)
    # a constant lr of 1e-5: every trainable tensor moves in 4 updates (the
    # default warmup would start them at 0 and 1e-8)
    assert tr.tcfg.prefetch == 2 and tr.state.model.backbone.encoder.remat
    assert micro == ACCUM_MICRO, micro
    assert tx.schedule.last_epoch == ACCUM_MICRO // ACCUM_K and tx.mini_step == 0, (
        tx.schedule.last_epoch, tx.mini_step)
    assert b1 == LAYERS * (2 * micro + n_eval) and b2 == LAYERS * micro, (b1, b2, micro)
    assert all(np.isfinite(v) for v in ev.values()), ev
    init = cli.load_weights(tr.cfg, None, 0, "cuda")
    final = tr.state.model.state_dict()
    for k, v in final.items():
        assert torch.equal(v, init[k]) == k.startswith(FROZEN_AT_STAGE0), k
        assert torch.isfinite(v).all(), k
    log(f"[accum] cli train -st 0 --grad_accum {ACCUM_K} --remat (prefetch 2, data2vec-"
        f"audio-large DACS bf16, batch {b}): {micro} micro-steps, "
        f"{tx.schedule.last_epoch} optimizer updates, + evaluate() in {wall:.1f} s; eval "
        f"{ev}; launches B1 {b1} = {LAYERS} x (2 x {micro} micro-steps: forward and "
        f"remat's recompute + {n_eval} eval forward), B2 {b2} = {LAYERS} x {micro}; frozen "
        f"params bit-unchanged, every trainable one moved, all finite  [{card_line()}]")

    times = []
    batches = (x for epoch in range(5, 9) for x in tr.train_batches(epoch))
    for _ in range(8):
        n_real, (fn, fn_args) = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(tr.state, *fn_args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = float(np.mean(times[2:]))
    nxt = next(batches)[1]
    mem = {remat: _step_memory(tr, nxt, remat) for remat in (False, True)}
    log(f"[accum] micro-step (B={b} x 5 s, T=249, bf16, remat, accumulate / update in turn): "
        f"{step_s * 1e3:.1f} ms mean over {len(times) - 2} (min {min(times[2:]) * 1e3:.1f}, "
        f"max {max(times[2:]) * 1e3:.1f}), {b / step_s:.1f} utt/s; phase 6's step (B=16, no "
        f"remat, no accumulation) {phase6['step_s'] * 1e3:.1f} ms, "
        f"{BWD_SHAPES[0][0] / phase6['step_s']:.1f} utt/s; peak memory one micro-step adds: "
        f"{mem[False]:.2f} GiB without remat, {mem[True]:.2f} GiB with  [{card_line()}]")
    del tr, init, final
    torch.cuda.empty_cache()
    return {"b1": b1, "b2": b2, "step_s": step_s, "mem": mem}


# ---------------------------------------------------------------------------
# 18. grad_accum and remat, card against CPU
# ---------------------------------------------------------------------------

def _close_params(a: dict, c: dict, lr: float) -> tuple[float, float]:
    """Phase 7's rule: all finite, at most 0.5% of the elements further apart
    than 1e-2 lr; returns (max |diff|, share beyond)."""
    worst, off = 0.0, 0
    for k, v in c.items():
        assert torch.isfinite(a[k]).all(), k
        diff = (a[k] - v).abs()
        worst = max(worst, diff.max().item())
        off += int((diff > 1e-2 * lr).sum())
    frac = off / sum(v.numel() for v in c.values())
    assert frac <= 5e-3, frac
    return worst, frac


def accum_remat_vs_cpu() -> None:
    """The 4-layer fp32 model of phase 7 on cached frontend features: one
    update from grad_accum 2 x B=2 on the card equals it on the CPU; at
    attention dropout 0 it equals one update of B=4 with grad_accum 1; a
    remat step equals a plain step on the card (bit-equality reported)."""
    from privacy_preserve_federated_asr_tpu_torch.data.audio import normalize_input_values
    from privacy_preserve_federated_asr_tpu_torch.data.tokenizer import CTCCharTokenizer
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, DACSModel, init_dacs_state_dict)
    from privacy_preserve_federated_asr_tpu_torch.train import (
        FeatureBatch, create_train_state, frontend_forward_fn, make_feature_train_step,
        make_optimizer)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = 1e-4
    tok = CTCCharTokenizer()

    def cfg_at(rate):
        return DACSConfig(backbone=BackboneConfig.data2vec_audio_large().replace(
            num_hidden_layers=4, hidden_dropout=0.0, activation_dropout=0.0,
            feat_proj_dropout=0.0, attention_dropout=rate), stage=0)

    cfg = cfg_at(TRAIN_RATE)
    sd = init_dacs_state_dict(cfg, torch.Generator("cpu").manual_seed(6))
    x = np.zeros((4, 80000), np.float32)
    lengths = [80000, 67200, 72000, 80000]
    for i, n in enumerate(lengths):
        x[i, :n] = normalize_input_values(_utterance(n / 16000, 60 + i))
    ids = [tok.encode(s) for s in SENTENCES[:4]]
    labels = np.full((4, 32), -100, np.int64)
    for i, s in enumerate(ids):
        labels[i, : len(s)] = s
    host = dict(labels=labels, label_lengths=np.array([len(s) for s in ids]),
                dementia_labels=np.array([1, 0, 1, 0]), sample_mask=np.ones(4, np.float32))
    with torch.device("meta"):
        fe = DACSModel(cfg, torch.float32)
    fe = fe.to_empty(device="cpu")
    fe.load_state_dict(sd)
    feats, fl = frontend_forward_fn(fe)(torch.from_numpy(x), torch.from_numpy(
        np.asarray(lengths, np.int32)))

    def batch(rows, dev):
        return FeatureBatch(feats[rows].to(dev), fl[rows].to(dev),
                            **{k: torch.from_numpy(v[rows]).to(dev) for k, v in host.items()})

    def run(dev, c, k, remat=False, parts=((0, 2), (2, 4))):
        with torch.device("meta"):
            model = DACSModel(c, torch.float32, remat=remat)
        model = model.to_empty(device=dev)
        model.load_state_dict(sd)
        state = create_train_state(model, make_optimizer(model, 0, learning_rate=lr,
                                                         grad_accum=k), 3)
        step = make_feature_train_step(c)
        metrics = [{n: float(v) for n, v in step(state, batch(slice(*p), dev)).items()}
                   for p in parts]
        assert state.tx.schedule.last_epoch == len(parts) // k
        return metrics, {n: v.cpu() for n, v in model.state_dict().items()}

    reset_counts()  # the CPU runs the plain versions: only the card's launches count
    m_gpu, p_gpu = run("cuda", cfg, ACCUM_K)
    m_cpu, p_cpu = run("cpu", cfg, ACCUM_K)
    for a, c in zip(m_gpu, m_cpu):
        for n, rtol in (("loss", 1e-4), ("grad_norm", 1e-3)):
            assert abs(a[n] - c[n]) <= rtol * abs(c[n]), (n, a[n], c[n])
    worst, frac = _close_params(p_gpu, p_cpu, lr)
    log(f"[accum-e2e] 4-layer fp32 stage 0, attention dropout {TRAIN_RATE}, grad_accum "
        f"{ACCUM_K} x B=2 = 1 update at lr {lr}: micro-step (loss, grad norm) card "
        f"{[(m['loss'], m['grad_norm']) for m in m_gpu]}, CPU "
        f"{[(m['loss'], m['grad_norm']) for m in m_cpu]} (rtol 1e-4, 1e-3); params max|diff| "
        f"{worst:.2e}, {frac:.2e} of elements beyond 1e-2 lr (limit 5e-3)")
    cfg0 = cfg_at(0.0)
    _, p_acc = run("cuda", cfg0, ACCUM_K)
    _, p_big = run("cuda", cfg0, 1, parts=((0, 4),))
    worst, frac = _close_params(p_acc, p_big, lr)
    log(f"[accum-e2e] on the card, attention dropout 0: grad_accum {ACCUM_K} x B=2 against "
        f"one update of B=4: params max|diff| {worst:.2e}, {frac:.2e} of elements beyond "
        f"1e-2 lr (limit 5e-3)")
    m_plain, p_plain = run("cuda", cfg, 1, parts=((0, 2),))
    m_remat, p_remat = run("cuda", cfg, 1, remat=True, parts=((0, 2),))
    tally("grad_accum and remat, card vs CPU")
    bit = m_plain == m_remat and all(torch.equal(p_remat[k], v) for k, v in p_plain.items())
    worst, frac = _close_params(p_remat, p_plain, lr)
    log(f"[accum-e2e] on the card, attention dropout {TRAIN_RATE}: a remat step against a "
        f"plain step: loss {m_remat[0]['loss']:.6f} / {m_plain[0]['loss']:.6f}, grad norm "
        f"{m_remat[0]['grad_norm']:.6f} / {m_plain[0]['grad_norm']:.6f}; params "
        f"{'bit-equal' if bit else 'not bit-equal'} (max|diff| {worst:.2e}, {frac:.2e} beyond "
        f"1e-2 lr, limit 5e-3)")


# ---------------------------------------------------------------------------
# 19. federated at full width with the engine's options
# ---------------------------------------------------------------------------

FL_OPTS = ["--fedprox_mu", "0.01", "--server_optimizer", "adam", "--topk_fraction", "0.25",
           "-sl", "0.5", "--num_lms", "2"]
FL_UNSUP = 8


def _options_engine(eng, params, round_save_dir=None):
    """A fresh engine with ``eng``'s config, data and tokenizer from
    ``params``."""
    from privacy_preserve_federated_asr_tpu_torch.federated import FederatedEngine

    fcfg = dataclasses.replace(eng.fcfg, round_save_dir=round_save_dir, log_file=None)
    return FederatedEngine(eng.cfg, fcfg, eng.client_examples, eng.public_examples, None,
                           eng.tokenizer, params, device="cuda",
                           client_unsup_examples=eng.client_unsup_examples)


def federated_options_full_width(root: Path) -> dict:
    """``cli federated -fl_st 0`` at full width from phase 8's final model
    with FedProx, FedAdam, top-k, a semi-supervised phase on 8 unlabeled
    WAVs and 2 N-best heads, one round per stage, round checkpoints on:
    exact B1 / B2 launches per stage (the pseudo-label passes counted), only
    the stage's network moved, the -server and -topk sidecars written; then
    stage-2 round 2 resumed from round 1's checkpoint and sidecars equals
    the run that did not stop, bit for bit."""
    from privacy_preserve_federated_asr_tpu_torch.federated.engine import FederatedEngine
    from privacy_preserve_federated_asr_tpu_torch.models.recipes import (
        stage_trainable_predicate)
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)
    from privacy_preserve_federated_asr_tpu_torch.train.optim import path_of

    from scipy.io import wavfile

    unsup = root / "data/unsup"
    unsup.mkdir()
    rows = []
    for i in range(FL_UNSUP):
        name = f"S{i // 2:03d}_PAR_u{i}_0_5000.wav"  # phase 8's speakers (spk2label)
        wavfile.write(root / "data/clips" / name, 16000, (np.clip(
            _utterance(float(4.0 + 0.1 * i), 3000 + i), -1, 1) * 32767).astype(np.int16))
        rows.append(f"{name},{SENTENCES[(i + 3) % len(SENTENCES)].lower()}")
    (root / "data/unsup.csv").write_text("path,sentence\n" + "\n".join(rows) + "\n")

    stages, originals = {}, {}

    def checked(name: str, stage: int):
        def run(eng):
            before = {k: v.clone() for k, v in eng.global_params.items()}
            b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
            n_rows = len(eng.logger.history)
            out = originals[name](eng)
            pred = stage_trainable_predicate(stage)
            moved = [k for k, v in eng.global_params.items() if not torch.equal(v, before[k])]
            assert all(pred(path_of(k)) for k in moved), (stage, moved[:5])
            assert all(torch.isfinite(v).all() for v in eng.global_params.values()), stage
            stages[stage] = {"b1": flash_attention_fwd.launches - b1,
                             "b2": flash_attention_bwd.launches - b2,
                             "rows": eng.logger.history[n_rows:], "moved": moved}
            return out
        return run

    for name, stage in (("run_stage1", 0), ("run_stage2", 1), ("run_stage3", 2)):
        originals[name] = getattr(FederatedEngine, name)
        setattr(FederatedEngine, name, checked(name, stage))
    pseudo = {}
    real_pseudo = FederatedEngine._round_pseudo_labels

    def counted_pseudo(self, cids, stage, rnd):
        b1 = flash_attention_fwd.launches
        out = real_pseudo(self, cids, stage, rnd)
        pseudo[stage] = flash_attention_fwd.launches - b1
        return out

    FederatedEngine._round_pseudo_labels = counted_pseudo
    try:
        reset_counts()
        eng, out, wall = _run_cli(root, [
            "federated", *FL_ARGS, *FL_OPTS, "--unsup_train_csv", "data/unsup.csv",
            "--epochs", "1", "-fl_st", "0", "--round_save_dir", "rounds",
            "-model_in", "out/fl_final_global/final", "-model_out", "out/opts"])
        b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
        tally("cli federated, engine options")
    finally:
        FederatedEngine._round_pseudo_labels = real_pseudo
        for name, fn in originals.items():
            setattr(FederatedEngine, name, fn)
    ev = _last_json(out)
    assert all(np.isfinite(v) for v in ev.values()), ev
    f = eng.fcfg
    n_eval = -(-FL_TEST // FL_BATCH)
    n_unsup = {c: len(v) for c, v in eng.client_unsup_examples.items()}
    want_pseudo = LAYERS * eng.cfg.num_lms * sum(-(-n // FL_BATCH) for n in n_unsup.values())
    for stage, s in stages.items():
        rows = s["rows"]
        rnd = next(r for r in rows if "phase" in r)
        mt_steps, sup_steps = (int(x) for x in rnd["phase_steps"].split("+"))
        m = len(rnd["clients"].split(",")) if isinstance(rnd["clients"], str) else 1
        assert rnd["phase"] == ("mt+res" if stage == 0 else "mt+res_h"), rnd
        ws = sum(r["warm_start_steps"] for r in rows if "warm_start_steps" in r)
        n_evals = sum("eval_loss" in r for r in rows)
        assert pseudo[stage] == want_pseudo, (stage, pseudo[stage], want_pseudo)
        if stage == 0:
            want = (LAYERS * (ws + m * (mt_steps + sup_steps) + n_evals * n_eval) + want_pseudo,
                    LAYERS * (ws + m * (mt_steps + sup_steps)))
        else:
            cache_fwd = sum(r["hidden_cache_forwards"] for r in rows
                            if "hidden_cache_forwards" in r)
            want = (LAYERS * (-(-FL_TRAIN // FL_BATCH) + cache_fwd + n_eval + m * mt_steps)
                    + want_pseudo, 0)
        assert (s["b1"], s["b2"]) == want, (stage, s["b1"], s["b2"], want, rows)
        head = {0: "lm_head.weight", 1: "dementia_head.weight", 2: "arbitrator.weight"}
        assert head[stage] in s["moved"], (stage, len(s["moved"]))
        log(f"[federated-opts] stage {stage}: B1 {s['b1']} (pseudo-label passes {pseudo[stage]}"
            f" = {LAYERS} x {eng.cfg.num_lms} passes x batches), B2 {s['b2']} launches (as "
            f"expected); round {rnd['round_s']:.2f} s ({rnd['phase']}: {rnd['phase_steps']} "
            f"steps per client, {m} clients); {len(s['moved'])} tensors moved, all of the "
            f"stage's network, all finite  [{card_line()}]")
    names = sorted(p.name for p in (root / "rounds").iterdir())
    assert names == [f"stage{s}-round-1{x}" for s in range(3)
                     for x in ("", "-server", "-topk")], names
    log(f"[federated-opts] cli federated {' '.join(FL_OPTS)} --unsup_train_csv ({FL_UNSUP} "
        f"WAVs) -fl_st 0 --round_save_dir: {wall:.1f} s of host time; round checkpoints "
        f"{names}; final eval {ev}  [{card_line()}]")

    # resume: stage-2 round 2 from round 1's checkpoint and sidecars against
    # the run that did not stop, both from the same params
    params = {k: v.clone() for k, v in eng.global_params.items()}
    eng._topk_residuals.clear()
    eng._server_opts.clear()
    with _cwd(root), contextlib.redirect_stdout(io.StringIO()):
        first = _options_engine(eng, params, "resume")
        first.run_rounds(stage=2, num_rounds=1)
        del first
        straight = _options_engine(eng, params)
        want = straight.run_rounds(stage=2, num_rounds=2)
        want = {k: v.clone() for k, v in want.items()}
        del straight
        resumed = _options_engine(eng, params, "resume")
        got = resumed.run_rounds(stage=2, num_rounds=2)
        assert [r["fl_round"] for r in resumed.logger.history if "phase" in r] == [2]
    diff = [k for k, v in want.items() if not torch.equal(got[k], v)]
    log(f"[federated-opts] stage-2 round 2 resumed from round 1's checkpoint with its "
        f"-server and -topk sidecars against the run that did not stop: "
        f"{'bit-equal' if not diff else f'{len(diff)} tensors differ: {diff[:3]}'}")
    assert not diff, diff
    del resumed, eng
    torch.cuda.empty_cache()
    return {"b1": b1, "b2": b2}


# ---------------------------------------------------------------------------
# 20. compressed, secure and top-k rounds, card against CPU
# ---------------------------------------------------------------------------

AGG_MODES = (("compress_bits 8, nearest", dict(compress_bits=8,
                                               compress_stochastic_rounding=False)),
             ("secagg_clip_norm 1.0", dict(secagg_clip_norm=1.0)),
             ("topk_fraction 0.25", dict(topk_fraction=0.25)))


def federated_aggregators_vs_cpu() -> None:
    """Phase 9's stage-1 round of the 4-layer fp32 model on the card and on
    the CPU once per aggregator (compressed with nearest rounding, secure,
    top-k), held to phase 9's rule: client losses rtol 1e-4, at most 0.5% of
    the elements further apart than 1e-2 lr, only dementia_head moved."""
    from privacy_preserve_federated_asr_tpu_torch.data import (
        AsrExample, CTCCharTokenizer, prepare_examples)
    from privacy_preserve_federated_asr_tpu_torch.federated import (
        FederatedConfig, FederatedEngine)
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, init_dacs_state_dict)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    lr = 1e-4
    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large().replace(
        num_hidden_layers=4, hidden_dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0, final_dropout=0.0), stage=1)
    sd = init_dacs_state_dict(cfg, torch.Generator("cpu").manual_seed(4))
    tok = CTCCharTokenizer()

    def client(n, base):
        return prepare_examples([AsrExample(
            path=f"C{base}_{i}.wav", array=_utterance(1.5 + 0.4 * i, base + i),
            text=SENTENCES[(base + i) % len(SENTENCES)], dementia_label=(base + i) % 2)
            for i in range(n)], tok)

    clients = {0: client(3, 40), 1: client(2, 50)}
    base = FederatedConfig(num_rounds=1, local_ep=1, batch_size=2, eval_batch_size=2,
                           learning_rate=lr, log_dir=".")
    out = {}
    reset_counts()  # the CPU runs the plain versions: only the card's launches count
    for dev in ("cuda", "cpu"):
        # one engine per device: its encoder cache serves the three rounds
        eng = FederatedEngine(cfg, base, clients, [], None, tok, sd, device=dev)
        for name, mode in AGG_MODES:
            eng.fcfg = dataclasses.replace(base, **mode)
            eng.global_params = {k: v.to(eng.device, torch.float32) for k, v in sd.items()}
            n_rows = len(eng.logger.history)
            params = eng.run_rounds(stage=1, num_rounds=1)
            row = [r for r in eng.logger.history[n_rows:] if "local_steps" in r][0]
            assert row["phase"] == "res_h", row
            out[dev, name] = (row, {k: v.cpu() for k, v in params.items()})
        del eng
    tally("aggregators, card vs CPU")
    for name, _ in AGG_MODES:
        (rg, pg), (rc, pc) = out["cuda", name], out["cpu", name]
        losses = [(rg[f"client{c}_loss"], rc[f"client{c}_loss"]) for c in (0, 1)]
        for g, c in losses:
            assert abs(g - c) <= 1e-4 * abs(c), (name, losses)
        for k, c in pc.items():
            assert k.startswith("dementia_head.") or torch.equal(pg[k], c), (name, k)
        assert not torch.equal(pc["dementia_head.weight"], sd["dementia_head.weight"]), name
        worst, frac = _close_params(pg, pc, lr)
        log(f"[aggregators-e2e] one stage-1 round, 4-layer fp32, {name}: client losses card / "
            f"CPU {losses} (rtol 1e-4); params max|diff| {worst:.2e}, {frac:.2e} of elements "
            f"beyond 1e-2 lr (limit 5e-3); only dementia_head moved")


# ---------------------------------------------------------------------------
# 21. int8 (W8A8) at full width: extract, transcribe, the batch forward and
#     cli train --int8
# ---------------------------------------------------------------------------

INT8_STEPS = 3
INT_MM_SHAPES = ((B * 1499, 1024, 4096), (B * 1499, 4096, 1024), (B * 249, 1024, 1024))


def int_mm_layouts() -> dict:
    """``torch._int_mm`` at the full-width projection shapes [M, K] x [K, N]
    with the second operand column-major (the forward's transposed weight
    is so) and row-major: the first 64 rows held equal to an exact int32
    product on the CPU, each layout timed beside the bf16 product of the
    same shape (CUDA events). A layout cuBLAS refuses is reported."""
    g = torch.Generator("cuda").manual_seed(9)
    out = {}
    for m, k, n in INT_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda").to(torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device="cuda").to(torch.int8)
        want = a[:64].cpu().int() @ w.cpu().int().t()
        row = {}
        for layout, b in (("col", w.t()), ("row", w.t().contiguous())):
            try:
                got = torch._int_mm(a, b)
                assert torch.equal(got[:64].cpu(), want), layout
                row[layout] = cuda_ms(lambda: torch._int_mm(a, b), 20)
            except RuntimeError as e:
                row[layout] = f"refused: {str(e).splitlines()[0][:80]}"
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        row["bf16"] = cuda_ms(lambda: ab @ wb.t(), 20)
        out[(m, k, n)] = row
        log(f"[int8] _int_mm [{m}, {k}] x [{k}, {n}]: column-major B {row['col']} ms, "
            f"row-major B {row['row']} ms; bf16 product {row['bf16']:.4f} ms  [{card_line()}]")
    return out


def int8_forward_times() -> dict:
    """The engine's batch forward (``infer_batch``, host clock, 3 runs after
    one) of data2vec-audio-large DACS stage 2 at 8 x 5 s and 8 x 30 s,
    ``compute_dtype="int8"`` beside bf16 on the same seeded weights; 24 B1
    launches per int8 forward; one int8 forward of each bucket under
    torch.profiler."""
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, init_dacs_state_dict)
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import flash_attention_fwd
    from privacy_preserve_federated_asr_tpu_torch.serving import InferenceEngine, ServingConfig

    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large(), stage=2)
    sd = init_dacs_state_dict(cfg, torch.Generator("cuda").manual_seed(0))
    engines = {dt: InferenceEngine(cfg, sd, scfg=ServingConfig(batch_size=B, compute_dtype=dt))
               for dt in ("bfloat16", "int8")}
    del sd
    times, b1 = {}, 0
    for secs in (5, 30):
        batch = [_utterance(secs, 200 + i) for i in range(B)]
        for eng in engines.values():
            eng.infer_batch(batch)
        runs = {dt: [] for dt in engines}
        for dt in ("bfloat16", "int8", "int8", "bfloat16", "bfloat16", "int8"):
            reset_counts()
            t0 = time.perf_counter()
            engines[dt].infer_batch(batch)
            runs[dt].append(time.perf_counter() - t0)
            if dt == "int8":
                assert flash_attention_fwd.launches == LAYERS, flash_attention_fwd.launches
                b1 += flash_attention_fwd.launches
                tally("int8 serving")
        times[secs] = {dt: float(np.mean(v)) * 1e3 for dt, v in runs.items()}
        prof = profile_forward(engines["int8"], batch)
        busy = ("not measured" if prof is None else
                f"device busy {prof['device_ms']:.2f} of {prof['wall_ms']:.2f} ms wall (idle "
                f"{1 - prof['device_ms'] / prof['wall_ms']:.1%}), B1 "
                f"{prof['b1_ms'] / prof['device_ms']:.1%} of device time")
        log(f"[int8] infer_batch of {B} x {secs} s: int8 {times[secs]['int8']:.1f} ms, bf16 "
            f"{times[secs]['bfloat16']:.1f} ms (mean of 3 each, interleaved); one int8 forward "
            f"under torch.profiler: {busy}; {LAYERS} B1 launches per int8 forward  "
            f"[{card_line()}]")
    del engines
    torch.cuda.empty_cache()
    return {"times": times, "b1": b1}


def int8_full_width(root: Path, phase6: dict, greedy: list) -> dict:
    """``cli extract -st 2 --compute_dtype int8`` of phase 8's final model
    against phase 10's bf16 rows (the JAX rule: hidden-state cosine > 0.99
    per row; AD votes reported), ``cli transcribe --compute_dtype int8``
    beside phase 13's bf16 transcripts, the batch forward times and ``cli
    train -st 0 --int8`` at B=16 for a few steps: 24 B1 and 24 B2 per step,
    frozen params bit-unchanged, all finite, step ms beside phase 6's."""
    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.evaluation import read_records
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)

    layouts = int_mm_layouts()  # ops/quant.py passes the column-major one
    assert all(isinstance(row["col"], float) for row in layouts.values()), layouts
    n_batches = -(-FL_TEST // FL_BATCH) + -(-FL_TRAIN // FL_BATCH)
    reset_counts()
    _, _, wall = _run_cli(root, [*EXTRACT_ARGS, "--compute_dtype", "int8",
                                 "--csv_out_dir", "res_int8"])
    ext_b1 = flash_attention_fwd.launches
    tally("cli extract int8")
    assert ext_b1 == LAYERS * n_batches, (ext_b1, n_batches)
    rows8 = {r["path"]: r for name in ("extract.pkl", "extract_train.pkl")
             for r in read_records(str(root / "res_int8" / name))}
    rows16 = [r for name in ("extract.pkl", "extract_train.pkl")
              for r in read_records(str(root / "res_bfloat16" / name))]
    cos, votes = [], 0
    for r in rows16:
        a, b = (x["hidden_states"].astype(np.float64).ravel() for x in (rows8[r["path"]], r))
        assert np.isfinite(a).all(), r["path"]
        cos.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
        votes += rows8[r["path"]]["pred_AD"] == r["pred_AD"]
    assert min(cos) > 0.99, min(cos)
    log(f"[int8] cli extract -st 2 --compute_dtype int8 (phase 8's final model, batch "
        f"{FL_BATCH}): {len(rows16)} rows in {wall:.2f} s of host time, B1 {ext_b1} = "
        f"{LAYERS} x {n_batches} batches; hidden states against the bf16 rows: cosine min "
        f"{min(cos):.5f}, mean {np.mean(cos):.5f} (rule > 0.99); pred_AD equal on {votes} of "
        f"{len(rows16)}  [{card_line()}]")

    rows, twall, tr_b1 = _transcribe(root, FINAL, "-st", "2", "--compute_dtype", "int8",
                                     phase="cli transcribe int8")
    assert tr_b1 == LAYERS * -(-FL_TEST // FL_BATCH), tr_b1
    assert [r["path"] for r in rows] == [r["path"] for r in greedy]
    same = sum(a["transcript"] == b["transcript"] for a, b in zip(rows, greedy))
    same_ad = sum(a["ad_pred"] == b["ad_pred"] for a, b in zip(rows, greedy))
    log(f"[int8] cli transcribe -st 2 --compute_dtype int8: {len(rows)} WAVs in {twall:.2f} s "
        f"of host time, B1 {tr_b1}; against the bf16 transcripts: {same} of {len(rows)} "
        f"equal, AD votes equal on {same_ad}")

    fwd = int8_forward_times()

    b = BWD_SHAPES[0][0]
    data = root / "int8"
    _write_corpus(data / "data", b * INT8_STEPS, b)
    args = ["train", "--model_type", "data2vec", "-st", "0", "--int8",
            "--compute_dtype", "bfloat16", "--train_batch_size", str(b),
            "--eval_batch_size", str(b), "--epochs", "1", "--seed", "0", "-lr", "1e-5",
            "--audio_dir", "data/clips", "--train_csv", "data/train.csv",
            "--test_csv", "data/test.csv", "--spk2label", "data/spk2label.npy",
            "--dataset_cache", "cache", "-model_out", "out", "--device", "cuda"]
    reset_counts()
    tr, out, twall = _run_cli(data, args)
    b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
    tally("cli train --int8")
    steps, n_eval = tr.state.step, len(tr.eval_batcher)
    ev = _last_json(out)
    assert tr.cfg.backbone.dense_impl == "int8_train" and steps == INT8_STEPS, steps
    assert b1 == LAYERS * (steps + n_eval) and b2 == LAYERS * steps, (b1, b2, steps, n_eval)
    assert all(np.isfinite(v) for v in ev.values()), ev
    init = cli.load_weights(tr.cfg, None, 0, "cuda")
    final = tr.state.model.state_dict()
    for k, v in final.items():
        assert torch.equal(v, init[k]) == k.startswith(FROZEN_AT_STAGE0), k
        assert torch.isfinite(v).all(), k
    times, batches = [], (x for epoch in range(1, 4) for x in tr.train_batches(epoch))
    for _ in range(6):
        n_real, (fn, fn_args) = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = fn(tr.state, *fn_args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        assert np.isfinite(float(m["loss"])), m
    step_s = float(np.mean(times[2:]))
    log(f"[int8] cli train -st 0 --int8 (W8A8 + SwitchBack gradients, bf16, batch {b}): "
        f"{steps} steps + evaluate() in {twall:.1f} s; eval {ev}; launches B1 {b1} = {LAYERS} "
        f"x ({steps} + {n_eval} eval), B2 {b2} = {LAYERS} x {steps}; frozen params "
        f"bit-unchanged, every trainable one moved, all finite; step {step_s * 1e3:.1f} ms "
        f"mean over {len(times) - 2} (min {min(times[2:]) * 1e3:.1f}), {b / step_s:.1f} utt/s; "
        f"phase 6's bf16 step {phase6['step_s'] * 1e3:.1f} ms  [{card_line()}]")
    del tr, init, final
    torch.cuda.empty_cache()
    return {"b1": ext_b1 + tr_b1 + fwd["b1"] + b1, "b2": b2, "forward_ms": fwd["times"],
            "step_s": step_s, "layouts": layouts}


# ---------------------------------------------------------------------------
# 22. int8 card against CPU
# ---------------------------------------------------------------------------

# the int8_train step: loss and grad norm rtol, and "apart" in units of lr
INT8_TRAIN_RTOLS, INT8_TRAIN_APART = (2e-3, 5e-3), 0.5


def _capture_int8_layers(model) -> tuple[dict, dict, list]:
    """Forward hooks on ``model``: every W8A8 ``Linear``'s (input, output)
    by module name, and every ``Attention``'s key mask; returns (linears,
    masks, handles)."""
    from privacy_preserve_federated_asr_tpu_torch.models.backbone import Attention, Linear

    linears, masks, handles = {}, {}, []
    for name, m in model.named_modules():
        if isinstance(m, Linear) and m.dense_impl == "int8":
            handles.append(m.register_forward_hook(
                lambda mod, args, y, n=name: linears.__setitem__(n, (args[0], y))))
        elif isinstance(m, Attention):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args, n=name: masks.__setitem__(n, args[1])))
    return linears, masks, handles


def int8_vs_cpu() -> None:
    """One W8A8 product on the same operands, card against CPU: the
    forward and the int8 grad-input bit-equal (the codes, the int32 sums
    and the fp32 rescale are exact), the grad-weight (fp32 in another
    order) within 1e-5 of its largest value. Then phase 4's 4-layer fp32
    model with ``dense_impl="int8"``, teacher-forced: each W8A8 ``Linear``
    of the card's model (the feature projection, q/k/v/out and the FFN of
    every layer) on the input that the CPU's model gave the same module,
    bit-equal to the CPU's output; each layer's attention core (kernel B1)
    on the CPU's q, k, v within phase 1's fp32 tolerance of the CPU's
    context. End to end the two models are compared only by AD vote (equal)
    and reported: a quantized network amplifies a rounding-level difference
    (an activation on a rounding edge moves its row by one quantum, which
    flips further codes downstream) to the order of the quantization noise,
    so no limit on the output distance separates a sound card model from
    one wrong by that much; the distance of the CPU's int8 output from its
    fp32 output is printed beside it. Then one ``int8_train`` step: loss and
    grad norm within ``INT8_TRAIN_RTOLS``, at most 0.5% of the param
    elements further apart than ``INT8_TRAIN_APART`` lr (a flipped gradient
    sign moves an element up to 2 lr per Adam step)."""
    from privacy_preserve_federated_asr_tpu_torch.data.audio import normalize_input_values
    from privacy_preserve_federated_asr_tpu_torch.data.tokenizer import CTCCharTokenizer
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, DACSModel, feat_extract_output_lengths, get_recipe,
        init_dacs_state_dict)
    from privacy_preserve_federated_asr_tpu_torch.ops import quant
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        hash_stride, multihead_attention)
    from privacy_preserve_federated_asr_tpu_torch.ops.decode import ad_vote, greedy_ids

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cpu").manual_seed(4)
    xs = torch.randn((3, 499, 1024), generator=g)
    w = torch.randn((4096, 1024), generator=g) * 0.03
    got = {}
    for dev in ("cuda", "cpu"):
        a = xs.to(dev).requires_grad_()
        wd = w.to(dev).requires_grad_()
        quant.int8_train_linear(a, wd).square().sum().backward()
        got[dev] = [t.detach().cpu() for t in (quant.int8_linear(a.detach(), wd.detach()),
                                                a.grad, wd.grad)]
    (y_g, dx_g, dw_g), (y_c, dx_c, dw_c) = got["cuda"], got["cpu"]
    dw_err = ((dw_g - dw_c).abs().max() / dw_c.abs().max()).item()
    assert torch.equal(y_g, y_c) and torch.equal(dx_g, dx_c) and dw_err <= 1e-5, dw_err
    log(f"[int8-e2e] one W8A8 product [1497, 1024] x [1024, 4096], card vs CPU: forward and "
        f"int8 grad-input bit-equal, grad-weight max|err|/max|ref| {dw_err:.2e}")

    base = BackboneConfig.data2vec_audio_large().replace(num_hidden_layers=4)
    cfg = DACSConfig(backbone=base.replace(dense_impl="int8"), stage=2)
    sd = init_dacs_state_dict(cfg, torch.Generator("cpu").manual_seed(1))
    x = normalize_input_values(_utterance(5.0, 7))[None]
    lengths = np.array([x.shape[1]], np.int32)
    t = feat_extract_output_lengths(cfg.backbone, x.shape[1])
    rng = np.random.default_rng(3)
    noise = [rng.gumbel(size=(1, t, cfg.hidden_size, 2)).astype(np.float32) for _ in range(2)]
    tok = CTCCharTokenizer()
    outs, models = {}, {}
    reset_counts()  # the CPU runs the plain version: only the card's launches count
    for name, dev, c in (("cuda", "cuda", cfg), ("cpu", "cpu", cfg),
                         ("cpu fp", "cpu", cfg.replace(backbone=base))):
        with torch.device("meta"):
            model = DACSModel(c, torch.float32)
        model = model.to_empty(device=dev)
        model.load_state_dict(sd, strict=True)
        models[name] = model.eval()
        handles = []
        if name == "cpu":
            linears, masks, handles = _capture_int8_layers(model)
        with torch.inference_mode():
            out = model(torch.from_numpy(x).to(dev), torch.from_numpy(lengths).to(dev),
                        gumbel_noise=tuple(torch.from_numpy(n).to(dev) for n in noise))
            logits, dlog = get_recipe(c.method).eval_streams(out, c)  # what serving reads
            ids = greedy_ids(logits, out.frame_mask)[0].cpu()
            outs[name] = {**{k: getattr(out, k).float().cpu() for k in (
                "hidden_states", "logits_unmask")}, "ids": ids,
                "vote": int(ad_vote(dlog, out.frame_mask)[0]), "text": tok.decode(ids.numpy())}
        for hd in handles:
            hd.remove()
    # teacher-forced: the card's modules on the CPU model's own inputs
    card = dict(models["cuda"].named_modules())
    bb = cfg.backbone
    assert len(linears) == 1 + 6 * bb.num_hidden_layers and len(masks) == bb.num_hidden_layers
    attn_err = 0.0
    with torch.inference_mode():
        for n, (xin, y) in linears.items():
            yc = card[n](xin.cuda()).cpu()
            assert torch.equal(yc, y), (n, (yc - y).abs().max().item())
        for n, mask in masks.items():
            q, k, v = (linears[f"{n}.{p}_proj"][1] for p in "qkv")
            b_, t_, _ = q.shape
            heads = [z.cuda().view(b_, t_, bb.num_attention_heads, bb.head_dim)
                     for z in (q, k, v)]
            ctx = multihead_attention(*heads, None if mask is None else mask.cuda(), 0.0, 0,
                                      hash_stride(t_))
            err = (ctx.reshape(b_, t_, -1).cpu() - linears[f"{n}.out_proj"][0]).abs().max()
            attn_err = max(attn_err, err.item())
    assert attn_err <= TOL[torch.float32]["atol"], attn_err
    tally("int8, card vs CPU")
    gc, cc, fc = outs["cuda"], outs["cpu"], outs["cpu fp"]
    report = []
    for k in ("hidden_states", "logits_unmask"):
        assert gc[k].shape == cc[k].shape and bool(torch.isfinite(gc[k]).all()), k
        err = ((gc[k] - cc[k]).norm() / cc[k].norm()).item()
        q = ((cc[k] - fc[k]).norm() / fc[k].norm()).item()
        report.append(f"{k} {err:.2e} (CPU int8 against CPU fp32 {q:.2e})")
    same = (gc["ids"] == cc["ids"]).float().mean().item()
    assert gc["vote"] == cc["vote"], (gc["vote"], cc["vote"])
    log(f"[int8-e2e] 4-layer fp32 stage 2, dense_impl int8, 5 s, teacher-forced on the CPU "
        f"model's inputs: all {len(linears)} W8A8 Linears of the card bit-equal to the CPU's, "
        f"the {len(masks)} attention cores (B1) max|err| {attn_err:.2e} (limit "
        f"{TOL[torch.float32]['atol']:g}); end to end (reported, no limit): relative distance "
        f"{'; '.join(report)}; greedy ids equal on {same:.1%} of {t} frames; AD vote equal; "
        f"transcripts {'equal' if gc['text'] == cc['text'] else 'differ'}, edit distance "
        f"{_edit_distance(gc['text'], cc['text'])} of {len(cc['text'])} characters")
    del models
    train_step_vs_cpu(dense_impl="int8_train", rtols=INT8_TRAIN_RTOLS, apart=INT8_TRAIN_APART)


def _edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


# ---------------------------------------------------------------------------
# 23. streaming at full width behind the HTTP server
# ---------------------------------------------------------------------------

STREAMS, HUB_ROWS, STREAM_S, CHUNK_S = 10, B, 10.0, 0.5


def _post_json(url: str) -> dict:
    req = urllib.request.Request(url, data=b"{}", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.load(r)


def _feed_stream(url: str, sid: str, audio: np.ndarray, lat: list) -> dict:
    """Feed ``audio`` to stream ``sid`` in CHUNK_S binary chunks paced at
    real time; each feed's latency into ``lat``; returns the finish reply."""
    n = int(CHUNK_S * 16000)
    t_next = time.perf_counter()
    for i in range(0, len(audio), n):
        _, dt = _post(f"{url}/stream/{sid}", audio[i : i + n], "f32")
        lat.append(dt)
        t_next += CHUNK_S
        time.sleep(max(t_next - time.perf_counter(), 0.0))
    return _post_json(f"{url}/stream/{sid}/finish")


@contextlib.contextmanager
def _cli_server(root: Path, *extra: str, model: list[str] | None = None):
    """``cli serve`` of phase 8's final model at stage 2 (bf16), or of the
    ``model`` flags given, in a thread, warmed unless ``extra`` says
    ``--no_warmup`` (the batch forward and the resident streaming forwards
    of every bucket); yields (url, the server, the engine)."""
    import socket

    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.serving import server

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    made, make = [], server.make_server
    server.make_server = lambda engine, *a, **kw: made.append((make(engine, *a, **kw),
                                                               engine)) or made[-1][0]
    model = model or [*MODEL_ARGS, "-st", "2", "-model_in", str(root / FINAL)]
    th = threading.Thread(target=lambda: cli.main(
        ["serve", *model, "--port", str(port), *extra]), daemon=True)
    t0 = time.perf_counter()
    th.start()
    try:
        deadline = time.time() + 600
        while not made and th.is_alive() and time.time() < deadline:
            time.sleep(0.1)
        assert made, "cli serve did not start"
        flags = [a for a, prev in zip(model + list(extra), [""] + model + list(extra))
                 if prev != "-model_in"]
        log(f"[serve] cli serve {' '.join(flags)}: loaded in {time.perf_counter() - t0:.1f} s")
        yield f"http://127.0.0.1:{port}", made[0][0], made[0][1]
    finally:
        server.make_server = make
        if made:
            made[0][0].shutdown()
        th.join(timeout=60)
    assert not th.is_alive(), "cli serve did not stop"


def _replay(engine, audio: np.ndarray) -> object:
    """A standalone session of ``engine`` fed ``audio`` in CHUNK_S chunks."""
    from privacy_preserve_federated_asr_tpu_torch.serving import StreamingSession

    s = StreamingSession(engine)
    n = int(CHUNK_S * 16000)
    for i in range(0, len(audio), n):
        s.feed(audio[i : i + n])
    return s.finish()


def streaming_full_width(root: Path) -> dict:
    """``cli serve`` (stage 2, bf16): 8 streams of 10 s through the hub and
    2 that fall back to standalone sessions (one of them ``cli
    stream-client``), paced at real time in 0.5 s binary chunks; per-feed
    latency, hub passes per hop, bytes uploaded per hub pass and per
    standalone pass, 24 B1 per pass;
    the standalone streams equal a replay. Then a ``--no_hub`` server, then
    ``transport="int16"`` batches against float32."""
    from scipy.io import wavfile

    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.data.audio import load_audio
    from privacy_preserve_federated_asr_tpu_torch.models import feat_extract_output_lengths
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import flash_attention_fwd

    audios = [_utterance(STREAM_S, 4000 + i) for i in range(STREAMS)]
    wav = root / "stream.wav"
    wavfile.write(wav, 16000, (np.clip(audios[-1], -1, 1) * 32767).astype(np.int16))
    hops = int(STREAM_S / CHUNK_S)
    out, b1 = {}, 0
    with _cli_server(root) as (url, srv, engine):
        frames = feat_extract_output_lengths(engine.cfg.backbone, len(audios[0]))
        sids = [_post_json(f"{url}/stream/start")["session"] for _ in range(STREAMS - 1)]
        hub = srv.stream_hub
        assert hub.active_sessions() == HUB_ROWS and len(srv.stream_sessions) == STREAMS - 1
        lat = [[] for _ in sids]
        reset_counts()
        f0, h0, p0 = engine.forwards, engine.h2d_bytes, hub.passes
        client_out = io.StringIO()
        with contextlib.redirect_stdout(client_out), ThreadPoolExecutor(STREAMS) as pool:
            futs = [pool.submit(_feed_stream, url, sid, audios[k], lat[k])
                    for k, sid in enumerate(sids)]
            port = url.rsplit(":", 1)[1]
            client = pool.submit(cli.main, ["stream-client", "--port", port, "--audio",
                                            str(wav), "--chunk_seconds", str(CHUNK_S)])
            finals = [f.result() for f in futs] + [client.result()]
        launches, forwards = flash_attention_fwd.launches, engine.forwards - f0
        passes, up = hub.passes - p0, engine.h2d_bytes - h0
        tally("streaming, cli serve")
        b1 += launches
        assert launches == LAYERS * forwards, (launches, forwards)
        assert len(client_out.getvalue().strip().splitlines()) == hops + 1
        for r in finals:
            assert r["is_final"] and r["total_frames"] == r["final_frames"] == frames, r
        # the standalone streams replayed alone on the idle server's engine:
        # the same chunks make the same passes and uploads, which splits the
        # bytes uploaded between the hub's passes and the standalone ones
        s0, sf0 = engine.h2d_bytes, engine.forwards
        solo = [_replay(engine, audios[HUB_ROWS]),
                _replay(engine, load_audio(str(wav), normalize=False))]
        solo_up, solo_fwd = engine.h2d_bytes - s0, engine.forwards - sf0
        for r, want in zip(finals[HUB_ROWS:], solo):
            assert r["transcript"] == want.transcript and r["ad_pred"] == want.ad_pred, r
        hub_lat = sorted(x for k in range(HUB_ROWS) for x in lat[k])
        solo_lat = sorted(lat[HUB_ROWS])
        standalone = forwards - passes
        assert solo_fwd == standalone, (solo_fwd, standalone)
        out["hub"] = {"p50": hub_lat[len(hub_lat) // 2], "max": hub_lat[-1],
                      "passes_per_hop": (passes - HUB_ROWS) / hops, "passes": passes,
                      "standalone_passes": standalone,
                      "bytes_per_pass": (up - solo_up) / passes,
                      "solo_bytes_per_pass": solo_up / solo_fwd,
                      "solo_p50": solo_lat[len(solo_lat) // 2], "solo_max": solo_lat[-1]}
        h = out["hub"]
        log(f"[stream] {STREAMS} streams of {STREAM_S:.0f} s in {CHUNK_S} s binary chunks at "
            f"real time ({HUB_ROWS} in the hub, 2 standalone, one of them cli stream-client): "
            f"hub feeds p50 {h['p50'] * 1e3:.1f} ms, max {h['max'] * 1e3:.1f} ms; standalone "
            f"feeds p50 {h['solo_p50'] * 1e3:.1f} ms, max {h['solo_max'] * 1e3:.1f} ms; hub "
            f"passes {passes} ({h['passes_per_hop']:.2f} per hop over {hops} hops, + "
            f"{HUB_ROWS} finishes), standalone passes {standalone}; uploaded "
            f"{h['bytes_per_pass'] / 1e3:.1f} kB per hub pass, "
            f"{h['solo_bytes_per_pass'] / 1e3:.1f} kB per standalone pass; B1 {launches} = {LAYERS} x {forwards} passes; finals "
            f"complete ({frames} frames), the standalone streams equal a replay  "
            f"[{card_line()}]")

    with _cli_server(root, "--no_hub") as (url, srv, engine):
        assert srv.stream_hub is None
        n = 4
        sids = [_post_json(f"{url}/stream/start")["session"] for _ in range(n)]
        lat = [[] for _ in sids]
        reset_counts()
        f0, h0 = engine.forwards, engine.h2d_bytes
        with ThreadPoolExecutor(n) as pool:
            finals = list(pool.map(lambda k: _feed_stream(url, sids[k], audios[k], lat[k]),
                                   range(n)))
        launches, forwards = flash_attention_fwd.launches, engine.forwards - f0
        tally("streaming, cli serve --no_hub")
        b1 += launches
        assert launches == LAYERS * forwards and forwards == n * (hops + 1), (launches, forwards)
        for r in finals:
            assert r["is_final"] and r["total_frames"] == frames, r
        allat = sorted(x for v in lat for x in v)
        out["no_hub"] = {"p50": allat[len(allat) // 2], "max": allat[-1],
                         "bytes_per_pass": (engine.h2d_bytes - h0) / forwards}
        log(f"[stream] cli serve --no_hub, {n} streams of {STREAM_S:.0f} s at real time: feeds "
            f"p50 {out['no_hub']['p50'] * 1e3:.1f} ms, max {out['no_hub']['max'] * 1e3:.1f} ms; "
            f"{forwards} standalone passes (one per feed and finish), "
            f"{out['no_hub']['bytes_per_pass'] / 1e3:.1f} kB uploaded per pass; B1 {launches}  "
            f"[{card_line()}]")
    out["int16"], n16 = int16_transport()
    return {"b1": b1 + n16, **out}


INT16_CER = 0.005  # of a transcript's characters, int16 against float32 at fp32


def int16_transport() -> tuple[dict, int]:
    """``transport="int16"`` against float32, engines on the same seeded
    data2vec-audio-large DACS stage-2 weights, full batches of 8 x 5 s and 8
    x 30 s. At fp32 compute, where the int16 rounding of the input (~3e-5 of
    its peak) is the only difference: AD votes equal, AD probabilities
    within 1e-3, transcripts within an edit distance of ``INT16_CER`` of
    their length (random weights leave near-tied frames that the rounding
    flips). At bf16, the serving dtype: both engines warmed on the two
    buckets (``warmup_buckets``), then both forwards timed (host clock, 3
    runs each, interleaved) and the bytes each uploads."""
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, init_dacs_state_dict)
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import flash_attention_fwd
    from privacy_preserve_federated_asr_tpu_torch.serving import InferenceEngine, ServingConfig

    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large(), stage=2)
    sd = init_dacs_state_dict(cfg, torch.Generator("cuda").manual_seed(0))
    engines = {(tr, dt): InferenceEngine(cfg, sd, scfg=ServingConfig(
        batch_size=B, transport=tr, compute_dtype=dt, warmup_buckets=(5 * 16000, 30 * 16000)))
        for tr in ("float32", "int16") for dt in ("float32", "bfloat16")}
    del sd
    for tr in ("float32", "int16"):  # the timed engines: their buckets warm
        assert engines[tr, "bfloat16"].warmup() == 2
    out, b1 = {}, 0
    for secs in (5, 30):
        batch = [_utterance(secs, 500 + i) for i in range(B)]
        reset_counts()
        got = {tr: engines[tr, "float32"].infer_batch(batch) for tr in ("float32", "int16")}
        assert flash_attention_fwd.launches == 2 * LAYERS
        b1 += flash_attention_fwd.launches
        tally("int16 transport")
        edits = []
        for a, c in zip(got["int16"], got["float32"]):
            assert (a.ad_pred, a.frames) == (c.ad_pred, c.frames)
            assert abs(a.ad_prob - c.ad_prob) <= 1e-3, (a.ad_prob, c.ad_prob)
            edits.append(_edit_distance(a.transcript, c.transcript))
            assert edits[-1] <= INT16_CER * len(c.transcript), (edits[-1], len(c.transcript))
        runs, up = {tr: [] for tr in ("float32", "int16")}, {}
        for tr in ("float32", "int16", "int16", "float32", "float32", "int16"):
            eng = engines[tr, "bfloat16"]
            reset_counts()
            h0 = eng.h2d_bytes
            t0 = time.perf_counter()
            eng.infer_batch(batch)
            runs[tr].append(time.perf_counter() - t0)
            up[tr] = eng.h2d_bytes - h0
            assert flash_attention_fwd.launches == LAYERS
            b1 += LAYERS
            tally("int16 transport")
        out[secs] = {tr: float(np.mean(v)) * 1e3 for tr, v in runs.items()}
        log(f"[int16] {B} x {secs} s at fp32: AD votes equal, transcripts equal on "
            f"{edits.count(0)} of {B} (edit distances {edits}, limit {INT16_CER:.1%} of "
            f"~{len(got['float32'][0].transcript)} characters); infer_batch at bf16: int16 "
            f"{out[secs]['int16']:.1f} ms ({up['int16'] / 1e6:.2f} MB uploaded), float32 "
            f"{out[secs]['float32']:.1f} ms ({up['float32'] / 1e6:.2f} MB)  [{card_line()}]")
    del engines
    torch.cuda.empty_cache()
    return out, b1


# ---------------------------------------------------------------------------
# 24. streaming exactness on the card (stage 1, fp32)
# ---------------------------------------------------------------------------

def streaming_exact(root: Path) -> None:
    """The 4-layer fp32 model at stage 1 (no Gumbel noise): with right
    context >= the utterance, ``finish()`` equals ``infer_batch``; resident
    equals legacy on every pass; hub members equal standalone sessions;
    beam + bigram LM streaming equals the batch beam; then ``cli
    stream-report`` of phase 8's final model prints its rows."""
    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.data.tokenizer import CTCCharTokenizer
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, init_dacs_state_dict)
    from privacy_preserve_federated_asr_tpu_torch.ops.beam import CharBigramLM
    from privacy_preserve_federated_asr_tpu_torch.serving import (
        InferenceEngine, ServingConfig, StreamingConfig, StreamingHub, StreamingSession)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DACSConfig(backbone=BackboneConfig.data2vec_audio_large().replace(
        num_hidden_layers=4), stage=1)
    sd = init_dacs_state_dict(cfg, torch.Generator("cuda").manual_seed(5))
    tok = CTCCharTokenizer()
    lm = CharBigramLM(cfg.backbone.vocab_size).fit([tok.encode(s) for s in SENTENCES])
    scfg = dict(batch_size=4, max_seconds=10.0, compute_dtype="float32")
    eng = InferenceEngine(cfg, sd, tok, ServingConfig(**scfg))
    beng = InferenceEngine(cfg, sd, tok, ServingConfig(**scfg, beam_size=8), lm_fn=lm)
    audio = _utterance(4.0, 21)
    sec = 16000
    reset_counts()

    def feed(s, a):
        return [s.feed(a[i : i + sec]) for i in range(0, len(a), sec)]

    wide = StreamingConfig(right_context_seconds=10.0, min_hop_seconds=0.0)
    for e in (eng, beng):
        s = StreamingSession(e, wide)
        assert all(r.final_frames == 0 for r in feed(s, audio))
        got, want = s.finish(), e.infer_batch([audio])[0]
        assert (got.transcript, got.ad_pred, got.total_frames) == (
            want.transcript, want.ad_pred, want.frames), (got, want)
        assert abs(got.ad_prob - want.ad_prob) < 1e-5
    narrow = dict(right_context_seconds=0.4, min_hop_seconds=0.0)
    res = StreamingSession(eng, StreamingConfig(**narrow))
    leg = StreamingSession(eng, StreamingConfig(**narrow, resident=False))
    for i in range(0, len(audio), sec):
        a, b = res.feed(audio[i : i + sec]), leg.feed(audio[i : i + sec])
        assert (res._final_ids, res._tail_ids) == (leg._final_ids, leg._tail_ids), i
        assert (a.transcript, a.final_frames) == (b.transcript, b.final_frames), i
    assert res.finish().transcript == leg.finish().transcript
    # members of one length, so that every hub pass and every standalone
    # pass runs in the same time bucket (across buckets the last frames
    # differ by design: the stacked positional convs see zeroed padding only
    # at their first layer)
    hub = StreamingHub(eng, StreamingConfig(**narrow))
    others = [_utterance(4.0, 30 + k) for k in range(3)]
    members = [hub.open() for _ in others]
    solos = [StreamingSession(eng, StreamingConfig(**narrow)) for _ in others]
    for i in range(0, 4 * sec, sec):
        for m, s, a in zip(members, solos, others):
            x, y = m.feed(a[i : i + sec]), s.feed(a[i : i + sec])
            assert (x.transcript, x.final_frames) == (y.transcript, y.final_frames)
    for m, s in zip(members, solos):
        x, y = m.finish(), s.finish()
        assert (x.transcript, x.ad_pred, x.total_frames) == (y.transcript, y.ad_pred,
                                                             y.total_frames)
    tally("streaming exactness")
    log(f"[stream-e2e] 4-layer fp32 stage 1 on the card: finish() with right context >= "
        f"the utterance equals infer_batch (greedy and beam 8 + bigram LM); resident equals "
        f"legacy on every pass; {len(members)} hub members equal standalone sessions "
        f"({hub.passes} hub passes)")
    del eng, beng
    reset_counts()
    rows, text, wall = _run_cli(root, [
        "stream-report", "--model_type", "data2vec", "-st", "1", "-model_in", FINAL,
        "--compute_dtype", "float32", "--eval_batch_size", "1", "--audio_dir", "data/clips",
        "--test_csv", "data/test.csv", "--spk2label", "data/spk2label.npy",
        "--dataset_cache", "cache", "--max_utts", "2", "--right_context_grid", "0.25", "1.0",
        "10", "--hop_seconds", "0.5", "--device", "cuda"])
    tally("cli stream-report")
    printed = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
    assert printed == rows and [r["right_context_seconds"] for r in rows] == [0.25, 1.0, 10.0]
    assert rows[-1]["finalized_frames"] == 0 and rows[0]["finalized_frames"] > 0, rows
    log(f"[stream-e2e] cli stream-report -st 1 (phase 8's final model, fp32, 2 test WAVs): "
        f"{wall:.1f} s; rows {rows}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 25. the method variants at full width: single-toggle and FSM
# ---------------------------------------------------------------------------

VAR_TRAIN, VAR_TEST, VAR_BATCH, VAR_STEPS, VAR_LR = 48, 8, 16, 3, "1e-4"
VAR_ARGS = ["--compute_dtype", "bfloat16", "--train_batch_size", str(VAR_BATCH),
            "--eval_batch_size", str(VAR_BATCH), "--epochs", "1", "--seed", "0",
            "-lr", VAR_LR, "--audio_dir", "data/clips", "--train_csv", "data/train.csv",
            "--test_csv", "data/test.csv", "--spk2label", "data/spk2label.npy",
            "--dataset_cache", "cache", "--device", "cuda"]


def _train_checked(data: Path, args: list[str], tag: str, b1_per_forward: int,
                   b2_per_step: int) -> dict:
    """``cli train`` in ``data`` with the counts reset before and read after:
    ``VAR_STEPS`` steps, ``b1_per_forward`` B1 per step and per eval batch,
    ``b2_per_step`` B2 per step; every parameter outside the recipe's trainable set
    bit-unchanged from the CLI's own init, all finite. Returns the Trainer,
    its stdout, the launches, the moved tensors and step ms / idle share."""
    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)
    from privacy_preserve_federated_asr_tpu_torch.train.optim import path_of

    reset_counts()
    tr, out, wall = _run_cli(data, ["train", *args, *VAR_ARGS])
    b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
    tally(tag)
    steps, n_eval = tr.state.step, len(tr.eval_batcher)
    ev = _last_json(out)
    assert steps == VAR_STEPS and all(np.isfinite(v) for v in ev.values()), (steps, ev)
    want = (b1_per_forward * (steps + n_eval), b2_per_step * steps)
    assert (b1, b2) == want, (tag, b1, b2, want)
    model_in = args[args.index("-model_in") + 1] if "-model_in" in args else None
    with _cwd(data), contextlib.redirect_stdout(io.StringIO()):
        init = cli.load_weights(tr.cfg, model_in, 0, "cuda")
    pred, moved = tr.recipe.trainable(tr.cfg.stage), []
    for k, v in tr.state.model.state_dict().items():
        assert torch.isfinite(v).all(), (tag, k)
        if not torch.equal(v, init[k].to(v.device)):  # a file's tensors load on the CPU
            assert pred(path_of(k)), f"{tag}: frozen {k} changed"
            moved.append(k)
    times, batches = [], (x for e in range(1, 4) for x in tr.train_batches(e))
    for _ in range(5):
        _, (fn, fn_args) = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = fn(tr.state, *fn_args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        assert np.isfinite(float(m["loss"])), m
    _, (fn, fn_args) = next(batches)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prof = profile_step(fn, (tr.state, *fn_args))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    idle = ("not measured" if prof is None else
            f"device busy {prof['device_ms']:.1f} of {prof['wall_ms']:.1f} ms wall (idle "
            f"{1 - prof['device_ms'] / prof['wall_ms']:.1%}), B1 {prof['b1_ms']:.1f} ms, "
            f"B2 {prof['b2_ms']:.1f} ms")
    step_s = float(np.mean(times[2:]))
    log(f"[{tag}] {steps} steps + evaluate() in {wall:.1f} s; eval {ev}; B1 {b1}, B2 {b2} "
        f"(as expected); {len(moved)} tensors moved, every other bit-unchanged, all finite; "
        f"step {step_s * 1e3:.1f} ms mean over {len(times) - 2} (B={VAR_BATCH} x 5 s bucket, "
        f"min {min(times[2:]) * 1e3:.1f}); one step under torch.profiler: {idle}; the step "
        f"adds {peak:.2f} GiB at its peak  [{card_line()}]")
    return {"tr": tr, "out": out, "b1": b1, "b2": b2, "moved": moved, "step_s": step_s,
            "idle": None if prof is None else 1 - prof["device_ms"] / prof["wall_ms"],
            "peak_gib": peak}


def variants_full_width(root: Path) -> dict:
    """data2vec-audio-large (24 layers, bf16) under the variants, through
    ``cli.main``: single-toggle stage 1 from phase 14's ForCTC export of
    phase 8's final model (the DACS D->4D arbitrator skipped loudly, the
    rest grafted) and stage 2 from its final; FSM stage 1 from the same
    export (the encoder trains: 24 B2 per step); ``cli extract`` of both in
    bf16 with each method's mask columns; one /asr request through ``cli
    serve --method fsm -st 2``."""
    from privacy_preserve_federated_asr_tpu_torch.evaluation import read_records
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import flash_attention_fwd

    data = root / "variants"
    _write_corpus(data / "data", VAR_TRAIN, VAR_TEST)
    export = str(root / "export/pytorch_model.bin")
    model = ["--model_type", "data2vec"]
    st1 = _train_checked(data, [*model, "--method", "single_toggle", "-st", "1",
                                "-model_in", export, "-model_out", "st1"],
                         "cli train single_toggle -st 1", LAYERS, 0)
    assert "WARNING: checkpoint head 'arbitrator'" in st1["out"], st1["out"][:2000]
    assert {k.split(".")[0] for k in st1["moved"]} == {"dementia_head"}, st1["moved"]
    st2 = _train_checked(data, [*model, "--method", "single_toggle", "-st", "2",
                                "-model_in", "st1/final", "-model_out", "st2"],
                         "cli train single_toggle -st 2", LAYERS, 0)
    assert {k.split(".")[0] for k in st2["moved"]} == {"arbitrator"}, st2["moved"]
    fsm = _train_checked(data, [*model, "--method", "fsm", "-st", "1", "-model_in", export,
                                "-model_out", "fsm"], "cli train fsm -st 1", LAYERS, LAYERS)
    moved = {k.split(".")[0] for k in fsm["moved"]}
    assert {"backbone", "lm_fsm", "dementia_fsm", "similar_fc"} <= moved, moved
    assert not any(k.startswith("backbone.feature_extractor.") for k in fsm["moved"])
    log("[variants] single-toggle: the export's D->4D arbitrator skipped with its warning, "
        "stage 1 moved dementia_head alone and stage 2 the arbitrator alone (the backbone "
        "frozen: 0 B2); FSM stage 1 moved the encoder (not its conv frontend), the machines "
        "(by the weight decay: their gradient is 0) and similar_fc")

    n_batches = -(-VAR_TEST // VAR_BATCH) + -(-VAR_TRAIN // VAR_BATCH)
    ext_b1 = 0
    for method, stage, final, cols in (("fsm", "1", "fsm/final", {"lm_mask", "dementia_mask"}),
                                       ("single_toggle", "2", "st2/final", {"lm_mask"})):
        reset_counts()
        _, _, wall = _run_cli(data, [
            "extract", *model, "--method", method, "-st", stage, "-model_in", final,
            "--compute_dtype", "bfloat16", "--eval_batch_size", str(VAR_BATCH),
            "--audio_dir", "data/clips", "--train_csv", "data/train.csv", "--test_csv",
            "data/test.csv", "--spk2label", "data/spk2label.npy", "--dataset_cache", "cache",
            "--csv_out_dir", f"res_{method}", "--device", "cuda"])
        assert flash_attention_fwd.launches == LAYERS * n_batches, flash_attention_fwd.launches
        ext_b1 += flash_attention_fwd.launches
        tally(f"cli extract {method}")
        rows = read_records(str(data / f"res_{method}/extract.pkl"))
        train = read_records(str(data / f"res_{method}/extract_train.pkl"))
        assert (len(rows), len(train)) == (VAR_TEST, VAR_TRAIN)
        for r in rows + train:
            assert set(r) == ROW_COLUMNS - {"lm_mask", "dementia_mask"} | cols, set(r)
            for c in cols:
                assert set(np.unique(r[c])) <= {0.0, 1.0} and r[c].shape == r[
                    "hidden_states"].shape, (method, c)
            assert np.isfinite(r["hidden_states"]).all()
        on = {c: float(np.mean([r[c].mean() for r in rows])) for c in cols}
        log(f"[variants] cli extract --method {method} -st {stage} (bf16, batch {VAR_BATCH}): "
            f"{len(rows)} + {len(train)} rows in {wall:.1f} s, columns {sorted(cols)} beside "
            f"the unmasked ones, mask on-rates {on}; B1 {LAYERS} x {n_batches} batches")

    audio = _utterance(4.5, 900)
    reset_counts()
    with _cli_server(data, "--no_warmup", model=[
            *model, "--method", "fsm", "-st", "2", "-model_in", str(data / "fsm/final"),
            "--eval_batch_size", str(FL_BATCH), "--device", "cuda"]) as (url, _, engine):
        got, secs = _post(f"{url}/asr", audio, "f32")
        assert flash_attention_fwd.launches == LAYERS, flash_attention_fwd.launches
        tally("cli serve fsm")
        want = engine.infer_batch([audio])[0]
    assert (got["transcript"], got["ad_pred"]) == (want.transcript, want.ad_pred), got
    log(f"[variants] cli serve --method fsm -st 2: one /asr request of 4.5 s answered in "
        f"{secs * 1e3:.0f} ms ({LAYERS} B1 launches), equal to infer_batch of it")
    out = {"b1": st1["b1"] + st2["b1"] + fsm["b1"] + ext_b1 + LAYERS,
           "b2": st1["b2"] + st2["b2"] + fsm["b2"],
           "step_ms": {k: v["step_s"] * 1e3 for k, v in (("single_toggle -st 1", st1),
                                                         ("single_toggle -st 2", st2),
                                                         ("fsm -st 1", fsm))},
           "idle": {k: v["idle"] for k, v in (("single_toggle -st 2", st2), ("fsm -st 1", fsm))}}
    del st1, st2, fsm
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 26. the variants, card against CPU
# ---------------------------------------------------------------------------

FSM_BAND = 1e-4  # |sigmoid score - threshold| within which a mask may flip


def _two_utterances() -> tuple[np.ndarray, np.ndarray]:
    """Phase 7's batch: 5 s and 4.2 s (padded), normalized."""
    from privacy_preserve_federated_asr_tpu_torch.data.audio import normalize_input_values

    x = np.zeros((2, 80000), np.float32)
    x[0] = normalize_input_values(_utterance(5.0, 11))
    x[1, :67200] = normalize_input_values(_utterance(4.2, 12))
    return x, np.array([80000, 67200], np.int32)


def _step_vs_cpu(cfg, sd, host: dict, tag: str, lr: float = 1e-4, check=None) -> None:
    """Phase 7's rule for one full-forward train step (the recipe's
    ``make_train_step``) of ``cfg`` from ``sd`` on the card and on the CPU:
    loss rtol 1e-4, grad norm rtol 1e-3, at most 0.5% of the param elements
    beyond 1e-2 lr. ``check(model)`` runs on the card's model first."""
    from privacy_preserve_federated_asr_tpu_torch.models.recipes import get_recipe
    from privacy_preserve_federated_asr_tpu_torch.train import (
        DeviceBatch, create_train_state, make_optimizer, make_train_step)

    recipe = get_recipe(cfg.method)
    metrics, params = {}, {}
    for dev in ("cuda", "cpu"):
        with torch.device("meta"):
            model = recipe.make_model(cfg, torch.float32)
        model = model.to_empty(device=dev)
        model.load_state_dict(sd)
        if check is not None and dev == "cuda":
            check(model)
        state = create_train_state(model, make_optimizer(
            model, cfg.stage, learning_rate=lr, trainable_pred=recipe.trainable(cfg.stage)), 3)
        batch = DeviceBatch(**{k: torch.from_numpy(v).to(dev) for k, v in host.items()})
        m = make_train_step(cfg)(state, batch)
        metrics[dev] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        params[dev] = {k: v.cpu() for k, v in model.state_dict().items()}
    a, c = metrics["cuda"], metrics["cpu"]
    for k, rtol in (("loss", 1e-4), ("grad_norm", 1e-3)):
        assert abs(a[k] - c[k]) <= rtol * abs(c[k]), (tag, k, a[k], c[k])
    off = sum(int(((params["cuda"][k] - v).abs() > 1e-2 * lr).sum())
              for k, v in params["cpu"].items())
    frac = off / sum(v.numel() for v in params["cpu"].values())
    assert all(torch.isfinite(v).all() for v in params["cuda"].values()), tag
    assert frac <= 5e-3, (tag, frac)
    log(f"[{tag}] one AdamW step at lr {lr:g}: card vs CPU loss {a['loss']:.4f} / "
        f"{c['loss']:.4f}, grad norm {a['grad_norm']:.4f} / {c['grad_norm']:.4f}; "
        f"{frac:.2e} of param elements beyond 1e-2 lr (limit 5e-3)")


def variants_vs_cpu() -> dict:
    """The 4-layer fp32 data2vec-audio-large under single-toggle (stage 2,
    injected Gumbel noise) and FSM (stage 1): forward outputs card vs CPU
    (phase 4's 1e-3; single-toggle's mask equal except at Gumbel margins
    below ``NEAR_TIE``, FSM's except where the CPU's score is within
    ``FSM_BAND`` of the threshold, the elements in that band counted), then
    train steps by phase 7's rule (the same noise on both), and FSM's
    machines' gradient exactly zero on the card."""
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, feat_extract_output_lengths, init_dacs_state_dict)
    from privacy_preserve_federated_asr_tpu_torch.models import variants
    from privacy_preserve_federated_asr_tpu_torch.models.recipes import get_recipe

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bb = BackboneConfig.data2vec_audio_large().replace(
        num_hidden_layers=4, hidden_dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0)
    x, il = _two_utterances()
    t = feat_extract_output_lengths(bb, x.shape[1])
    noise = np.random.default_rng(9).gumbel(size=(2, t, bb.hidden_size, 2)).astype(np.float32)
    from privacy_preserve_federated_asr_tpu_torch.data.tokenizer import CTCCharTokenizer

    tok = CTCCharTokenizer()
    ids = [tok.encode(s) for s in SENTENCES[:2]]
    labels = np.full((2, 32), -100, np.int64)
    for i, s in enumerate(ids):
        labels[i, : len(s)] = s
    host = dict(input_values=x, input_lengths=il, labels=labels,
                label_lengths=np.array([len(s) for s in ids]),
                dementia_labels=np.array([1, 0]), sample_mask=np.ones(2, np.float32))
    band_counts = {}
    real_sample = variants.sample_gumbel
    reset_counts()  # the CPU runs the plain version: only the card's launches count
    try:
        # the steps' draws: the same numpy noise on both devices
        variants.sample_gumbel = lambda shape, gen, dev: torch.from_numpy(noise).to(dev)
        for method, stage in (("single_toggle", 2), ("fsm", 1)):
            cfg = DACSConfig(backbone=bb, method=method, stage=stage)
            sd = init_dacs_state_dict(cfg, torch.Generator("cpu").manual_seed(8))
            outs = {}
            for dev in ("cuda", "cpu"):
                with torch.device("meta"):
                    model = get_recipe(method).make_model(cfg, torch.float32)
                model = model.to_empty(device=dev)
                model.load_state_dict(sd, strict=True)
                model.eval()
                with torch.inference_mode():
                    out = model(torch.from_numpy(x).to(dev), torch.from_numpy(il).to(dev),
                                gumbel_noise=(torch.from_numpy(noise).to(dev),)
                                if method == "single_toggle" else None)
                outs[dev] = {k: v.float().cpu() for k, v in vars(out).items()
                             if isinstance(v, torch.Tensor) and v.is_floating_point()}
            g, c = outs["cuda"], outs["cpu"]
            if method == "single_toggle":
                s = c["lm_score"] + torch.from_numpy(noise)
                near = (s[..., 0] - s[..., 1]).abs() < NEAR_TIE
                masks = ("lm_mask",)
            else:
                near = (c["lm_score"] - cfg.fsm_lm_thres).abs() < FSM_BAND
                near_ad = (c["dementia_score"] - cfg.fsm_ad_thres).abs() < FSM_BAND
                masks = ("lm_mask", "dementia_mask")
            flips, same = {}, torch.ones(c["lm_mask"].shape[:2], dtype=torch.bool)
            for m in masks:
                band = near if m == "lm_mask" else near_ad
                differ = g[m] != c[m]
                assert not (differ & ~band).any(), (method, m)
                flips[m] = int(differ.sum())
                band_counts[f"{method} {m}"] = int(band.sum())
                same &= ~differ.any(-1)
            # every stream on every frame where no mask element flipped
            # (a flip moves that frame's masked streams by design)
            errs = {k: (g[k] - c[k])[same].abs().max().item() for k in c
                    if "logits" in k or k == "hidden_states"}
            assert max(errs.values()) <= 1e-3, (method, errs)
            log(f"[variants-e2e] 4-layer fp32 {method} stage {stage}, 5 s + 4.2 s: card vs "
                f"CPU max|err| " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                + f" (limit 1e-3); mask elements in the near-tie band "
                + ", ".join(f"{m} {band_counts[f'{method} {m}']}" for m in masks)
                + f" of {c['lm_mask'].numel()} each, flipped {flips}; streams compared on "
                f"{int(same.sum())} of {same.numel()} frames")

            def zero_machine_grads(model, cfg=cfg):
                if cfg.method != "fsm":
                    return
                model.train()
                dev = next(model.parameters()).device
                out = model(torch.from_numpy(x).to(dev), torch.from_numpy(il).to(dev))
                loss, _ = get_recipe("fsm").loss(
                    out, *(torch.from_numpy(host[k]).to(dev) for k in
                           ("labels", "label_lengths", "dementia_labels")), cfg, model,
                    None, True)
                loss.backward()
                for name in ("lm_fsm", "dementia_fsm"):
                    for p in getattr(model, name).parameters():
                        assert p.grad is None or not p.grad.any(), name
                assert model.backbone.encoder.layers[0].attention.q_proj.weight.grad.any()
                model.zero_grad(set_to_none=True)
                log("[variants-e2e] FSM on the card: lm_fsm and dementia_fsm get exactly "
                    "zero gradient (the reference's zero-gradient hack), the encoder a "
                    "non-zero one")

            _step_vs_cpu(cfg, sd, host, f"variants-e2e {method} -st {stage}",
                         check=zero_machine_grads)
    finally:
        variants.sample_gumbel = real_sample
    tally("variants, card vs CPU")
    return band_counts


# ---------------------------------------------------------------------------
# 27. SEW-D at full width
# ---------------------------------------------------------------------------

def sewd_full_width(root: Path) -> dict:
    """sew_d_mid (12 layers, D=768, 13-conv GroupNorm frontend, squeeze 2,
    256 buckets; bf16; random weights from a seed) through ``cli.main``:
    ``train -st 0`` (B=16 x 5 s, 3 steps, no frontend cache: the GroupNorm
    frontend), then ``-st 1`` on the encoder cache, ``serve -st 2`` answering
    8 concurrent 5 s and 8 concurrent 30 s requests, ``extract`` in fp32
    and bf16; B1 and B2 launch 0 times throughout (SEW-D's attention adds
    c2p and p2c terms the kernel does not compute). The engine's batch
    forward at 8 x 5 s and 8 x 30 s timed with its peak memory."""
    from privacy_preserve_federated_asr_tpu_torch.evaluation import read_records
    from privacy_preserve_federated_asr_tpu_torch.models.sewd import SEWDBackbone
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)

    data = root / "variants"
    model = ["--model_type", "sewd"]
    st0 = _train_checked(data, [*model, "-st", "0", "-model_out", "sewd0"],
                         "cli train sewd -st 0", 0, 0)
    tr = st0["tr"]
    assert isinstance(tr.state.model.backbone, SEWDBackbone)
    assert not tr._cache_frontend and not tr._cache_encoder
    assert not any(k.startswith(FROZEN_AT_STAGE0) for k in st0["moved"])
    st1 = _train_checked(data, [*model, "-st", "1", "-model_in", "sewd0/final",
                                "-model_out", "sewd1"], "cli train sewd -st 1", 0, 0)
    assert st1["tr"]._cache_encoder
    assert {k.split(".")[0] for k in st1["moved"]} == {"dementia_head"}, st1["moved"]
    train = {"step_ms": st0["step_s"] * 1e3, "peak_gib": st0["peak_gib"], "idle": st0["idle"]}
    log("[sewd] cli train --model_type sewd: stage 0 without a frontend cache (the GroupNorm "
        "frontend) moved the encoder but not its frontend; stage 1 on the encoder cache "
        "moved dementia_head alone; 0 B1 and 0 B2 launches")
    del st0, st1, tr
    torch.cuda.empty_cache()

    reset_counts()
    serve_model = [*model, "-st", "2", "-model_in", str(data / "sewd1/final"),
                   "--eval_batch_size", str(B), "--device", "cuda"]
    served = {}
    with _cli_server(data, "--no_warmup", model=serve_model) as (url, _, engine):
        for secs in (5, 30):
            audios = [_utterance(secs - 0.25 * i, 700 + i) for i in range(B)]
            with ThreadPoolExecutor(B) as ex:
                got = list(ex.map(lambda a: _post(f"{url}/asr", a, "f32"), audios))
            assert all(isinstance(r["transcript"], str) and r["ad_pred"] in (0, 1)
                       for r, _ in got), got
            served[secs] = max(s for _, s in got)
    assert flash_attention_fwd.launches == 0 and flash_attention_bwd.launches == 0
    tally("cli serve sewd")
    log(f"[sewd] cli serve --model_type sewd -st 2: {B} concurrent requests of ~5 s answered "
        f"within {served[5] * 1e3:.0f} ms, {B} of ~30 s within {served[30] * 1e3:.0f} ms; "
        f"0 B1 launches  [{card_line()}]")

    eng = engine  # the server's (bf16, batch 8), its HTTP front end shut down
    fwd = {}
    reset_counts()
    for secs in (5, 30):
        batch = [_utterance(secs, 800 + i) for i in range(B)]
        eng.infer_batch(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = wall_ms(lambda: eng.infer_batch(batch), 3, warmup=0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        prof = profile_forward(eng, batch)
        idle = ("not measured" if prof is None else
                f"device busy {prof['device_ms']:.1f} of {prof['wall_ms']:.1f} ms (idle "
                f"{1 - prof['device_ms'] / prof['wall_ms']:.1%})")
        fwd[secs] = {"ms": ms, "peak_gib": peak}
        log(f"[sewd] infer_batch of {B} x {secs} s (bf16): {ms:.1f} ms mean of 3, the forward "
            f"adds {peak:.2f} GiB at its peak; one forward under torch.profiler: {idle}  "
            f"[{card_line()}]")
    assert flash_attention_fwd.launches == 0
    tally("sewd serving")
    del eng, engine
    torch.cuda.empty_cache()

    rows = {}
    for dt in ("float32", "bfloat16"):
        reset_counts()
        _, _, wall = _run_cli(data, [
            "extract", *model, "-st", "1", "-model_in", "sewd1/final", "--compute_dtype", dt,
            "--eval_batch_size", str(VAR_BATCH), "--audio_dir", "data/clips",
            "--train_csv", "data/train.csv", "--test_csv", "data/test.csv",
            "--spk2label", "data/spk2label.npy", "--dataset_cache", "cache",
            "--csv_out_dir", f"res_sewd_{dt}", "--device", "cuda"])
        assert flash_attention_fwd.launches == 0
        tally(f"cli extract sewd {dt}")
        rows[dt] = read_records(str(data / f"res_sewd_{dt}/extract.pkl"))
        assert len(rows[dt]) == VAR_TEST and all(
            set(r) == ROW_COLUMNS and np.isfinite(r["hidden_states"]).all() for r in rows[dt])
        log(f"[sewd] cli extract --model_type sewd -st 1 --compute_dtype {dt}: {VAR_TEST} + "
            f"{VAR_TRAIN} rows in {wall:.1f} s")
    cos = []
    for a, b in zip(rows["bfloat16"], rows["float32"]):
        u, v = (r["hidden_states"].astype(np.float64).ravel() for r in (a, b))
        cos.append(float(u @ v / (np.linalg.norm(u) * np.linalg.norm(v))))
    assert min(cos) > 0.99, cos
    log(f"[sewd] bf16 rows against fp32: hidden-state cosine min {min(cos):.5f} (rule > 0.99)")
    return {"forward": fwd, "train": train}


# ---------------------------------------------------------------------------
# 28. SEW-D, card against CPU
# ---------------------------------------------------------------------------

def sewd_vs_cpu() -> None:
    """The HF SEW-D golden (tests/fixtures/golden_sewd.npz) through
    ``state_dict_from_hf`` on the card against its HF output (the JAX golden
    test's rtol 2e-3, atol 3e-4 over frames rounded down to the squeeze
    factor); the 4-layer fp32 sew_d_mid (dropout off) DACS forward card vs
    CPU (1e-3) and stage-0 train steps by phase 7's rule."""
    from privacy_preserve_federated_asr_tpu_torch.models import (
        BackboneConfig, DACSConfig, DACSModel, feat_extract_output_lengths,
        init_dacs_state_dict, state_dict_from_hf)
    from privacy_preserve_federated_asr_tpu_torch.models.sewd import SEWDBackbone

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    z = np.load(os.path.join(ROOT, "tests/fixtures/golden_sewd.npz"))
    meta = json.loads(bytes(z["meta"]).decode())
    gcfg = BackboneConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in meta.items()
                             if k in BackboneConfig.__dataclass_fields__})
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd/")}
    model = SEWDBackbone(gcfg).to("cuda").eval()
    model.load_state_dict(state_dict_from_hf(sd, gcfg), strict=True)
    x, lengths, expected = z["x"], z["lengths"], z["expected"]
    fl = feat_extract_output_lengths(gcfg, lengths)
    t = feat_extract_output_lengths(gcfg, x.shape[1])
    fm = (np.arange(t)[None] < fl[:, None]).astype(np.int32)
    reset_counts()
    with torch.inference_mode():
        ours = model(torch.from_numpy(x).cuda(), torch.from_numpy(fm).cuda()).cpu().numpy()
    worst = 0.0
    for b, n in enumerate(fl):
        n = int(n) // gcfg.squeeze_factor * gcfg.squeeze_factor
        np.testing.assert_allclose(ours[b, :n], expected[b, :n], rtol=2e-3, atol=3e-4)
        worst = max(worst, float(np.abs(ours[b, :n] - expected[b, :n]).max()))
    log(f"[sewd-e2e] golden_sewd.npz (HF SEW-D state dict, strict) on the card: max|err| "
        f"{worst:.2e} against HF's output (rtol 2e-3, atol 3e-4)")

    cfg = DACSConfig(backbone=BackboneConfig.sew_d_mid().replace(
        num_hidden_layers=4, hidden_dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, feat_proj_dropout=0.0), stage=0)
    sd = init_dacs_state_dict(cfg, torch.Generator("cpu").manual_seed(10))
    xx, il = _two_utterances()
    outs = {}
    for dev in ("cuda", "cpu"):
        with torch.device("meta"):
            m = DACSModel(cfg, torch.float32)
        m = m.to_empty(device=dev)
        m.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            out = m.eval()(torch.from_numpy(xx).to(dev), torch.from_numpy(il).to(dev),
                           need_masks=False)
        outs[dev] = {k: getattr(out, k).float().cpu() for k in ("hidden_states",
                                                                "logits_unmask")}
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item() for k in outs["cpu"]}
    assert max(errs.values()) <= 1e-3, errs
    log(f"[sewd-e2e] 4-layer fp32 sew_d_mid DACS, 5 s + 4.2 s: card vs CPU max|err| "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()) + " (limit 1e-3)")
    tok_ids = [[5, 6, 7, 8], [9, 10]]
    labels = np.full((2, 32), -100, np.int64)
    for i, s in enumerate(tok_ids):
        labels[i, : len(s)] = s
    host = dict(input_values=xx, input_lengths=il, labels=labels,
                label_lengths=np.array([4, 2]), dementia_labels=np.array([1, 0]),
                sample_mask=np.ones(2, np.float32))
    _step_vs_cpu(cfg, sd, host, "sewd-e2e -st 0")
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)

    assert flash_attention_fwd.launches == 0 and flash_attention_bwd.launches == 0
    tally("sewd, card vs CPU")


# ---------------------------------------------------------------------------
# 29. cli teacher
# ---------------------------------------------------------------------------

TEACHER_LAYERS = 4


def teacher_phase(root: Path) -> dict:
    """``cli teacher`` (the CTC self-training teacher, ``--method grl -st
    0``: the unmasked stream) of phase 8's final model on the 8 test WAVs as
    an unlabeled CSV: 24 B1 per batch; its transcripts equal ``cli
    transcribe`` greedy of the same model and clips at fp32; its CSV then
    feeds one ``cli federated -fl_st 1 -sl 0.5 --unsup_train_csv`` round of
    the model cut to 4 layers (random init), with exact B1 / B2 launches."""
    from privacy_preserve_federated_asr_tpu_torch import cli
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_fwd)

    names = [line.split(",")[0] for line in (root / "data/test.csv").read_text().splitlines()[1:]]
    (root / "data/teacher_in.csv").write_text("path\n" + "\n".join(names) + "\n")
    reset_counts()
    trs, out, wall = _run_cli(root, [
        "teacher", *MODEL_ARGS, "--method", "grl", "-st", "0", "-model_in", FINAL,
        "--audio_dir", "data/clips", "--train_csv", "data/teacher_in.csv",
        "--spk2label", "data/spk2label.npy", "--dataset_cache", "cache",
        "--out", "teacher/pseudo.csv"])
    b1 = flash_attention_fwd.launches
    tally("cli teacher")
    n_batches = -(-len(names) // FL_BATCH)
    assert b1 == LAYERS * n_batches, b1
    assert sorted(trs) == sorted(names)
    assert json.loads((root / "teacher/pseudo.json").read_text()) == trs
    kept = (root / "teacher/pseudo.csv").read_text().splitlines()
    assert kept[0] == "path,sentence" and len(kept) - 1 == sum(bool(t.strip())
                                                               for t in trs.values())
    rows, _, tb1 = _transcribe(root, FINAL, "--method", "grl", "-st", "0",
                               "--compute_dtype", "float32", phase="cli transcribe, teacher")
    assert tb1 == LAYERS * n_batches, tb1
    got = {Path(r["path"]).name: r["transcript"] for r in rows}
    assert got == trs, (got, trs)
    log(f"[teacher] cli teacher --method grl -st 0 (phase 8's final model, fp32) of "
        f"{len(names)} WAVs: {wall:.1f} s, B1 {b1} = {LAYERS} x {n_batches}; its "
        f"transcripts equal cli transcribe's greedy of the same clips; {len(kept) - 1} "
        f"labeled rows in teacher/pseudo.csv")

    real_cfg = cli._dacs_cfg
    cli._dacs_cfg = lambda args: (lambda c: c.replace(backbone=c.backbone.replace(
        num_hidden_layers=TEACHER_LAYERS)))(real_cfg(args))
    try:
        reset_counts()
        eng, out, fwall = _run_cli(root, [
            "federated", *FL_ARGS, "--epochs", "1", "-fl_st", "1", "-sl", "0.5",
            "--unsup_train_csv", "teacher/pseudo.csv", "-model_out", "out/teacher_fl"])
        fb1, fb2 = flash_attention_fwd.launches, flash_attention_bwd.launches
        tally("cli federated -sl 0.5, teacher CSV")
    finally:
        cli._dacs_cfg = real_cfg
    assert eng.cfg.backbone.num_hidden_layers == TEACHER_LAYERS
    rows = eng.logger.history
    rnd = next(r for r in rows if "phase" in r)
    assert len(rnd["phase"].split("+")) == 2, rnd  # the unlabeled phase, then the labeled
    ws = sum(r["warm_start_steps"] for r in rows if "warm_start_steps" in r)
    local = sum(r["local_steps"] for r in rows if "local_steps" in r)
    n_evals = sum("eval_loss" in r for r in rows) + 1  # the CLI's final evaluation
    n_eval = -(-FL_TEST // FL_BATCH)
    want = (TEACHER_LAYERS * (ws + local + n_evals * n_eval), TEACHER_LAYERS * (ws + local))
    assert (fb1, fb2) == want, (fb1, fb2, want, rows)
    ev = _last_json(out)
    assert all(np.isfinite(v) for v in ev.values()), ev
    log(f"[teacher] cli federated -fl_st 1 -sl 0.5 --unsup_train_csv teacher/pseudo.csv "
        f"({TEACHER_LAYERS} layers, random init): round phases {rnd['phase']} "
        f"({rnd['phase_steps']} steps per client), {fwall:.1f} s; B1 {fb1}, B2 {fb2} "
        f"(= {TEACHER_LAYERS} x ({ws:.0f} warm-start + {local:.0f} local steps [+ "
        f"{n_evals} evaluations x {n_eval} batches for B1]))  [{card_line()}]")
    del eng
    torch.cuda.empty_cache()
    return {"b1": b1 + tb1 + fb1, "b2": fb2}


def _shape_times(row: dict, **shape) -> dict:
    return {**shape, **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1, 2 and 5 only: build the kernels and hold them "
                         "against their plain versions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import privacy_preserve_federated_asr_tpu_torch  # noqa: F401  (fails alone)

    header()
    kern = check_kernel()
    bwd = check_bwd_kernel()
    if args.kernels_only:
        log(f"[done] phases 1, 2 and 5 passed  [{card_line()}]")
        return
    serving = serve_full_width()
    end_to_end_vs_cpu()
    training = train_full_width()
    train_step_vs_cpu()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        federated = federated_full_width(root)
        federated_round_vs_cpu()
        chain = extraction_chain(root)
        extraction_vs_cpu(chain["features"])
        native_loaders(root)
        transcribe = transcribe_phase(root)
        export = export_phase(root, transcribe["greedy"])
        sweep_svm_phase(root, chain["svm"])
        sweep = sweep_asr_phase(root)
        accum = train_accum_remat_full_width(root, training)
        accum_remat_vs_cpu()
        fl_opts = federated_options_full_width(root)
        federated_aggregators_vs_cpu()
        int8 = int8_full_width(root, training, transcribe["greedy"])
        int8_vs_cpu()
        streaming = streaming_full_width(root)
        streaming_exact(root)
        variants = variants_full_width(root)
        bands = variants_vs_cpu()
        sewd = sewd_full_width(root)
        sewd_vs_cpu()
        teacher = teacher_phase(root)
    tools_b1 = (sum(transcribe["launches"].values()) + sum(export["launches"].values())
                + sweep["b1"])
    by_dtype = {name: {dt: sum(c.get(name, {}).get(dt, 0) for c in COUNTS.values())
                       for dt in ("bfloat16", "float32")} for name in ("flash_fwd", "flash_bwd")}
    # the tallies hold the counts that each phase asserted, and the card's
    # launches of the fp32 card-vs-CPU phases besides
    e2e = ("serving, card vs CPU", "training step, card vs CPU",
           "federated round, card vs CPU", "extraction, card vs CPU",
           "grad_accum and remat, card vs CPU", "aggregators, card vs CPU",
           "int8, card vs CPU", "int8_train training step, card vs CPU",
           "streaming exactness", "cli stream-report", "variants, card vs CPU",
           "sewd, card vs CPU")
    main_b1 = (serving["launches"] + training["b1"] + federated["b1"]
               + sum(chain["launches"].values()) + tools_b1 + accum["b1"] + fl_opts["b1"]
               + int8["b1"] + streaming["b1"] + variants["b1"] + teacher["b1"])
    main_b2 = (training["b2"] + federated["b2"] + sweep["b2"] + accum["b2"]
               + fl_opts["b2"] + int8["b2"] + variants["b2"] + teacher["b2"])
    # the SEW-D paths launch neither kernel (their counts were asserted 0)
    assert not any(sum(c[k].values()) for p, c in COUNTS.items() if "sewd" in p
                   for k in ("flash_fwd", "flash_bwd")), COUNTS
    assert sum(sum(c["flash_fwd"].values()) for p, c in COUNTS.items() if p not in e2e) \
        == main_b1, (COUNTS, main_b1)
    assert sum(sum(c["flash_bwd"].values()) for p, c in COUNTS.items() if p not in e2e) \
        == main_b2, (COUNTS, main_b2)
    t = kern["times"][(TS[-1], "bfloat16")]
    tb = bwd["times"][(*BWD_SHAPES[0], "bfloat16")]
    line = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "privacy_preserve_federated_asr_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "privacy_preserve_federated_asr_tpu/ops/attention.py:101",
        "launches": sum(by_dtype["flash_fwd"].values()),
        "launches_by_dtype": by_dtype["flash_fwd"],
        "max_abs_err": max(kern["max_abs_err"], serving["served_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "times": [_shape_times(kern["times"][(ts, dt)], B=B, T=ts, dtype=dt, rate=0.0,
                               lse=False) for dt in ("bfloat16", "float32") for ts in TS]
        + [_shape_times(bwd["fwd_train"], B=BWD_SHAPES[0][0], T=BWD_SHAPES[0][1],
                        dtype="bfloat16", rate=TRAIN_RATE, lse=True)],
    }, {
        "name": "flash_bwd",
        "route": "cuda",
        "source": "privacy_preserve_federated_asr_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "privacy_preserve_federated_asr_tpu/ops/attention.py:142",
        "launches": sum(by_dtype["flash_bwd"].values()),
        "launches_by_dtype": by_dtype["flash_bwd"],
        "max_abs_err": bwd["max_abs_err"],
        "ms": tb["ms"], "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
        "times": [_shape_times(bwd["times"][(bb, ts, dt)], B=bb, T=ts, dtype=dt,
                               rate=TRAIN_RATE)
                  for dt in ("bfloat16", "float32") for bb, ts in BWD_SHAPES],
    }]}
    for name in ("flash_fwd", "flash_bwd"):
        log(f"[kernels] {name} launches by dtype {by_dtype[name]}; by phase "
            + "; ".join(f"{p} {c[name]}" for p, c in COUNTS.items() if any(c[name].values())))
    log(f"[kernels] times: flash_fwd at B={B} T={TS[-1]} bf16, flash_bwd at "
        f"B={BWD_SHAPES[0][0]} T={BWD_SHAPES[0][1]} bf16 rate {TRAIN_RATE}; each kernel's "
        f"\"times\" at every main-path shape in both dtypes (per stage (B1, B2) in cli "
        f"federated: {federated['stages']}); fp32 bounds are 3xTF32 on the tensor cores")
    log(f"[variants] step ms {variants['step_ms']}, idle share {variants['idle']}; FSM / "
        f"single-toggle mask elements in the near-tie band, card vs CPU: {bands}; SEW-D "
        f"step {sewd['train']}, batch forward {sewd['forward']}  [{card_line()}]")
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
