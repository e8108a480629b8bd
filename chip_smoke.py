#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py                  # every phase (the contract's run)
    python3 chip_smoke.py --kernels-only   # phases 1, 2 and 5: build and check

Drives the port's serving path, its stage-0 training path, its federated
3-stage pipeline and its system-run chain (extract, svm, detail-wer,
feat-scoring; privacy_preserve_federated_asr_tpu_torch) and holds its
hand-written kernels against their plain versions. It imports nothing of JAX or of the
JAX package. Phases, in order; any failure raises and ends the run with a
non-zero exit:

1. header: the card (nvidia-smi), torch and CUDA versions, and the nvcc
   builds of the kernels in csrc/ (one nvcc process per source, together);
2. kernel B1 (csrc/flash_fwd.cu) against ``attention_ref`` at the serving
   shapes (B=8, H=16, D=64; T=249 and T=1499, and the ragged T=1, 63, 65,
   129; bf16 and fp32; mixed key lengths and one row with every key masked;
   dropout 0 and 0.1; q/k/v as separate tensors and as strided views of one
   [B, T, 3*H*64] projection), and its time beside the plain version's and
   PyTorch's SDPA (a yardstick only: the port never calls SDPA);
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
   every call made twice and held bit-equal (B2 is deterministic), its time
   beside the plain version's, the bound and SDPA's backward; B1's time at
   the training shape with dropout 0.1;
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
12. one JSON line listing each kernel (launches on the main paths, error
   against the plain version, times and bound, and under "times" the same
   numbers at each main-path shape), the card's name and power limit, and
   last ``{"ok": true, "device": {...}}``.

``--kernels-only`` runs phases 1, 2 and 5 and prints neither of the last
two lines.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
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
PEAK_F32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
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


# ---------------------------------------------------------------------------
# 1. header and build
# ---------------------------------------------------------------------------

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
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_logs.get(name, "(already built)").splitlines():
            if "registers" in line or "spill" in line or "built" in line:
                log(f"[build]   {name}: {line.strip()}")


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
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
            bound_ops, bound_bytes = flops / peak, nbytes / PEAK_BYTES
            row["bound_ms"] = max(bound_ops, bound_bytes) * 1e3
            row["bound_by"] = "operations" if bound_ops >= bound_bytes else "bytes"
            times[(t, str(dtype)[6:])] = row
            log(f"[kernel-time] T={t} {str(dtype)[6:]}: kernel {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
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
        flash_attention_fwd.launches = 0   # counts of the main path's run
        f0 = engine.forwards
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(audios)) as pool:
            replies = list(pool.map(lambda ia: _post(url, ia[1], kinds[ia[0] % 3]),
                                    enumerate(audios)))
        wall = time.perf_counter() - t0
        launches, forwards = flash_attention_fwd.launches, engine.forwards - f0
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


def _bound(flops: float, nbytes: float, dtype: torch.dtype) -> tuple[float, str]:
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    ops_s, bytes_s = flops / peak, nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


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
                f"({row['bound_by']})  [{card_line()}]")

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
            flash_attention_fwd.launches = flash_attention_bwd.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                tr = cli.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
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

def train_step_vs_cpu() -> None:
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
        feat_proj_dropout=0.0, attention_dropout=TRAIN_RATE), stage=0)
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
    log(f"[train-e2e] frontend card vs CPU max|err|/max|ref| {fe_err:.2e}; per step "
        f"(loss, grad norm) card {[(m['loss'], m['grad_norm']) for m in m_gpu]}, CPU "
        f"{[(m['loss'], m['grad_norm']) for m in m_cpu]}, card on its own frontend "
        f"{[(m['loss'], m['grad_norm']) for m in m_own]}")
    # loss rtol 1e-4; grad norm rtol 1e-3: the CTC posterior of this
    # near-uniform random model moves by ~1e-4 with the exp/log of another
    # library (tests/test_torch_losses.py::test_ctc_long_sequence_matches_jax)
    for a, c in zip(m_gpu, m_cpu):
        for k, rtol in (("loss", 1e-4), ("grad_norm", 1e-3)):
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
        off += int((diff > 1e-2 * lr).sum())
    frac = off / sum(v.numel() for v in p_cpu.values())
    assert frac <= 5e-3, frac
    log(f"[train-e2e] 4-layer fp32 stage 0, attention dropout {TRAIN_RATE}, {n_steps} "
        f"AdamW steps at lr {lr}: card vs CPU loss {m_gpu[-1]['loss']:.4f} / "
        f"{m_cpu[-1]['loss']:.4f}, grad norm {m_gpu[-1]['grad_norm']:.4f} / "
        f"{m_cpu[-1]['grad_norm']:.4f} (rtol 1e-4, 1e-3); params max|diff| {worst:.2e}, "
        f"{frac:.2e} of elements beyond 1e-2 lr (limit 5e-3)")


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
        flash_attention_fwd.launches = flash_attention_bwd.launches = 0
        eng, out, wall = _run_cli(root, ["federated", *FL_ARGS, "--epochs", "1",
                                         "-fl_st", "0", "-model_out", "out/fl"])
        ev = _last_json(out)
        b1, b2 = flash_attention_fwd.launches, flash_attention_bwd.launches
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
    for dev in ("cuda", "cpu"):
        eng = FederatedEngine(cfg, FederatedConfig(
            num_rounds=1, local_ep=1, batch_size=2, eval_batch_size=2, learning_rate=lr,
            log_dir="."), clients, [], None, tok, sd, device=dev)
        params = eng.run_rounds(stage=1, num_rounds=1)
        row = [r for r in eng.logger.history if "local_steps" in r][0]
        assert row["phase"] == "res_h" and row["dead_step_frac"] > 0, row
        out[dev] = (row, {k: v.cpu() for k, v in params.items()})
        del eng
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
        flash_attention_fwd.launches = 0   # counts of the main path's run
        _, _, wall = _run_cli(root, [*EXTRACT_ARGS, "--compute_dtype", dtype,
                                     "--csv_out_dir", f"res_{dtype}"])
        launches = flash_attention_fwd.launches
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

    rows = {dev: extract_embeddings(cfg, sd, exs, tok, batch_size=2, device=dev,
                                    gumbel_noise=noise) for dev in ("cuda", "cpu")}
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
        federated = federated_full_width(Path(tmp))
        federated_round_vs_cpu()
        chain = extraction_chain(Path(tmp))
    extraction_vs_cpu(chain["features"])
    t = kern["times"][(TS[-1], "bfloat16")]
    tb = bwd["times"][(*BWD_SHAPES[0], "bfloat16")]
    line = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "privacy_preserve_federated_asr_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "privacy_preserve_federated_asr_tpu/ops/attention.py:101",
        "launches": (serving["launches"] + training["b1"] + federated["b1"]
                     + sum(chain["launches"].values())),
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
        "launches": training["b2"] + federated["b2"],
        "max_abs_err": bwd["max_abs_err"],
        "ms": tb["ms"], "plain_ms": tb["plain_ms"], "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"], "library_ms": tb["library_ms"],
        "times": [_shape_times(bwd["times"][(bb, ts, "bfloat16")], B=bb, T=ts,
                               dtype="bfloat16", rate=TRAIN_RATE) for bb, ts in BWD_SHAPES],
    }]}
    log(f"[kernels] flash_fwd launches: serving {serving['launches']} + training "
        f"{training['b1']} + federated {federated['b1']} + extraction "
        f"{chain['launches']}; times at B={B} T={TS[-1]} bf16. "
        f"flash_bwd: training {training['b2']} + federated {federated['b2']} (per stage "
        f"(B1, B2): {federated['stages']}); times at B={BWD_SHAPES[0][0]} "
        f"T={BWD_SHAPES[0][1]} bf16 rate {TRAIN_RATE}; each kernel's \"times\" at every "
        f"main-path shape (B1 in fp32 too: extraction's precision)")
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
