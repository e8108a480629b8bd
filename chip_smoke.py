#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Drives the port's serving path (privacy_preserve_federated_asr_tpu_torch)
and holds its hand-written kernel against the plain version. It imports
nothing of JAX or of the JAX package. Phases, in order; any failure raises
and ends the run with a non-zero exit:

1. header: the card (nvidia-smi), torch and CUDA versions, and the nvcc
   build of the kernel in csrc/;
2. kernel B1 (csrc/flash_fwd.cu) against ``attention_ref`` at the serving
   shapes (B=8, H=16, D=64; T=249 and T=1499; bf16 and fp32; mixed key
   lengths and one row with every key masked; dropout 0.1), and its time
   beside the plain version's and PyTorch's SDPA (a yardstick only: the
   port never calls SDPA);
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
5. one JSON line listing each kernel (launches on the main path, error
   against the plain version, times and bound), the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
B, H, D = 8, 16, 64        # serving batch, heads, head dim
TS = (249, 1499)           # frames of the 5 s and 30 s buckets
LAYERS = 24


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    cuda_build.load("flash_fwd")
    log(f"[build] flash_fwd: nvcc and load in {time.perf_counter() - t0:.1f} s")
    for line in cuda_build.build_logs.get("flash_fwd", "(already built)").splitlines():
        if "registers" in line or "spill" in line or "built" in line:
            log(f"[build]   {line.strip()}")


# ---------------------------------------------------------------------------
# 2. kernel B1 against its plain version
# ---------------------------------------------------------------------------

def _qkv(t: int, dtype: torch.dtype, seed: int):
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn((B, t, H, D), generator=g, device="cuda").to(dtype)
            for _ in range(3)]


def _mask(lengths) -> torch.Tensor:
    t = max(lengths)
    lens = torch.tensor(lengths, device="cuda")
    return (torch.arange(t, device="cuda")[None] < lens[:, None]).to(torch.int32)


# bf16: about two bf16 ulps of the output (rtol) over a floor well under
# the ~0.04 magnitude of a full-length row's output at T=1499
TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=4e-3),
       torch.float32: dict(rtol=0.0, atol=1e-4)}


def check_kernel() -> dict:
    from privacy_preserve_federated_asr_tpu_torch.ops.attention import (
        attention_ref, flash_attention_fwd)

    worst = 0.0
    for t in TS:
        # mixed key lengths; row 6 has every key masked
        mask = _mask([t, t - 17, t // 2, t // 3 + 1, 1, t - 1, 0, t // 4 + 5])
        has_key = mask.sum(1) > 0
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _qkv(t, dtype, seed=t)
            for rate, seed in ((0.0, 0), (0.1, 20240917)):
                got = flash_attention_fwd(q, k, v, mask, rate, seed).float()
                ref = attention_ref(q, k, v, mask, rate, seed).float()
                torch.cuda.synchronize()
                assert torch.isfinite(got).all(), "kernel output not finite"
                err = (got[has_key] - ref[has_key]).abs().max().item()
                torch.testing.assert_close(got[has_key], ref[has_key], **TOL[dtype])
                worst = max(worst, err)
                log(f"[kernel] T={t} {str(dtype)[6:]} rate={rate}: max|err| "
                    f"{err:.3e} (valid rows), all-masked row finite")

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

    def recording(q, k, v, key_mask):
        out = mha(q, k, v, key_mask)
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
    return {"device_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3,
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import privacy_preserve_federated_asr_tpu_torch  # noqa: F401  (fails alone)

    header()
    kern = check_kernel()
    serving = serve_full_width()
    end_to_end_vs_cpu()
    t = kern["times"][(TS[-1], "bfloat16")]
    line = {"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "privacy_preserve_federated_asr_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "privacy_preserve_federated_asr_tpu/ops/attention.py:101",
        "launches": serving["launches"],
        "max_abs_err": max(kern["max_abs_err"], serving["served_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }]}
    print(json.dumps(line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
