"""Whisper teacher model (encoder-decoder ASR) in PyTorch (the port's
``models/whisper.py``).

The reference transcribes the unlabeled ADReSSo training clips offline with
``whisper.load_model('large-v2').transcribe(file, language='en')``
(reference: federated/src/federated_main.py:29-68 ``TeacherStudentLearning``).
This module is the JAX package's flax Whisper in torch:

  * the log-mel frontend (reflect-padded STFT -> slaney mel filterbank ->
    log10 -> whisper's max-8 clamp and /4 scaling), the filterbank computed;
  * a pre-norm transformer encoder over the 2-conv downsampled mel frames;
  * a decoder with a preallocated self-attention KV cache (per-row
    ``cache_start`` masking for left-padded conditioning prompts);
  * :func:`decode_with_stats`, the batched greedy / temperature decode with
    whisper's timestamp rules and ``avg_logprob`` as the JAX package keeps
    them.

Modules keep the HF ``WhisperForConditionalGeneration`` names, so an HF
``pytorch_model.bin`` loads with ``strict=True`` (:func:`port_hf_whisper`;
``proj_out`` is tied to ``embed_tokens``, as in HF and as the JAX package
computes its logits). Attention runs as plain torch ops (the JAX package's
XLA einsums: scores in fp32 with a ``-1e9`` mask bias, q scaled by
``head_dim**-0.5``, ``k_proj`` without bias); neither flash kernel is on
this path.

Three things differ from the JAX decode and change no value:

  * the JAX decode recomputes every layer's cross-attention K/V from the
    encoder output at each step; here they are projected once per decode;
  * the forced prompt (and a conditioning prompt) is fed as one causal
    prefill instead of one cached step per token, and the loop stops once
    every row has emitted EOT (the ids come out EOT-padded to the same
    width, the statistics unchanged);
  * on the card the single-token step is one CUDA graph per decode
    (:func:`_single_token_step`).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .backbone import Conv1d, Linear, _layer_norm


@dataclasses.dataclass(frozen=True)
class WhisperConfigT:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 1280
    encoder_layers: int = 32
    decoder_layers: int = 32
    num_heads: int = 20
    ffn_dim: int = 5120
    max_source_positions: int = 1500
    max_target_positions: int = 448
    # special tokens (multilingual vocab; large-v2 defaults)
    sot_token: int = 50258          # <|startoftranscript|>
    eot_token: int = 50257          # <|endoftext|>
    language_token: int = 50259     # <|en|>
    task_token: int = 50359         # <|transcribe|>
    no_timestamps_token: int = 50363
    prev_token: int = 50361         # <|startofprev|> (window conditioning)
    # first timestamp token id (<|0.00|>); None = no_timestamps_token + 1
    # (whisper's vocab layout). Timestamp token k encodes time
    # (k - timestamp_begin) * 0.02 s = one encoder frame (2 mel frames of
    # HOP samples), see ``timestamp_stride_samples``.
    timestamp_begin_token: int | None = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def timestamp_begin(self) -> int:
        return (self.timestamp_begin_token if self.timestamp_begin_token is not None
                else self.no_timestamps_token + 1)

    @property
    def timestamp_stride_samples(self) -> int:
        """Waveform samples per timestamp unit (whisper's time_precision of
        0.02 s at 16 kHz: one encoder frame = 2 mel frames of HOP)."""
        return 2 * HOP

    @classmethod
    def large_v2(cls) -> "WhisperConfigT":
        return cls()

    @classmethod
    def tiny_for_tests(cls, vocab_size: int = 64) -> "WhisperConfigT":
        return cls(vocab_size=vocab_size, num_mel_bins=8, d_model=32,
                   encoder_layers=2, decoder_layers=2, num_heads=4, ffn_dim=64,
                   max_source_positions=64, max_target_positions=24,
                   sot_token=1, eot_token=0, language_token=2, task_token=3,
                   no_timestamps_token=4, prev_token=5)

    @classmethod
    def from_hf_config(cls, hf) -> "WhisperConfigT":
        """Build from an HF ``WhisperConfig`` (object or dict): the shape
        fields come from the config; the ``<|en|>``/``<|transcribe|>``/
        ``<|notimestamps|>`` prompt tokens follow whisper's multilingual
        vocab layout (eot + 1/ + 102/ + 106), the reference's
        ``language='en'`` transcription options."""
        get = hf.get if isinstance(hf, dict) else lambda k, d=None: getattr(hf, k, d)
        eot = int(get("eos_token_id", 50257))
        sot = int(get("decoder_start_token_id", eot + 1))
        return cls(
            vocab_size=int(get("vocab_size", 51865)),
            num_mel_bins=int(get("num_mel_bins", 80)),
            d_model=int(get("d_model", 1280)),
            encoder_layers=int(get("encoder_layers", 32)),
            decoder_layers=int(get("decoder_layers", 32)),
            num_heads=int(get("encoder_attention_heads", 20)),
            ffn_dim=int(get("encoder_ffn_dim", 5120)),
            max_source_positions=int(get("max_source_positions", 1500)),
            max_target_positions=int(get("max_target_positions", 448)),
            sot_token=sot, eot_token=eot,
            language_token=sot + 1,         # <|en|> is the first language id
            task_token=eot + 102,           # <|transcribe|>
            no_timestamps_token=eot + 106,  # <|notimestamps|>
            prev_token=eot + 104,           # <|startofprev|>
        )

    def forced_tokens(self, timestamps: bool = False) -> list[int]:
        """The reference's ``language='en'`` transcription prompt. With
        ``timestamps`` the ``<|notimestamps|>`` token is omitted (upstream
        ``whisper.transcribe``'s default) and the decode applies the
        timestamp rules."""
        toks = [self.sot_token, self.language_token, self.task_token]
        return toks if timestamps else toks + [self.no_timestamps_token]


# ---------------------------------------------------------------------------
# log-mel frontend (whisper.audio.log_mel_spectrogram semantics)

N_FFT = 400
HOP = 160
SAMPLE_RATE = 16000
CHUNK_SAMPLES = 30 * SAMPLE_RATE  # whisper's fixed 30 s window


def slaney_mel_filters(num_mel: int, n_fft: int = N_FFT, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Triangular slaney-scale/slaney-norm mel filterbank
    [num_freq_bins, num_mel]: the filterbank whisper ships precomputed."""
    fmax = sr / 2.0
    log_step = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / log_step,
                        3.0 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)), 200.0 * m / 3.0)

    freqs = np.fft.rfftfreq(n_fft, d=1.0 / sr)             # [n_fft//2+1]
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), num_mel + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[None, :] - freqs[:, None]              # [F, num_mel+2]
    lower = -ramps[:, :-2] / fdiff[None, :-1]
    upper = ramps[:, 2:] / fdiff[None, 1:]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:] - mel_pts[:-2])             # slaney normalization
    return (fb * enorm[None, :]).astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, num_mel: int) -> torch.Tensor:
    """[B, N] waveform -> [B, N // HOP, num_mel] log-mel features (3000
    frames for a 30 s window), on ``audio``'s device.

    Whisper's: hann(400), hop 160, center/reflect pad, power spectrum, mel,
    log10 clamp 1e-10, per-sample ``max(x, max-8)``, ``(x+4)/4``."""
    x = F.pad(audio.float()[:, None, :], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = x.unfold(1, N_FFT, HOP)                       # [B, T, N_FFT]
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float32,
                               device=audio.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, :-1, :]  # drop the last frame
    fb = torch.from_numpy(slaney_mel_filters(num_mel)).to(audio.device)
    log_spec = torch.log10(torch.clamp(power @ fb, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(audio: np.ndarray, length: int = CHUNK_SAMPLES) -> np.ndarray:
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
    return np.pad(audio, pad)


def chunk_samples(cfg: WhisperConfigT) -> int:
    """The model's decode-window length in waveform samples: the encoder
    consumes ``max_source_positions`` frames after the 2x conv downsample,
    i.e. ``max_source_positions * 2`` mel frames of ``HOP`` samples each
    (30 s for the real models; cfg-proportional for test-size configs)."""
    return cfg.max_source_positions * 2 * HOP


# ---------------------------------------------------------------------------
# model (HF WhisperForConditionalGeneration names)

NEG_BIAS = -1e9


class WhisperAttention(nn.Module):
    """HF WhisperAttention: q scaled by head_dim**-0.5, ``k_proj`` has no
    bias; scores and softmax in fp32."""

    def __init__(self, cfg: WhisperConfigT, dtype: torch.dtype):
        super().__init__()
        d, kw = cfg.d_model, dict(dtype=dtype, param_dtype=torch.float32)
        self.h, self.hd, self.dtype = cfg.num_heads, cfg.head_dim, dtype
        self.q_proj = Linear(d, d, **kw)
        self.k_proj = Linear(d, d, bias=False, **kw)
        self.v_proj = Linear(d, d, **kw)
        self.out_proj = Linear(d, d, **kw)

    def heads(self, x: torch.Tensor) -> torch.Tensor:   # [B, T, D] -> [B, H, T, hd]
        return x.unflatten(-1, (self.h, self.hd)).transpose(1, 2)

    def project_kv(self, src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.heads(self.k_proj(src)), self.heads(self.v_proj(src))

    def attend(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
        q = self.heads(self.q_proj(x) * self.hd ** -0.5)
        scores = q.float() @ k.float().transpose(-1, -2)
        if bias is not None:
            scores = scores + bias
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        return self.out_proj((probs @ v).transpose(1, 2).flatten(2))


class _Layer(nn.Module):
    """Shared FFN half of the encoder and decoder layers (HF ``fc1``/``fc2``,
    exact GELU)."""

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        h = _layer_norm(self.final_layer_norm, x, self.dtype)
        return x + self.fc2(F.gelu(self.fc1(h)))

    def _init_ffn(self, cfg: WhisperConfigT, dtype: torch.dtype) -> None:
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.dtype = dtype
        self.fc1 = Linear(cfg.d_model, cfg.ffn_dim, **kw)
        self.fc2 = Linear(cfg.ffn_dim, cfg.d_model, **kw)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)


class WhisperEncoderLayer(_Layer):
    def __init__(self, cfg: WhisperConfigT, dtype: torch.dtype):
        super().__init__()
        self.self_attn = WhisperAttention(cfg, dtype)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self._init_ffn(cfg, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _layer_norm(self.self_attn_layer_norm, x, self.dtype)
        x = x + self.self_attn.attend(h, *self.self_attn.project_kv(h))
        return self._ffn(x)


class WhisperEncoder(nn.Module):
    """Mel features [B, T_mel, num_mel] -> encoder states [B, T_mel/2, D]."""

    def __init__(self, cfg: WhisperConfigT, dtype: torch.dtype):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=torch.float32)
        self.dtype = dtype
        self.conv1 = Conv1d(cfg.num_mel_bins, cfg.d_model, 3, padding=1, **kw)
        self.conv2 = Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1, **kw)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, cfg.d_model)
        self.layers = nn.ModuleList(WhisperEncoderLayer(cfg, dtype)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.conv1(mel.transpose(1, 2)))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.embed_positions.weight[: x.shape[1]].to(self.dtype)
        for layer in self.layers:
            x = layer(x)
        return _layer_norm(self.layer_norm, x, self.dtype)


class WhisperDecoderLayer(_Layer):
    def __init__(self, cfg: WhisperConfigT, dtype: torch.dtype):
        super().__init__()
        self.self_attn = WhisperAttention(cfg, dtype)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.encoder_attn = WhisperAttention(cfg, dtype)
        self.encoder_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self._init_ffn(cfg, dtype)

    def forward(self, x: torch.Tensor, self_kv: tuple[torch.Tensor, torch.Tensor],
                cross_kv: tuple[torch.Tensor, torch.Tensor],
                bias: torch.Tensor | None) -> torch.Tensor:
        h = _layer_norm(self.self_attn_layer_norm, x, self.dtype)
        x = x + self.self_attn.attend(h, *self_kv(h), bias)
        h = _layer_norm(self.encoder_attn_layer_norm, x, self.dtype)
        x = x + self.encoder_attn.attend(h, *cross_kv)
        return self._ffn(x)


class KVCache:
    """The decoder's self-attention K/V, preallocated ``[B, H, L, hd]`` per
    layer (L = max_target_positions): :meth:`writer` writes a block of
    slots from a host index and returns the keys and values up to its end;
    :meth:`step_writer` writes one slot from a device index and returns all
    L (static shapes, for the single-token step's CUDA graph)."""

    def __init__(self, cfg: WhisperConfigT, b: int, dtype: torch.dtype, device):
        shape = (cfg.decoder_layers, b, cfg.num_heads, cfg.max_target_positions, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)

    def writer(self, layer: int, attn: WhisperAttention, slot: int):
        def kv(h):
            k, v = attn.project_kv(h)
            end = slot + k.shape[2]
            self.k[layer, :, :, slot:end] = k
            self.v[layer, :, :, slot:end] = v
            return self.k[layer, :, :, :end], self.v[layer, :, :, :end]
        return kv

    def step_writer(self, layer: int, attn: WhisperAttention, slot: torch.Tensor):
        def kv(h):
            k, v = attn.project_kv(h)
            self.k[layer].index_copy_(2, slot, k)
            self.v[layer].index_copy_(2, slot, v)
            return self.k[layer], self.v[layer]
        return kv


def _single_token_step(dec: "WhisperDecoder", cross, cache: KVCache,
                       start_bias: torch.Tensor | None, b: int, first_slot: int):
    """``run(tok [B, 1], pos [B, 1], slot) -> fp32 logits [B, V]``: one
    decoder step over all L cache slots, those past ``slot`` (and before a
    row's prompt start) masked with the ``-1e9`` bias, as the JAX decode
    step attends. The shapes never change, so on the card the step is
    captured once per decode as a CUDA graph and replayed (its ~30 kernels
    per layer launch from the device, not one by one from Python); the
    capture's warm-up writes slot ``first_slot``, which the first real step
    rewrites. The returned logits are the graph's buffer, overwritten by
    the next step."""
    dev = cache.k.device
    static = {"tok": torch.zeros((b, 1), dtype=torch.long, device=dev),
              "pos": torch.zeros((b, 1), dtype=torch.long, device=dev),
              "slot": torch.full((1,), first_slot, dtype=torch.long, device=dev)}
    keys = torch.arange(cache.k.shape[3], device=dev)

    def step():
        bias = torch.where(keys <= static["slot"], 0.0, NEG_BIAS)
        if start_bias is not None:
            bias = bias + start_bias
        return dec(static["tok"], static["pos"], cross,
                   lambda i, attn: cache.step_writer(i, attn, static["slot"]), bias)[:, -1]

    out = None
    if dev.type == "cuda":
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()

    def run(tok, pos, slot: int) -> torch.Tensor:
        static["tok"].copy_(tok)
        static["pos"].copy_(pos)
        static["slot"].fill_(slot)
        if out is None:
            return step()
        graph.replay()
        return out

    return run


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfigT, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, cfg.d_model)
        self.layers = nn.ModuleList(WhisperDecoderLayer(cfg, dtype)
                                    for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)

    def cross_kv(self, enc: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Every layer's cross-attention K/V of the encoder output, once,
        stored contiguous as [B, H, S, hd]: the heads view of a projection
        cannot be batched as is, and each step would copy it."""
        return [tuple(t.contiguous() for t in layer.encoder_attn.project_kv(enc))
                for layer in self.layers]

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor, cross, self_kvs,
                bias: torch.Tensor | None) -> torch.Tensor:
        """tokens / positions [B, t] -> fp32 logits [B, t, V]; ``self_kvs``
        gives each layer's self-attention K/V function (:class:`KVCache`'s
        writer, or a plain projection for a full teacher-forced pass)."""
        positions = positions.clamp(0, self.cfg.max_target_positions - 1)
        x = (self.embed_tokens(tokens).to(self.dtype)
             + self.embed_positions(positions).to(self.dtype))
        for i, layer in enumerate(self.layers):
            x = layer(x, self_kvs(i, layer.self_attn), cross[i], bias)
        x = self.layer_norm(x.float())
        # tied output projection (HF proj_out.weight == embed_tokens.weight)
        return x @ self.embed_tokens.weight.float().T


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfigT, dtype: torch.dtype):
        super().__init__()
        self.encoder = WhisperEncoder(cfg, dtype)
        self.decoder = WhisperDecoder(cfg, dtype)


class WhisperForConditionalGeneration(nn.Module):
    """HF's module tree (``model.encoder``, ``model.decoder``, ``proj_out``
    tied to ``model.decoder.embed_tokens``) in the compute ``dtype`` with
    fp32 parameters."""

    def __init__(self, cfg: WhisperConfigT, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.model = WhisperModel(cfg, dtype)
        self.proj_out = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False)
        self.tie_weights()

    def tie_weights(self) -> None:
        self.proj_out.weight = self.model.decoder.embed_tokens.weight

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        return self.model.encoder(mel)

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced fp32 logits [B, t, V] of ``tokens`` (causal, no
        cache; positions 0..t-1)."""
        dec = self.model.decoder
        t = tokens.shape[1]
        pos = torch.arange(t, device=tokens.device)
        causal = torch.where(pos[None, :] <= pos[:, None], 0.0, NEG_BIAS).to(tokens.device)
        return dec(tokens, pos.expand(tokens.shape[0], t), dec.cross_kv(self.encode(mel)),
                   lambda i, attn: attn.project_kv, causal)


def init_whisper_state_dict(cfg: WhisperConfigT,
                            generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Seeded random weights under HF names in fp32 on
    ``generator.device``: normal(0, 0.02) matrices, convs and embeddings
    (HF's ``init_std``), zero biases, unit LayerNorm scales."""
    dev = generator.device
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in WhisperForConditionalGeneration(cfg).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if name == "proj_out.weight":
            continue
        if name.endswith("bias"):
            sd[name] = torch.zeros(shape, device=dev)
        elif len(shape) == 1:
            sd[name] = torch.ones(shape, device=dev)
        else:
            sd[name] = torch.empty(shape, device=dev).normal_(0.0, 0.02, generator=generator)
    return sd


def port_hf_whisper(sd: Mapping[str, torch.Tensor], cfg: WhisperConfigT,
                    device: str | torch.device = "cuda",
                    dtype: torch.dtype = torch.float32) -> WhisperForConditionalGeneration:
    """An HF ``WhisperForConditionalGeneration`` state dict -> the module on
    ``device`` (``strict=True``). ``proj_out.weight`` is tied to
    ``model.decoder.embed_tokens.weight`` whether or not the file holds it,
    as the JAX package computes its logits from the embedding."""
    sd = {k: torch.as_tensor(v).to(device, torch.float32) for k, v in sd.items()}
    sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
    with torch.device("meta"):
        model = WhisperForConditionalGeneration(cfg, dtype)
    model.load_state_dict(sd, strict=True, assign=True)
    model.tie_weights()
    return model.eval()


def state_dict_from_flax_whisper(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX package's flax Whisper params (numpy leaves) -> an HF-named
    state dict (the inverse of its ``port_hf_whisper``; for the tests)."""
    sd = {}

    def put(key, w, kind=None):
        w = np.asarray(w, np.float32)
        if kind == "dense":
            w = w.T
        elif kind == "conv":
            w = w.transpose(2, 1, 0)
        sd[key] = torch.from_numpy(np.ascontiguousarray(w))

    def tree(node, prefix):
        for name, sub in node.items():
            if name in ("embed_positions", "embed_tokens"):
                put(f"{prefix}.{name}.weight", sub)
            elif name.startswith("layers_"):
                tree(sub, f"{prefix}.layers.{name.split('_')[1]}")
            elif name == "ffn":
                tree(sub, prefix)
            elif "scale" in sub:
                put(f"{prefix}.{name}.weight", sub["scale"])
                put(f"{prefix}.{name}.bias", sub["bias"])
            elif "kernel" in sub:
                conv = np.asarray(sub["kernel"]).ndim == 3
                put(f"{prefix}.{name}.weight", sub["kernel"], "conv" if conv else "dense")
                if "bias" in sub:
                    put(f"{prefix}.{name}.bias", sub["bias"])
            else:
                tree(sub, f"{prefix}.{name}")

    tree({"encoder": params["encoder"], "decoder": params["decoder"]}, "model")
    return sd


# ---------------------------------------------------------------------------
# decoding


@torch.no_grad()
def decode_with_stats(
    cfg: WhisperConfigT,
    model: WhisperForConditionalGeneration,
    mel: torch.Tensor,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    max_new_tokens: int | None = None,
    prompt_ids: torch.Tensor | None = None,
    prompt_lens: torch.Tensor | None = None,
    timestamps: bool = False,
    max_initial_timestamp: float | None = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched transcription with decode statistics: mel [B, T_mel, M] ->
    (token ids [B, max_target_positions - forced - prompt slots] int64,
    EOT-padded; avg_logprob [B] fp32), on ``mel``'s device.

    Temperature 0 = greedy argmax; > 0 samples ``logits / temperature``
    (Gumbel-max over ``generator``'s draws). ``avg_logprob`` is whisper's:
    the selected tokens' log-probs (the EOT step included) over their count.
    ``prompt_ids`` [B, P] + ``prompt_lens`` [B]: right-aligned
    ``<|startofprev|>`` conditioning prompts; padding cache slots are masked
    per row and position ids start at 0 at each row's first real token.
    ``timestamps`` applies upstream ``ApplyTimestampRules`` at every step
    (the first token a timestamp of at most ``max_initial_timestamp``
    seconds, timestamps in pairs and non-decreasing, a timestamp forced
    when their total probability beats the best text token)."""
    c = cfg
    dev = mel.device
    prompt = c.forced_tokens(timestamps)
    n_prompt = len(prompt)
    n_prev = 0 if prompt_ids is None else int(prompt_ids.shape[1])
    total = c.max_target_positions
    budget = total - n_prompt - n_prev
    max_new_tokens = budget if max_new_tokens is None else min(max_new_tokens, budget)
    if max_new_tokens < 1:
        raise ValueError(f"no token budget left: max_target_positions={total} - "
                         f"{n_prompt} forced - {n_prev} prompt slots < 1")
    b = mel.shape[0]
    dec = model.model.decoder
    cross = dec.cross_kv(model.encode(mel))
    cache = KVCache(c, b, model.dtype, dev)

    # prefill: conditioning prompt (slots 0..n_prev-1) + forced tokens
    forced = torch.tensor(prompt, device=dev).expand(b, n_prompt)
    slots = torch.arange(n_prev + n_prompt, device=dev)
    if prompt_ids is None:
        plen = torch.zeros(b, dtype=torch.long, device=dev)
        toks, start_bias = forced, None
        positions = slots.expand(b, -1)
    else:
        plen = torch.as_tensor(prompt_lens, device=dev).long()
        start = n_prev - plen
        toks = torch.cat([torch.as_tensor(prompt_ids, device=dev).long(), forced], dim=1)
        positions = (slots[None, :] - start[:, None]).clamp_min(0)
        keys = torch.arange(total, device=dev)
        start_bias = torch.where(keys[None, :] >= start[:, None], 0.0, NEG_BIAS)[:, None, None, :]
    n0 = n_prev + n_prompt
    causal = torch.where(slots[None, :] <= slots[:, None], 0.0, NEG_BIAS)
    bias = causal if start_bias is None else causal + start_bias[..., :n0]
    logits = dec(toks, positions, cross, lambda i, attn: cache.writer(i, attn, 0), bias)[:, -1]

    tb = c.timestamp_begin
    ids_row = torch.arange(c.vocab_size, device=dev)
    is_ts_tok = ids_row >= tb
    neg = torch.tensor(-1e30, device=dev)
    cap = (None if max_initial_timestamp is None else tb + int(round(
        max_initial_timestamp * SAMPLE_RATE / c.timestamp_stride_samples)))

    def ts_filter(lg, st, first_step):
        """Upstream whisper ApplyTimestampRules (the JAX ``ts_filter``),
        vectorized per row; ``st`` = (prev_was_ts, prevprev_was_ts,
        last_ts_id), prevprev counting as a timestamp while fewer than two
        tokens were sampled."""
        prev_ts, prevprev_ts, last_ts = st
        lg = torch.where(ids_row[None, :] == c.no_timestamps_token, neg, lg.float())
        after_pair = prev_ts & prevprev_ts   # pair closed: text must follow
        mid_pair = prev_ts & ~prevprev_ts    # segment end: no text next
        lg = torch.where(after_pair[:, None] & is_ts_tok[None, :], neg, lg)
        # upstream masks exactly scores[:, :eot] here
        lg = torch.where(mid_pair[:, None] & (ids_row < c.eot_token)[None, :], neg, lg)
        floor = torch.where(mid_pair, last_ts, last_ts + 1)
        lg = torch.where(is_ts_tok[None, :] & (ids_row[None, :] < floor[:, None]), neg, lg)
        if first_step:
            lg = torch.where(~is_ts_tok[None, :], neg, lg)
            if cap is not None:
                lg = torch.where(ids_row[None, :] > cap, neg, lg)
        lp = torch.log_softmax(lg, dim=-1)
        force_ts = torch.logsumexp(lp[:, tb:], dim=-1) > lp[:, :tb].amax(dim=-1)
        return torch.where(force_ts[:, None] & ~is_ts_tok[None, :], neg, lg)

    def select(lg, st=None, first_step=False):
        if timestamps:
            lg = ts_filter(lg, st, first_step)
        lg = lg.float()
        lp = torch.log_softmax(lg, dim=-1)
        if temperature > 0.0:
            u = torch.rand(lg.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
            nxt = torch.argmax(lg / max(temperature, 1e-6) + gumbel, dim=-1)
        else:
            nxt = torch.argmax(lg, dim=-1)
        return nxt, lp.gather(1, nxt[:, None])[:, 0]

    falses = torch.zeros(b, dtype=torch.bool, device=dev)
    first, lp = select(logits, (falses, falses, torch.full((b,), tb - 1, device=dev)),
                       first_step=True)
    done = first == c.eot_token
    sum_lp, n_emit = lp, torch.ones(b, device=dev)
    # after ONE sampled token the penultimate flag reads True (upstream's
    # len(seq) < 2 convention)
    st = (first >= tb, ~falses, torch.where(first >= tb, first, tb - 1))
    out = [first]
    tok = first
    step = (_single_token_step(dec, cross, cache, start_bias, b, n0)
            if max_new_tokens > 1 else None)
    for i in range(max_new_tokens - 1):
        if i % 16 == 0 and bool(done.all()):
            break   # every row is EOT from here on; the stats stay as they are
        logits = step(tok[:, None], (plen + n_prompt + i)[:, None], n0 + i)
        nxt, lp = select(logits, st)
        nxt = torch.where(done, c.eot_token, nxt)
        sum_lp = sum_lp + torch.where(done, 0.0, lp)
        n_emit = n_emit + torch.where(done, 0.0, 1.0)
        is_ts = (nxt >= tb) & ~done
        st = (is_ts, st[0], torch.where(is_ts, nxt, st[2]))
        done = done | (nxt == c.eot_token)
        out.append(nxt)
        tok = nxt
    ids = torch.full((b, budget), c.eot_token, dtype=torch.long, device=dev)
    ids[:, : len(out)] = torch.stack(out, dim=1)
    return ids, sum_lp / n_emit


def greedy_decode(cfg: WhisperConfigT, model: WhisperForConditionalGeneration,
                  mel: torch.Tensor, max_new_tokens: int | None = None) -> torch.Tensor:
    """Batched greedy transcription: [B, T_mel, M] -> EOT-padded token ids."""
    return decode_with_stats(cfg, model, mel, max_new_tokens=max_new_tokens)[0]


def timestamp_text_ids(cfg: WhisperConfigT, ids) -> list[int]:
    """Sampled TEXT tokens of a timestamp-mode decode: stop at the first
    EOT, drop timestamp tokens and specials."""
    tb = cfg.timestamp_begin
    specials = set(cfg.forced_tokens(False)) | {cfg.eot_token, cfg.prev_token}
    out = []
    for t in ids:
        t = int(t)
        if t == cfg.eot_token:
            break
        if t < tb and t not in specials:
            out.append(t)
    return out


def timestamp_seek(cfg: WhisperConfigT, ids) -> tuple[int, list[int]]:
    """Upstream ``whisper.transcribe``'s seek rule over one window's decoded
    ids (with ``timestamps=True``): ``(advance_samples, text_ids)``. With at
    least one CONSECUTIVE timestamp pair, seek advances to the last such
    boundary's time and keeps the text before it; otherwise (or when that
    advance is not positive) it advances the whole window, so a degenerate
    decode can never stall the loop."""
    tb = cfg.timestamp_begin
    toks: list[int] = []
    for t in ids:
        t = int(t)
        if t == cfg.eot_token:
            break
        toks.append(t)
    window = cfg.max_source_positions * cfg.timestamp_stride_samples
    is_ts = [t >= tb for t in toks]
    pair_ends = [i + 1 for i in range(len(toks) - 1) if is_ts[i] and is_ts[i + 1]]
    if not pair_ends:
        return window, timestamp_text_ids(cfg, toks)
    last = pair_ends[-1]
    advance = (toks[last - 1] - tb) * cfg.timestamp_stride_samples
    if advance <= 0:
        return window, timestamp_text_ids(cfg, toks)
    # tokens past the boundary describe audio the NEXT window re-decodes
    return advance, timestamp_text_ids(cfg, toks[: last + 1])


def compression_ratio(text: str) -> float:
    """whisper.utils.compression_ratio: length of the UTF-8 text over its
    zlib-compressed length; degenerate repetition is very compressible."""
    data = text.encode("utf-8")
    return len(data) / max(len(zlib.compress(data)), 1)
