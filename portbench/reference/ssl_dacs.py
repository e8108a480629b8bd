"""Plain fp32 reference of DACS on the SSL speech-encoder family
(data2vec-audio and HuBERT), written from the published architectures.

It is the yardstick the benchmark judges the program's outputs by, so it
imports nothing but torch and numpy: no kernel, no cache, no batching
logic of the program. Everything runs in float32 with TF32 off.

Architecture (HF ``Data2VecAudioModel`` / ``HubertModel``, plus the DACS
heads of JackingChen/Privacy-preserve-Federated-ASR):

* waveform -> zero-mean / unit-variance normalization per utterance
  (``Wav2Vec2FeatureExtractor``), zero padding to the batch's bucket;
* conv frontend: 7 convs, each followed by a LayerNorm over channels and
  GELU (``feat_extract_norm="layer"``);
* feature projection: LayerNorm, Linear(512 -> D);
* padded frames zeroed, then the positional convolution added: data2vec's
  stack of grouped convs, each followed by a non-affine LayerNorm and GELU,
  or HuBERT's one wide grouped conv (even kernel: last frame dropped) and
  GELU;
* post-LN blocks (data2vec): LN after the embedding sum, then per layer
  ``LN(x + attn(x))``, ``LN(x + ffn(x))``; pre-LN blocks (HuBERT,
  ``do_stable_layer_norm``): ``x + attn(LN(x))``, ``x + ffn(LN(x))`` and one
  LN after the stack;
* attention: padded keys get the score -1e30 (replaced, not added), softmax
  over keys, attention dropout on the probabilities after the softmax;
* heads: CTC head (Linear D -> vocab); at stage 2 the arbitrator Linear
  D -> 4D gives per-channel logit pairs for an lm mask and an AD mask, each
  a straight-through Gumbel-softmax sample (hard: channel kept where the
  first of the pair wins, the first on ties), the CTC head reads the
  lm-masked stream and the AD head the AD-masked one.

Training (stage 0): CTC loss (sum over rows, ``zero_infinity``) of the
CTC head on the unmasked stream, the frozen conv frontend, global-norm
clipping, AdamW with decoupled weight decay (no decay on biases and
LayerNorm weights) and a linear warm-up schedule.

Weights. The arithmetic is float32 throughout, on the weights as the
configuration's compute dtype holds them: served weights are stored in
that dtype, and a training forward rounds its float32 parameters to it at
use (``as_computed``); LayerNorm parameters stay float32 in both.

Dropout. The program's hidden and activation dropouts draw from torch's
default generator and its attention dropout is a counter-based hash of
(batch*head, query row, key column, per-layer seed). The reference draws
the first kind itself, in the program's order and shapes, from the same
seeded generator (``DropoutPlan``), and computes the hash from the frozen
copy below, so both sides drop the same elements.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30
LN_EPS = 1e-5


def fp32_only() -> None:
    """Matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- shapes ----

def conv_out_frames(cfg: dict, samples: int) -> int:
    """Frames the conv frontend gives for ``samples`` input samples."""
    n = int(samples)
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
    return n


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of the DACS model, by its HF-style name."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    shapes: dict[str, tuple[int, ...]] = {}
    fe = "backbone.feature_extractor.conv_layers"
    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        shapes[f"{fe}.{i}.conv.weight"] = (c, c_in, k)
        if cfg["conv_bias"]:
            shapes[f"{fe}.{i}.conv.bias"] = (c,)
        shapes[f"{fe}.{i}.layer_norm.weight"] = (c,)
        shapes[f"{fe}.{i}.layer_norm.bias"] = (c,)
        c_in = c
    fp = "backbone.feature_projection"
    shapes[f"{fp}.layer_norm.weight"] = (c_in,)
    shapes[f"{fp}.layer_norm.bias"] = (c_in,)
    shapes[f"{fp}.projection.weight"] = (d, c_in)
    shapes[f"{fp}.projection.bias"] = (d,)
    pc = "backbone.encoder.pos_conv_embed"
    groups = cfg["num_conv_pos_embedding_groups"]
    if cfg["pos_conv_type"] == "stacked":
        for i in range(cfg["num_conv_pos_embeddings"]):
            shapes[f"{pc}.layers.{i}.conv.weight"] = (d, d // groups, cfg["conv_pos_kernel_size"])
            shapes[f"{pc}.layers.{i}.conv.bias"] = (d,)
    else:
        shapes[f"{pc}.conv.weight"] = (d, d // groups, cfg["num_conv_pos_embeddings"])
        shapes[f"{pc}.conv.bias"] = (d,)
    shapes["backbone.encoder.layer_norm.weight"] = (d,)
    shapes["backbone.encoder.layer_norm.bias"] = (d,)
    for i in range(cfg["num_hidden_layers"]):
        p = f"backbone.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{p}.attention.{proj}.weight"] = (d, d)
            shapes[f"{p}.attention.{proj}.bias"] = (d,)
        shapes[f"{p}.layer_norm.weight"] = (d,)
        shapes[f"{p}.layer_norm.bias"] = (d,)
        shapes[f"{p}.feed_forward.intermediate_dense.weight"] = (f, d)
        shapes[f"{p}.feed_forward.intermediate_dense.bias"] = (f,)
        shapes[f"{p}.feed_forward.output_dense.weight"] = (d, f)
        shapes[f"{p}.feed_forward.output_dense.bias"] = (d,)
        shapes[f"{p}.final_layer_norm.weight"] = (d,)
        shapes[f"{p}.final_layer_norm.bias"] = (d,)
    shapes["arbitrator.weight"] = (4 * d, d)
    shapes["arbitrator.bias"] = (4 * d,)
    shapes["lm_head.weight"] = (v, d)
    shapes["lm_head.bias"] = (v,)
    shapes["dementia_head.weight"] = (2, d)
    shapes["dementia_head.bias"] = (2,)
    shapes["similar_fc.weight"] = (2, d)
    return shapes


def is_norm_weight(name: str) -> bool:
    return name.endswith("layer_norm.weight")


def no_decay(name: str) -> bool:
    """AdamW's no-decay group: biases and LayerNorm weights."""
    return name.endswith(".bias") or is_norm_weight(name)


def stage0_trainable(name: str) -> bool:
    """Stage 0 trains the encoder (not the conv frontend) and the CTC head."""
    if name.startswith("backbone."):
        return not name.startswith("backbone.feature_extractor.")
    return name.startswith("lm_head.")


# ---- input preparation ----

def normalize(x: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance (``Wav2Vec2FeatureExtractor``, eps 1e-7),
    in float64 and returned as float32."""
    x = np.asarray(x, np.float64)
    return ((x - x.mean()) / np.sqrt(x.var() + 1e-7)).astype(np.float32)


def pad_rows(rows: list[np.ndarray], length: int) -> np.ndarray:
    out = np.zeros((len(rows), length), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r[:length]
    return out


# ---- the counter-based attention dropout (frozen copy of the kernels' hash) ----

M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 values held in int64, without overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * c) & 0xFFFF) * 65536) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def attention_keep(seed: int, b_rows: int, b_offset: int, heads: int, t: int,
                   rate: float, device) -> torch.Tensor:
    """``[B, H, T, T]`` keep mask: element (b, h, q, k) is dropped where the
    31-bit hash of ``(q * T_hash + k) xor fmix(seed + (b*H + h) * golden)``
    falls below ``rate * 2**31``; T_hash is T rounded up to 128."""
    t_hash = -(-t // 128) * 128
    bh = ((torch.arange(b_rows, device=device) + b_offset)[:, None] * heads
          + torch.arange(heads, device=device)[None, :]).reshape(-1)
    seed_bh = _fmix32((int(seed) + bh * 0x9E3779B9) & M32)
    rows = torch.arange(t, dtype=torch.int64, device=device)
    base = (rows[:, None] * t_hash + rows[None, :]) & M32
    h = _fmix32(base[None] ^ seed_bh[:, None, None]) & 0x7FFFFFFF
    threshold = min(int(rate * 2147483648.0), 2147483647)
    return (h >= threshold).view(b_rows, heads, t, t)


class DropoutPlan:
    """The dropout of one training step, drawn as the program draws it: one
    hidden-dropout mask after the embedding, then per layer the attention
    seed (from the CPU generator ``seeds``), the mask after attention, the
    activation mask and the mask after the FFN, each from torch's default
    generator on ``device`` through ``F.dropout`` on ones of the program's
    compute dtype. Masks are ``[B, T, C]`` bool; ``rows`` slices them."""

    def __init__(self, cfg: dict, b: int, t: int, seeds: torch.Generator, device,
                 dtype: torch.dtype):
        d, f = cfg["hidden_size"], cfg["intermediate_size"]
        self.p_hidden = cfg["hidden_dropout"]
        self.p_act = cfg["activation_dropout"]
        self.p_attn = cfg["attention_dropout"]

        def draw(p, width):
            if p <= 0.0:
                return None
            ones = torch.ones((b, t, width), dtype=dtype, device=device)
            return F.dropout(ones, p, True) != 0

        self.embed = draw(self.p_hidden, d)
        self.layers = []
        for _ in range(cfg["num_hidden_layers"]):
            seed = (int(torch.randint(-2**31, 2**31 - 1, (), generator=seeds))
                    if self.p_attn > 0.0 else 0)
            self.layers.append((seed, draw(self.p_hidden, d), draw(self.p_act, f),
                                draw(self.p_hidden, d)))


def _drop(x: torch.Tensor, mask: torch.Tensor | None, p: float) -> torch.Tensor:
    if mask is None:
        return x
    return x * mask.to(x.dtype) * (1.0 / (1.0 - p))


# ---- the model ----

def _linear(w: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[f"{name}.weight"], w.get(f"{name}.bias"))


def _ln(w: dict, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], eps)


def frontend(cfg: dict, w: dict, audio: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` normalized, padded waveform -> ``[B, T, C]`` conv features."""
    x = audio[:, None, :]
    fe = "backbone.feature_extractor.conv_layers"
    for i, s in enumerate(cfg["conv_stride"]):
        x = F.conv1d(x, w[f"{fe}.{i}.conv.weight"], w.get(f"{fe}.{i}.conv.bias"), stride=s)
        x = _ln(w, f"{fe}.{i}.layer_norm", x.transpose(1, 2), LN_EPS).transpose(1, 2)
        x = F.gelu(x)
    return x.transpose(1, 2)


def _pos_conv(cfg: dict, w: dict, x: torch.Tensor) -> torch.Tensor:
    x = x.transpose(1, 2)
    groups = cfg["num_conv_pos_embedding_groups"]
    pc = "backbone.encoder.pos_conv_embed"
    if cfg["pos_conv_type"] == "stacked":
        k = cfg["conv_pos_kernel_size"]
        for i in range(cfg["num_conv_pos_embeddings"]):
            x = F.conv1d(x, w[f"{pc}.layers.{i}.conv.weight"], w[f"{pc}.layers.{i}.conv.bias"],
                         padding=k // 2, groups=groups)
            if k % 2 == 0:
                x = x[:, :, :-1]
            x = F.layer_norm(x.transpose(1, 2), (x.shape[1],), eps=LN_EPS).transpose(1, 2)
            x = F.gelu(x)
    else:
        k = cfg["num_conv_pos_embeddings"]
        x = F.conv1d(x, w[f"{pc}.conv.weight"], w[f"{pc}.conv.bias"], padding=k // 2,
                     groups=groups)
        if k % 2 == 0:
            x = x[:, :, :-1]
        x = F.gelu(x)
    return x.transpose(1, 2)


def _attention(cfg: dict, w: dict, p: str, x: torch.Tensor, key_valid: torch.Tensor,
               keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    b, t, d = x.shape
    h = cfg["num_attention_heads"]
    hd = d // h

    def heads(name):
        return _linear(w, f"{p}.attention.{name}", x).view(b, t, h, hd).transpose(1, 2)

    q, k, v = heads("q_proj"), heads("k_proj"), heads("v_proj")
    s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    s = torch.where(key_valid[:, None, None, :], s, torch.full_like(s, NEG))
    probs = torch.softmax(s, dim=-1)
    if keep is not None:
        probs = probs * keep.to(probs.dtype) * (1.0 / (1.0 - rate))
    ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, d)
    return _linear(w, f"{p}.attention.out_proj", ctx)


def encoder(cfg: dict, w: dict, feats: torch.Tensor, frame_lengths: torch.Tensor,
            plan: DropoutPlan | None = None, rows: slice | None = None) -> torch.Tensor:
    """Conv features ``[B, T, C]`` -> encoder output ``[B, T, D]``. With a
    ``plan`` (training) its masks apply; ``rows`` are this block's rows of
    the plan's batch (the attention hash indexes the global rows)."""
    eps = cfg["layer_norm_eps"]
    b, t, _ = feats.shape
    fp = "backbone.feature_projection"
    x = _linear(w, f"{fp}.projection", _ln(w, f"{fp}.layer_norm", feats, eps))
    valid = torch.arange(t, device=feats.device)[None, :] < frame_lengths[:, None]
    x = x * valid[:, :, None].to(x.dtype)
    x = x + _pos_conv(cfg, w, x)
    stable = cfg["do_stable_layer_norm"]
    rows = rows or slice(0, b)
    if not stable:
        x = _ln(w, "backbone.encoder.layer_norm", x, eps)
    if plan is not None:
        x = _drop(x, None if plan.embed is None else plan.embed[rows], plan.p_hidden)
    for i in range(cfg["num_hidden_layers"]):
        p = f"backbone.encoder.layers.{i}"
        keep, m_attn, m_act, m_out = None, None, None, None
        if plan is not None:
            seed, m_attn, m_act, m_out = plan.layers[i]
            m_attn, m_act, m_out = (None if m is None else m[rows] for m in (m_attn, m_act, m_out))
            if plan.p_attn > 0.0:
                keep = attention_keep(seed, b, rows.start, cfg["num_attention_heads"], t,
                                      plan.p_attn, x.device)
        p_h = 0.0 if plan is None else plan.p_hidden
        p_a = 0.0 if plan is None else plan.p_act
        p_t = 0.0 if plan is None else plan.p_attn

        def ffn(y):
            y = F.gelu(_linear(w, f"{p}.feed_forward.intermediate_dense", y))
            y = _drop(y, m_act, p_a)
            return _drop(_linear(w, f"{p}.feed_forward.output_dense", y), m_out, p_h)

        if stable:
            a = _attention(cfg, w, p, _ln(w, f"{p}.layer_norm", x, eps), valid, keep, p_t)
            x = x + _drop(a, m_attn, p_h)
            x = x + ffn(_ln(w, f"{p}.final_layer_norm", x, eps))
        else:
            x = x + _drop(_attention(cfg, w, p, x, valid, keep, p_t), m_attn, p_h)
            x = _ln(w, f"{p}.layer_norm", x, eps)
            x = _ln(w, f"{p}.final_layer_norm", x + ffn(x), eps)
    if stable:
        x = _ln(w, "backbone.encoder.layer_norm", x, eps)
    return x


def gumbel_noise(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The serving engine's noise for a batch of ``shape = [B, T, D, 2]``: a
    generator on ``device`` seeded with 0, lm noise then AD noise, each
    ``-log(Exponential(1))``."""
    g = torch.Generator(device).manual_seed(0)
    draws = []
    for _ in range(2):
        e = torch.empty(shape, dtype=torch.float32, device=device)
        draws.append(-e.exponential_(generator=g).log())
    return draws[0], draws[1]


def stage2_heads(w: dict, h: torch.Tensor, lm_noise: torch.Tensor, ad_noise: torch.Tensor,
                 tau: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(CTC logits of the lm-masked stream, AD logits of the AD-masked
    stream) for encoder output ``h [B, T, D]``."""
    d = h.shape[-1]
    s = _linear(w, "arbitrator", h)

    def mask(a, b_, noise):
        y = (torch.stack((a, b_), -1) + noise.clamp(-1e9, 1e9)) / tau
        return (y[..., 0] >= y[..., 1]).to(h.dtype)

    lm = mask(s[..., :d], s[..., d:2 * d], lm_noise)
    ad = mask(s[..., 2 * d:3 * d], s[..., 3 * d:], ad_noise)
    return _linear(w, "lm_head", lm * h), _linear(w, "dementia_head", ad * h)


# ---- serving: one request as the engine served it ----

def serve_row(cfg: dict, w: dict, audio: np.ndarray, bucket: int, batch_size: int, row: int,
              device) -> dict:
    """The answer for one request served in row ``row`` of a batch padded
    to ``bucket`` samples: per-frame CTC logits ``[T_valid, V]`` and the
    mean P(AD) over valid frames. Stage 2, eval mode."""
    x = normalize(np.asarray(audio)[:bucket])
    n = len(x)
    valid = conv_out_frames(cfg, n)
    t = conv_out_frames(cfg, bucket)
    wav = torch.from_numpy(pad_rows([x], bucket)).to(device)
    with torch.no_grad():
        feats = frontend(cfg, w, wav)
        h = encoder(cfg, w, feats, torch.tensor([valid], device=device))
        lm_noise, ad_noise = gumbel_noise((batch_size, t, cfg["hidden_size"], 2), device)
        logits, dem = stage2_heads(w, h, lm_noise[row:row + 1], ad_noise[row:row + 1],
                                   cfg["gs_tau"])
        p_ad = torch.softmax(dem[0, :valid], -1)[:, 1].mean()
    return {"logits": logits[0, :valid].cpu(), "ad_prob": float(p_ad), "frames": valid}


# ---- training: stage-0 steps ----

def ctc_sum(logits: torch.Tensor, frame_lengths: torch.Tensor, labels: torch.Tensor,
            label_lengths: torch.Tensor) -> torch.Tensor:
    """Summed CTC negative log-likelihood, blank 0, impossible alignments 0."""
    lp = F.log_softmax(logits, dim=-1).transpose(0, 1)
    return F.ctc_loss(lp, labels, frame_lengths, label_lengths, blank=0, reduction="sum",
                      zero_infinity=True)


def lr_at(count: int, peak: float, warmup: int, total: int) -> float:
    """Linear warm-up from 0 to ``peak`` over ``warmup`` updates, then
    linear decay to 0 at ``total``."""
    if count < warmup:
        return peak * count / max(warmup, 1)
    return peak * (1.0 - min(count - warmup, max(total - warmup, 1)) / max(total - warmup, 1))


class AdamW:
    """Global-norm clip then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled
    weight decay), written out."""

    def __init__(self, params: dict, lr, weight_decay: float, max_norm: float):
        self.params, self.lr, self.wd, self.max_norm = params, lr, weight_decay, max_norm
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    def step(self, grads: dict) -> dict:
        """Update in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = 1.0 if norm < self.max_norm else self.max_norm / norm
        lr = self.lr(self.t)
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        clipped = {}
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k] * scale
                clipped[k] = g
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                if not no_decay(k):
                    p.mul_(1.0 - lr * self.wd)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
        return clipped


def as_computed(w: dict, dtype: torch.dtype) -> dict:
    """The weights as a forward in ``dtype`` uses them: matmul and conv
    weights and biases rounded to ``dtype`` (LayerNorm parameters stay
    float32), the arithmetic still float32. Straight through: a leaf's
    gradient is the gradient at its rounded value."""
    if dtype == torch.float32:
        return w
    return {k: v if "layer_norm" in k else v + (v.detach().to(dtype).float() - v.detach())
            for k, v in w.items()}


def train_step_grads(cfg: dict, w: dict, trainable: dict, audio: np.ndarray,
                     sample_lengths: np.ndarray, labels: np.ndarray, label_lengths: np.ndarray,
                     plan: DropoutPlan, device, block: int,
                     dtype: torch.dtype = torch.float32) -> tuple[float, dict]:
    """One stage-0 step's summed loss and gradients (of ``trainable``, the
    fp32 leaves in ``w``), computed ``block`` rows at a time: the loss is a
    sum over rows, so the blocks' gradients add up. The forward uses the
    weights as a ``dtype`` forward does (``as_computed``)."""
    b = audio.shape[0]
    grads = {k: torch.zeros_like(p) for k, p in trainable.items()}
    total = 0.0
    for r0 in range(0, b, block):
        rows = slice(r0, min(r0 + block, b))
        wav = torch.from_numpy(audio[rows]).to(device)
        fl = torch.tensor([conv_out_frames(cfg, n) for n in sample_lengths[rows]], device=device)
        wc = as_computed(w, dtype)
        with torch.no_grad():
            feats = frontend(cfg, wc, wav)
        h = encoder(cfg, wc, feats, fl, plan, rows)
        logits = _linear(wc, "lm_head", h)
        lab = torch.from_numpy(labels[rows]).long().clamp_min(0).to(device)
        ll = torch.from_numpy(label_lengths[rows]).long().to(device)
        loss = ctc_sum(logits, fl, lab, ll)
        g = torch.autograd.grad(loss, list(trainable.values()), allow_unused=True)
        for (k, acc), gi in zip(grads.items(), g):
            if gi is not None:
                acc.add_(gi)
        total += float(loss.detach())
    return total, grads
