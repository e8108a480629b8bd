"""Multi-head attention: the hand-written CUDA flash-attention forward and
its plain PyTorch version.

The port's counterpart of the JAX package's ``ops/attention.py``. Its TPU
kernel ``_fwd_kernel`` (kernel B1) becomes ``csrc/flash_fwd.cu``; the
backward ``_bwd_kernel`` (B2) comes with the training slice, so the forward
here refuses tensors that require grad on the card.

``multihead_attention(q, k, v, key_mask)`` over ``[B, T, H, D]``:

  * on CUDA tensors it launches the kernel (``flash_attention_fwd``),
  * on CPU tensors it runs the plain version (``attention_ref``),

and nothing else: there is no fallback from one to the other.

Both keep the TPU kernel's semantics. Masked keys are REPLACED by ``NEG_INF``
(not biased), so a row whose keys are all masked returns a finite average of
V. The denominator uses the undropped probabilities. Attention dropout is
the TPU kernel's counter-based hash of ``(b*H + h, row, col, seed)`` with
row stride ``t_hash``: pass the padded length the JAX wrapper used
(``T`` rounded up to its block) and the keep masks are bit-identical.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

# murmur3 fmix32 constants and the per-(b*h) seed stride, as uint32
_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """hash31 < threshold  <=>  DROP (P(drop) = rate)."""
    return min(int(rate * 2147483648.0), 2147483647) if rate > 0.0 else 0


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for int64 ``x`` in [0, 2^32): split in 16-bit
    halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 (logical shifts)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _FMIX_C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _FMIX_C2)
    return x ^ (x >> 16)


def keep_mask(seed: int, bh: int, t_q: int, t_k: int, t_hash: int,
              rate: float, device=None) -> torch.Tensor:
    """``[bh, t_q, t_k]`` bool keep mask of the counter-based dropout."""
    seed_bh = _fmix32((seed + torch.arange(bh, dtype=torch.int64, device=device)
                       * _GOLDEN) & _M32)
    rows = torch.arange(t_q, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(t_k, dtype=torch.int64, device=device)[None, :]
    base = (rows * t_hash + cols) & _M32
    h = _fmix32(base[None] ^ seed_bh[:, None, None])
    return (h & 0x7FFFFFFF) >= keep_threshold(rate)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  key_mask: torch.Tensor, rate: float = 0.0, seed: int = 0,
                  t_hash: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel B1: q, k, v ``[B, T, H, D]``,
    ``key_mask`` ``[B, T]`` (> 0 = valid). Returns ``[B, T, H, D]`` in q's
    dtype; every intermediate is fp32."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    valid = (key_mask > 0)[:, None, None, :]
    s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)  # undropped denominator
    inv_keep = 1.0
    if rate > 0.0:
        keep = keep_mask(seed, b * h, t, t, t if t_hash is None else t_hash,
                         rate, device=q.device).view(b, h, t, t)
        p = torch.where(keep, p, torch.zeros((), device=p.device))
        inv_keep = 1.0 / (1.0 - rate)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = acc * inv_keep / l.clamp_min(1e-30).permute(0, 2, 1, 3)
    return out.to(q.dtype)


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                ctypes.c_float, ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _flash_lib():
    from .cuda_build import load

    lib = load("flash_fwd")
    if lib.flash_fwd.argtypes is None:
        lib.flash_fwd.argtypes = _ARGTYPES
        lib.flash_fwd.restype = ctypes.c_int
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor, rate: float = 0.0,
                        seed: int = 0, t_hash: int | None = None) -> torch.Tensor:
    """Launch kernel B1 (``csrc/flash_fwd.cu``) on CUDA tensors.

    q, k, v: ``[B, T, H, D]`` bf16 or fp32 on one CUDA device, D = 64, the D
    axis contiguous and every other stride a multiple of 8 elements (views
    of a projection's ``[B, T, H*D]`` output qualify). ``key_mask``: int32
    ``[B, T]`` (> 0 = valid). Returns a new contiguous ``[B, T, H, D]``.
    Counts each launch in ``flash_attention_fwd.launches``."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and key_mask.device == q.device):
        raise ValueError("flash_attention_fwd needs q, k, v and key_mask on "
                         "one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes bf16 or fp32 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a [B, T, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if d != 64:
        raise ValueError(f"flash_attention_fwd supports head_dim 64, got {d}")
    if key_mask.shape != (b, t) or key_mask.dtype != torch.int32 \
            or not key_mask.is_contiguous():
        raise ValueError("key_mask must be a contiguous int32 [B, T] tensor")
    align = 16 // q.element_size()  # elements per 16-byte vector load
    for x in (q, k, v):
        if x.stride(3) != 1 or any(s % align for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"q/k/v need a contiguous D axis, strides that "
                             f"are multiples of {align} and 16-byte-aligned "
                             f"data, got strides {x.stride()}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention_fwd has no gradient on the card "
                           "yet: the backward kernel (B2) comes with the "
                           "training slice")
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _flash_lib()
    inv_keep = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    seed32 = ((int(seed) + 2**31) % 2**32) - 2**31  # wrap into int32
    rc = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[q.dtype], b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(d), seed32, t if t_hash is None else int(t_hash),
        keep_threshold(rate), inv_keep,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention over ``[B, T, H, D]`` with key masking (inference:
    no dropout): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    b, t = q.shape[:2]
    if key_mask is None:
        key_mask = torch.ones((b, t), dtype=torch.int32, device=q.device)
    if q.is_cuda:
        if key_mask.dtype != torch.int32:
            key_mask = (key_mask > 0).to(torch.int32)
        return flash_attention_fwd(q, k, v, key_mask.contiguous())
    if q.device.type == "cpu":
        return attention_ref(q, k, v, key_mask)
    raise ValueError(f"no attention implementation for device {q.device}")
