"""Multi-head attention: the hand-written CUDA flash-attention forward and
backward, their plain PyTorch versions, and the autograd Function that joins
them.

The port's counterpart of the JAX package's ``ops/attention.py``. Its two
TPU kernels become CUDA C++ for sm_90a: ``_fwd_kernel`` (kernel B1) is
``csrc/flash_fwd.cu`` and ``_bwd_kernel`` (kernel B2) is
``csrc/flash_bwd.cu``; ``FlashAttention`` plays the JAX ``custom_vjp``.

``multihead_attention(q, k, v, key_mask, dropout_rate, seed, t_hash)`` over
``[B, T, H, D]``:

  * on CUDA tensors it launches the kernels (``flash_attention_fwd``, and
    ``flash_attention_bwd`` in the backward),
  * on CPU tensors it runs the plain versions (``attention_ref``,
    ``attention_bwd_ref``),

and nothing else: there is no fallback from one to the other.

Both keep the TPU kernels' semantics. Masked keys are REPLACED by
``NEG_INF`` (not biased), so a row whose keys are all masked returns a
finite average of V. The denominator uses the undropped probabilities.
Attention dropout is the TPU kernel's counter-based hash of
``(b*H + h, row, col, seed)`` with row stride ``t_hash``: pass the padded
length the JAX wrapper used (``T`` rounded up to its block) and the keep
masks are bit-identical, in the forward and in the backward.
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


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 tensor of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _fmix32_(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer, in place, on the int32 bits of uint32 values:
    int32 products wrap mod 2^32 (the low 32 bits of the uint32 product),
    and each arithmetic shift is masked to a logical one. One scratch
    buffer; int32 halves the passes' bytes against an int64 emulation."""
    t = torch.empty_like(x)
    for c, shift in ((_FMIX_C1, 16), (_FMIX_C2, 13)):
        torch.bitwise_right_shift(x, shift, out=t)
        t &= (1 << (32 - shift)) - 1
        x ^= t
        x *= c - (1 << 32)  # the constant's int32 bits (both are >= 2^31)
    torch.bitwise_right_shift(x, 16, out=t)
    t &= 0xFFFF
    x ^= t
    return x


def keep_mask(seed: int, bh: int, t_q: int, t_k: int, t_hash: int,
              rate: float, device=None) -> torch.Tensor:
    """``[bh, t_q, t_k]`` bool keep mask of the counter-based dropout."""
    seed_bh = _fmix32_(_as_int32((seed + torch.arange(bh, dtype=torch.int64, device=device)
                                  * _GOLDEN) & _M32))
    rows = torch.arange(t_q, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(t_k, dtype=torch.int64, device=device)[None, :]
    base = _as_int32((rows * t_hash + cols) & _M32)
    h = _fmix32_(base[None] ^ seed_bh[:, None, None])
    h &= 0x7FFFFFFF
    return h >= keep_threshold(rate)


def _masked_exp(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``exp(s - rowmax)`` of scores whose masked keys hold ``NEG_INF``. On
    the CPU an exp that underflows is ~10x slower and padding keys are most
    of a bucket's, so there the exp runs only where it is not 0, bit-equal
    to computing it everywhere: a masked key of a row with a valid key gives
    exactly 0, and a row without one is all exp(0) = 1."""
    if s.device.type != "cpu":
        return torch.exp(s - s.amax(-1, keepdim=True))
    live = valid | ~valid.any(-1, keepdim=True)
    z = torch.where(live, s - s.amax(-1, keepdim=True), torch.zeros((), device=s.device))
    return torch.where(live, torch.exp(z), torch.zeros((), device=s.device))


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
    p = _masked_exp(s, valid)
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


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_mask: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                      rate: float = 0.0, seed: int = 0,
                      t_hash: int | None = None):
    """Plain PyTorch version of kernel B2: the TPU kernel's recompute
    backward, its ten steps written out (not through autograd), so ``dS`` is
    not zeroed at masked keys, exactly as on the TPU. q, k, v, the forward's
    output ``o`` and its cotangent ``do`` are ``[B, T, H, D]``; returns
    ``(dq, dk, dv)`` in q's dtype, every intermediate fp32."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qs, kf, vf, dof = q.float() * scale, k.float(), v.float(), do.float()
    zero = torch.zeros((), device=q.device)
    # 1. scores, masked keys replaced
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    valid = (key_mask > 0)[:, None, None, :]
    s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    # 2. the undropped probabilities
    e = _masked_exp(s, valid)
    p = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    # 3-4. the forward's keep mask; A = keep * p / (1 - r)
    a, inv_keep = p, 1.0
    if rate > 0.0:
        keep = keep_mask(seed, b * h, t, t, t if t_hash is None else t_hash,
                         rate, device=q.device).view(b, h, t, t)
        inv_keep = 1.0 / (1.0 - rate)
        a = torch.where(keep, p, zero) * inv_keep
    # 5. dV = A^T dO
    dv = torch.einsum("bhqk,bqhd->bkhd", a, dof)
    # 6. dP = keep * (dO V^T) / (1 - r)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    if rate > 0.0:
        dp = torch.where(keep, dp, zero) * inv_keep
    # 7. delta = rowsum(dO * O)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, T, 1]
    # 8. dS = p * (dP - delta)
    ds = p * (dp - delta)
    # 9. dQ = dS K scale;  10. dK = dS^T (q scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def dropout_seed(generator: torch.Generator | None = None) -> int:
    """One call's attention-dropout seed as a host int, drawn from a CPU
    generator (so the card needs no device-to-host sync) in the JAX
    wrapper's range ``[INT32_MIN, INT32_MAX)``."""
    return int(torch.randint(-2**31, 2**31 - 1, (), generator=generator))


def hash_stride(t: int) -> int:
    """The row stride the JAX wrapper hashes with: T padded to 128, which
    every block ``auto_block`` picks divides."""
    return -(-t // 128) * 128


_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 9
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 15
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_float, ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _kernel(name: str, argtypes):
    from .cuda_build import load

    fn = getattr(load(name), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _aligned(x: torch.Tensor) -> bool:
    """D axis contiguous, other strides whole 16-byte vectors, aligned data."""
    align = 16 // x.element_size()  # elements per 16-byte vector load
    return (x.stride(3) == 1 and not any(s % align for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_strided(name: str, *xs: torch.Tensor) -> None:
    for x in xs:
        if not _aligned(x):
            raise ValueError(f"{name}: q/k/v/o/dO need a contiguous D axis, "
                             f"strides that are multiples of "
                             f"{16 // x.element_size()} and 16-byte-aligned "
                             f"data, got strides {x.stride()}")


def _check_inputs(name: str, q, k, v, key_mask) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and key_mask.device == q.device):
        raise ValueError(f"{name} needs q, k, v and key_mask on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes bf16 or fp32 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a [B, T, H, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if d != 64:
        raise ValueError(f"{name} supports head_dim 64, got {d}")
    if key_mask.shape != (b, t) or key_mask.dtype != torch.int32 \
            or not key_mask.is_contiguous():
        raise ValueError("key_mask must be a contiguous int32 [B, T] tensor")
    _check_strided(name, q, k, v)


def _dropout_args(rate: float, seed: int, t: int, t_hash: int | None):
    inv_keep = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    seed32 = ((int(seed) + 2**31) % 2**32) - 2**31  # wrap into int32
    return (seed32, t if t_hash is None else int(t_hash), keep_threshold(rate),
            inv_keep)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor, rate: float = 0.0,
                        seed: int = 0, t_hash: int | None = None,
                        return_lse: bool = False):
    """Launch kernel B1 (``csrc/flash_fwd.cu``) on CUDA tensors.

    q, k, v: ``[B, T, H, D]`` bf16 or fp32 on one CUDA device, D = 64, the D
    axis contiguous and every other stride a multiple of 8 elements (views
    of a projection's ``[B, T, H*D]`` output qualify). ``key_mask``: int32
    ``[B, T]`` (> 0 = valid). Returns a new contiguous ``[B, T, H, D]``, and
    with ``return_lse`` also each row's fp32 log-sum-exp ``[B, H, T]`` of the
    scaled, mask-replaced scores (what kernel B2 reads). Counts each launch
    in ``flash_attention_fwd.launches``."""
    _check_inputs("flash_attention_fwd", q, k, v, key_mask)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = _kernel("flash_fwd", _FWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[q.dtype], b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        1.0 / math.sqrt(d), *_dropout_args(rate, seed, t, t_hash),
        None if lse is None else lse.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, rate: float = 0.0,
                        seed: int = 0, t_hash: int | None = None):
    """Launch kernel B2 (``csrc/flash_bwd.cu``) on CUDA tensors: the
    gradients ``(dq, dk, dv)`` of B1's output ``o`` for its cotangent
    ``do``, each a new contiguous ``[B, T, H, D]`` in q's dtype. q, k, v,
    key_mask, rate, seed and t_hash are the forward's; ``lse`` is the
    forward's ``return_lse`` output. Counts each call (one per layer
    backward, three CUDA launches) in ``flash_attention_bwd.launches``. Two
    calls on the same inputs give bit-equal gradients: the bf16 kernel sums
    dQ over its key tiles in a fixed order."""
    _check_inputs("flash_attention_bwd", q, k, v, key_mask)
    b, t, h, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError("o and do must be [B, T, H, D] like q, o in q's dtype")
    do = do.to(q.dtype)
    if not _aligned(do):
        do = do.contiguous()
    _check_strided("flash_attention_bwd", o, do)
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be B1's contiguous fp32 [B, H, T] output")
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq_accum = dq_sem = None
    if q.dtype == torch.bfloat16:
        # dQ's fp32 partial sums, and one zeroed counter per (b*h, 64-query
        # tile) that orders the key tiles' adds (csrc/flash_bwd.cu)
        dq_accum = torch.empty((b * h, t, d), dtype=torch.float32, device=q.device)
        dq_sem = torch.zeros(b * h * -(-t // 64), dtype=torch.int32, device=q.device)
    dq, dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    rc = _kernel("flash_bwd", _BWD_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if dq_accum is None else dq_accum.data_ptr(),
        None if dq_sem is None else dq_sem.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype],
        b, t, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], *do.stride()[:3],
        1.0 / math.sqrt(d), *_dropout_args(rate, seed, t, t_hash),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """The JAX wrapper's ``custom_vjp``: forward B1 (saving each row's
    LSE), backward B2; on CPU tensors ``attention_ref`` and
    ``attention_bwd_ref``. Arguments as ``multihead_attention``'s."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, rate, seed, t_hash):
        if q.is_cuda:
            out, lse = flash_attention_fwd(q, k, v, key_mask, rate, seed, t_hash,
                                           return_lse=True)
        else:
            out, lse = attention_ref(q, k, v, key_mask, rate, seed, t_hash), None
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.dropout = (rate, seed, t_hash)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        if q.is_cuda:
            grads = flash_attention_bwd(q, k, v, key_mask, out, do, lse, *ctx.dropout)
        else:
            grads = attention_bwd_ref(q, k, v, key_mask, out, do, *ctx.dropout)
        return (*grads, None, None, None, None)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        key_mask: torch.Tensor | None = None,
                        dropout_rate: float = 0.0, seed: int = 0,
                        t_hash: int | None = None) -> torch.Tensor:
    """Softmax attention over ``[B, T, H, D]`` with key masking and the
    counter-based attention dropout: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors. Differentiable (``FlashAttention``) when
    q, k or v requires grad."""
    b, t = q.shape[:2]
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no attention implementation for device {q.device}")
    if key_mask is None:
        key_mask = torch.ones((b, t), dtype=torch.int32, device=q.device)
    elif key_mask.dtype != torch.int32:
        key_mask = (key_mask > 0).to(torch.int32)
    key_mask = key_mask.contiguous()
    rate = float(dropout_rate)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, key_mask, rate, int(seed), t_hash)
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, key_mask, rate, seed, t_hash)
    return attention_ref(q, k, v, key_mask, rate, seed, t_hash)
