"""The wide positional convolution of the wav2vec2 family: one grouped
Conv1d of kernel K (128) and ``padding=K // 2``, its last frame dropped
where K is even, then GELU, over ``[B, T, D]``.

The port's counterpart of the ``single`` branch of the JAX package's
``PositionalConvEmbedding`` (``models/backbone.py``), which leaves the
convolution to XLA. ``pos_conv_gelu(x, weight, bias, groups)`` returns
``GELU(conv(x))[:, :T]`` as ``[B, T, D]``:

  * on bf16 CUDA tensors through the hand-written kernels of
    ``csrc/pos_conv.cu`` in a ``torch.autograd.Function``: the weight as
    bf16 tap-major tiles (``pos_conv_weight_cuda``, in place of the
    ``weight.to(bf16)`` cast), the forward (``pos_conv_fwd_cuda``: pre =
    conv + bias, and GELU(pre)), the input gradient (``pos_conv_dgrad_cuda``:
    dz = dy GELU'(pre), and the convolution's gradient of dz) and the weight
    and bias gradient in fp32 (``pos_conv_wgrad_cuda``), written as the fp32
    parameters' gradients;
  * on CPU tensors, and on fp32 CUDA tensors (``cli extract`` runs the
    encoder in fp32, which the kernels, bf16 on the tensor cores, do not
    compute), the plain version ``pos_conv_gelu_plain``: ``F.conv1d`` ->
    crop -> ``F.gelu``, bit for bit the composition the module ran before;

and nothing else: a CUDA tensor of another dtype, or a shape the kernels do
not take (channels a group not a multiple of 8 or above 128, K above 256),
raises. There is no fallback from one to the other.

The kernels save x and pre for the backward (what autograd saved around
``F.conv1d`` and ``F.gelu``) and no copy of the weight: the backward makes
its tiles again (~0.1 ms at XLS-R 2B's width) rather than hold 67 MB from
the forward to the backward. Each launch is
counted in ``pos_conv_fwd_cuda.launches``, ``pos_conv_dgrad_cuda.launches``
and ``pos_conv_wgrad_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

MAX_TAPS = 256  # csrc/pos_conv.cu: the window of 128 + K - 1 frames fits in shared memory
_P = ctypes.c_void_p
_I = ctypes.c_int
_WEIGHT_ARGTYPES = [_P, _P, _I, _I, _I, _P]
_CONV_ARGTYPES = [_P] * 5 + [_I] * 5 + [_P]
_WGRAD_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]


def pos_conv_gelu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                        groups: int) -> torch.Tensor:
    """``[B, T, D]`` -> ``GELU(conv(x))`` cropped to T frames, the weight
    and bias cast to x's dtype: the module's composition, as it ran before
    the kernels."""
    dt, k = x.dtype, weight.shape[-1]
    y = F.conv1d(x.transpose(1, 2), weight.to(dt), None if bias is None else bias.to(dt),
                 padding=k // 2, groups=groups)
    if k % 2 == 0:
        y = y[:, :, :-1]
    return F.gelu(y).transpose(1, 2)


def padded_channels(cg: int) -> int:
    """Columns a group's channels take in the kernels' tiles."""
    return 64 if cg <= 64 else 128


def _shape(x: torch.Tensor, weight: torch.Tensor, groups: int) -> tuple[int, ...]:
    """(B, T, G, Cg, K), checked against what the kernels take."""
    b, t, d = x.shape
    cg, k = weight.shape[1], weight.shape[2]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"pos_conv_gelu's kernels take bf16 inputs, got {x.dtype}")
    if d % groups or weight.shape[0] != d or d // groups != cg:
        raise ValueError(f"pos_conv_gelu: weight {tuple(weight.shape)} is not a conv of "
                         f"{d} channels in {groups} groups")
    if cg % 8 or cg > 128 or not 1 <= k <= MAX_TAPS:
        raise ValueError(f"pos_conv_gelu's kernels take channels a group that are a multiple "
                         f"of 8 up to 128 and up to {MAX_TAPS} taps, got {cg} and {k}")
    if b < 1 or t < 1:
        raise ValueError(f"pos_conv_gelu takes B >= 1 rows of T >= 1 frames, got {b}, {t}")
    return b, t, groups, cg, k


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def pos_conv_weight_cuda(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """The fp32 weight ``[D, Cg, K]`` as bf16 tap-major tiles
    ``[G, K, P/8, P, 8]`` (P = ``padded_channels(Cg)``), zero past Cg."""
    d, cg, k = weight.shape
    p = padded_channels(cg)
    weight = weight.detach().float().contiguous()
    wp = torch.empty((groups, k, p // 8, p, 8), dtype=torch.bfloat16, device=weight.device)
    _check(cuda_build.symbol("pos_conv", "pos_conv_weight", _WEIGHT_ARGTYPES)(
        weight.data_ptr(), wp.data_ptr(), groups, cg, k, _stream(weight)), "pos_conv_weight")
    return wp


def pos_conv_fwd_cuda(x, wp, bias, shape):
    """(y, pre): ``pre = conv(x) + bias`` and ``y = GELU(pre)``, ``[B, T, D]``
    bf16. Counts each launch in ``pos_conv_fwd_cuda.launches``."""
    b, t, g, cg, k = shape
    y, pre = torch.empty_like(x), torch.empty_like(x)
    bias_ptr = 0 if bias is None else bias.data_ptr()
    _check(cuda_build.symbol("pos_conv", "pos_conv_fwd", _CONV_ARGTYPES)(
        x.data_ptr(), wp.data_ptr(), bias_ptr, y.data_ptr(), pre.data_ptr(),
        b, t, g, cg, k, _stream(x)), "pos_conv_fwd")
    pos_conv_fwd_cuda.launches += 1
    return y, pre


pos_conv_fwd_cuda.launches = 0


def pos_conv_dgrad_cuda(dy, pre, wp, shape):
    """(dx, dz): ``dz = dy GELU'(pre)`` and the convolution's input gradient
    of dz, ``[B, T, D]`` bf16. Reads the stream at call time (the backward
    runs on autograd's device thread). Counts each launch in
    ``pos_conv_dgrad_cuda.launches``."""
    b, t, g, cg, k = shape
    dx, dz = torch.empty_like(dy), torch.empty_like(dy)
    _check(cuda_build.symbol("pos_conv", "pos_conv_dgrad", _CONV_ARGTYPES)(
        dy.data_ptr(), pre.data_ptr(), wp.data_ptr(), dx.data_ptr(), dz.data_ptr(),
        b, t, g, cg, k, _stream(dy)), "pos_conv_dgrad")
    pos_conv_dgrad_cuda.launches += 1
    return dx, dz


pos_conv_dgrad_cuda.launches = 0


def pos_conv_wgrad_cuda(dz, x, shape, with_bias: bool):
    """(dw, db) in fp32: ``dw [D, Cg, K]``, the sum over (b, t) of
    ``dz[b, t, co] x[b, t + j - K // 2, ci]``, and ``db = dz.sum((0, 1))``
    (None without a bias); every element written by one block, so two calls
    give the same bits. Counts each launch in
    ``pos_conv_wgrad_cuda.launches``."""
    b, t, g, cg, k = shape
    dw = torch.empty((g * cg, cg, k), dtype=torch.float32, device=x.device)
    db = torch.empty(g * cg, dtype=torch.float32, device=x.device) if with_bias else None
    _check(cuda_build.symbol("pos_conv", "pos_conv_wgrad", _WGRAD_ARGTYPES)(
        dz.data_ptr(), x.data_ptr(), dw.data_ptr(), 0 if db is None else db.data_ptr(),
        b, t, g, cg, k, _stream(x)), "pos_conv_wgrad")
    pos_conv_wgrad_cuda.launches += 1
    return dw, db


pos_conv_wgrad_cuda.launches = 0


class _PosConvGelu(torch.autograd.Function):
    """The kernels' forward and backward; x bf16 ``[B, T, D]``, the weight
    and bias fp32 as the parameters store them, their gradients fp32."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups):
        shape = _shape(x, weight, groups)
        if not x.is_cuda or weight.device != x.device or (
                bias is not None and bias.device != x.device):
            raise ValueError("pos_conv_gelu's kernels need x, weight and bias on one CUDA device")
        x = x.contiguous()
        y, pre = pos_conv_fwd_cuda(x, pos_conv_weight_cuda(weight, groups),
                                   None if bias is None else bias.detach().float().contiguous(),
                                   shape)
        ctx.save_for_backward(x, pre, weight)
        ctx.shape, ctx.with_bias = shape, bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, pre, weight = ctx.saved_tensors
        wp = pos_conv_weight_cuda(weight, ctx.shape[2])
        dx, dz = pos_conv_dgrad_cuda(dy.contiguous(), pre, wp, ctx.shape)
        del wp  # freed before the weight gradient allocates its fp32 buffer
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = pos_conv_wgrad_cuda(dz, x, ctx.shape, ctx.with_bias)
        return (dx if ctx.needs_input_grad[0] else None, dw if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None, None)


def pos_conv_gelu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                  groups: int) -> torch.Tensor:
    """``GELU(conv(x))[:, :T]`` of ``x [B, T, D]`` under a grouped conv
    ``weight [D, D / groups, K]`` (``padding=K // 2``) and ``bias [D]``:
    the kernels on bf16 CUDA tensors, the plain version on CPU and fp32
    CUDA tensors; any other CUDA dtype raises."""
    if not x.is_cuda or x.dtype == torch.float32:
        return pos_conv_gelu_plain(x, weight, bias, groups)
    return _PosConvGelu.apply(x, weight, bias, groups)
