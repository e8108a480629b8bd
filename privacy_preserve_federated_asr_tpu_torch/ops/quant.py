"""Int8 (W8A8) dynamic-quantization Dense matmuls (the port's
``ops/quant.py``).

The forward-only surfaces (serving, batched extraction, transcribe) take
``compute_dtype="int8"``: bf16 compute with every backbone projection/FFN
matmul quantized on the fly (``BackboneConfig.dense_impl = "int8"``).
Training takes the trainable twin (``dense_impl="int8_train"``, ``cli train
--int8``). Recipe, as in the JAX package:

* activations: symmetric per-token (per row of the ``[.., T, K]`` input)
  abs-max scaling to int8 -- dynamic, no calibration pass;
* weights: symmetric per-output-channel abs-max scaling to int8, quantized
  from the live weight (already cast to the compute dtype) on every call;
* int8 x int8 -> int32 (``torch._int_mm``, cuBLAS on the card), then one
  rescale ``(acc * token_scale) * channel_scale`` in fp32 and a cast to the
  compute dtype. The bias is added after that cast, in the compute dtype
  (flax ``Dense``'s order).

``Int8TrainLinear`` wraps the same forward in a ``torch.autograd.Function``
with SwitchBack gradients (Wortsman et al., 2023): the grad-input product is
int8 too (the incoming gradient scaled per token, the transposed weight per
input channel), while the grad-weight product ``g^T @ x`` stays in the
compute dtype with fp32 accumulation. The quantization is straight-through:
gradients are computed from the un-quantized operands, so the parameter,
optimizer and checkpoint layout do not change.

``_int_mm`` takes 2-D operands with more than 16 rows and K, N multiples of
8 on the card. Fewer rows are padded with zero rows (exact: a zero row
quantizes to zeros and its products are dropped); K or N off that grid, or
any other failure of the int8 product, raises -- the port never falls back
to a floating-point matmul here.
"""

from __future__ import annotations

import torch

_MIN_ROWS = 17  # _int_mm on the card takes M > 16


def quantize_symmetric(x: torch.Tensor, dim: int, bound: int = 127):
    """Symmetric abs-max int8 quantization along ``dim``.

    Returns ``(q, scale)`` with ``q`` int8 and ``x ~= q * scale`` (``scale``
    fp32, keeping the reduced dim so it broadcasts back). An all-zero row
    quantizes to zeros with scale 1."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    # a tensor divisor: CUDA divides by a host scalar through its
    # reciprocal, one ulp off the correctly rounded quotient
    scale = torch.where(amax > 0, amax / amax.new_full((), float(bound)),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -bound, bound).to(torch.int8)
    return q, scale


def int_mm(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """``a_q [M, K] @ b_q [K, N]`` int8 -> int32 through ``torch._int_mm``,
    with ``M <= 16`` padded by zero rows (dropped from the result). ``b_q``
    goes in column-major, the layout cuBLAS's int8 GEMM takes fast on the
    card (about 5x the row-major time at the projection shapes); the
    forward's transposed weight is so already."""
    m, k = a_q.shape
    n = b_q.shape[1]
    if a_q.is_cuda and (k % 8 or n % 8):
        raise ValueError(f"int8 matmul on the card needs K and N multiples of 8 "
                         f"(got K={k}, N={n})")
    if m < _MIN_ROWS:
        a_q = torch.cat([a_q, a_q.new_zeros(_MIN_ROWS - m, k)])
    return torch._int_mm(a_q.contiguous(), b_q.t().contiguous().t())[:m]


def int8_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """W8A8 ``x [..., K] @ weight[N, K]^T -> [..., N]`` in ``x.dtype``
    (no bias). ``x`` and ``weight`` are already in the compute dtype."""
    k = x.shape[-1]
    a_q, a_scale = quantize_symmetric(x.reshape(-1, k), dim=-1)   # per token
    w_q, w_scale = quantize_symmetric(weight, dim=-1)            # per out-channel
    acc = int_mm(a_q, w_q.t())
    out = (acc.float() * a_scale) * w_scale.reshape(1, -1)
    return out.to(x.dtype).reshape(*x.shape[:-1], weight.shape[0])


class Int8TrainLinear(torch.autograd.Function):
    """The trainable W8A8 matmul: :func:`int8_linear` forward, SwitchBack
    backward (int8 grad-input, compute-dtype grad-weight, straight-through
    quantization)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        return int8_linear(x, weight)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight = ctx.saved_tensors
        n, k = weight.shape
        g2 = g.reshape(-1, n)
        # grad-input = g @ W: g per token, W [N, K] per input channel (its
        # columns: the JAX package's rhs^T quantized along axis 0)
        g_q, g_scale = quantize_symmetric(g2, dim=-1)
        w_q, w_scale = quantize_symmetric(weight, dim=0)
        d_x = (int_mm(g_q, w_q).float() * g_scale) * w_scale
        d_x = d_x.to(x.dtype).reshape(x.shape)
        # grad-weight = g^T @ x in the compute dtype (fp32 accumulation)
        d_w = (g2.t().to(x.dtype) @ x.reshape(-1, k)).to(weight.dtype)
        return d_x, d_w


def int8_train_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Differentiable W8A8 matmul (SwitchBack gradients); no bias."""
    return Int8TrainLinear.apply(x, weight)
