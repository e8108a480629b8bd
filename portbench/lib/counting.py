"""The benchmark's own count of operations and bytes, and the card's peaks.

Operations are counted at each row's valid frames (padding is not useful
work, so padding waste lowers the shares built on these counts), and only
for matrix products, convolutions and attention: a multiply-add is two
operations. The attention kernels' bounds follow the kernel table's bound
column: B1 (forward) ``4*H*Tq*Tk*D`` operations and bytes of q, k, v, o
and the key mask; B2 (backward) ``10*H*Tq*Tk*D`` and also dO, dq, dk, dv;
bf16 operations at the bf16 peak, fp32 ones as three TF32 products.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
HBM_BYTES_S = 3.35e12


@dataclass
class Work:
    flops: float = 0.0
    bytes: float = 0.0
    least_s: float = 0.0  # the larger of the two bounds, summed over calls

    def add(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes,
                    self.least_s + other.least_s)


def _bound(flops: float, nbytes: float, dtype: str) -> float:
    ops_s = 3 * flops / PEAK_TF32 if dtype == "float32" else flops / PEAK_BF16
    return max(ops_s, nbytes / HBM_BYTES_S)


def attention_call(rows_q: list[int], rows_k: list[int] | None, heads: int, head_dim: int,
                   backward: bool = False, dtype: str = "bfloat16") -> Work:
    """One B1 (or, ``backward``, B2) call over a batch whose row ``b`` has
    ``rows_q[b]`` query rows and ``rows_k[b]`` keys (default: the same)."""
    rows_k = rows_q if rows_k is None else rows_k
    esize = 4 if dtype == "float32" else 2
    per = 10 if backward else 4
    tensors_q, tensors_k = (4, 4) if backward else (2, 2)  # q,o(,dO,dq) / k,v(,dk,dv)
    flops = sum(per * heads * tq * tk * head_dim for tq, tk in zip(rows_q, rows_k))
    nbytes = sum((tensors_q * tq + tensors_k * tk) * heads * head_dim * esize + 4 * tk
                 for tq, tk in zip(rows_q, rows_k))
    return Work(flops, nbytes, _bound(flops, nbytes, dtype))


def conv_frames(cfg: dict, samples: int) -> list[int]:
    """Output frames of each frontend conv for ``samples`` input samples."""
    out, n = [], int(samples)
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
        out.append(max(n, 0))
    return out


def frontend_flops(cfg: dict, samples: int) -> float:
    flops, c_in = 0.0, 1
    for c, k, n in zip(cfg["conv_dim"], cfg["conv_kernel"], conv_frames(cfg, samples)):
        flops += 2.0 * c_in * c * k * n
        c_in = c
    return flops


def encoder_flops(cfg: dict, frames: int) -> float:
    """Feature projection, positional conv and the transformer stack, for
    one row of ``frames`` valid frames (attention over those frames)."""
    d, f, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    g = cfg["num_conv_pos_embedding_groups"]
    if cfg["pos_conv_type"] == "stacked":
        pos = cfg["num_conv_pos_embeddings"] * 2.0 * d * (d // g) * cfg["conv_pos_kernel_size"]
    else:
        pos = 2.0 * d * (d // g) * cfg["num_conv_pos_embeddings"]
    per_frame = 2.0 * cfg["conv_dim"][-1] * d + pos + layers * (8.0 * d * d + 4.0 * d * f)
    return frames * per_frame + layers * 4.0 * frames * frames * d


def train_step_flops(cfg: dict, frames: list[int]) -> float:
    """Forward and backward (three forwards) of the trained part, the
    encoder and the CTC head, from cached frontend features."""
    v, d = cfg["vocab_size"], cfg["hidden_size"]
    return 3.0 * sum(encoder_flops(cfg, t) + 2.0 * d * v * t for t in frames)


def serve_forward_flops(cfg: dict, samples: list[int]) -> float:
    """Stage-2 forward of each request: frontend, encoder, the arbitrator,
    the CTC head on the lm-masked stream and the AD head on the AD-masked
    one."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    total = 0.0
    for n in samples:
        t = conv_frames(cfg, n)[-1]
        total += frontend_flops(cfg, n) + encoder_flops(cfg, t) + 2.0 * d * (4 * d + v + 2) * t
    return total
