// The wide positional convolution of the wav2vec2 family for Hopper (sm_90a):
// Conv1d(D, D, K, padding=K/2, groups=G), its last frame dropped where K is
// even, then GELU, for ops/pos_conv.py's pos_conv_gelu on bf16 CUDA tensors.
//
// Replaces no TPU kernel: the JAX package leaves this convolution to XLA
// (privacy_preserve_federated_asr_tpu/models/backbone.py, PositionalConvEmbedding,
// lax.conv_general_dilated through flax's nn.Conv), and the port's plain
// version is F.conv1d -> crop -> F.gelu (ops/pos_conv.py::pos_conv_gelu_plain).
// On the card that call goes to cuDNN, whose kernels for 16 groups of 120
// channels and 128 taps in bf16 are its legacy direct ones, without the
// tensor cores: ~310 ms for the forward and backward at XLS-R 2B's B=8,
// T=749 against ~1 ms of work.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): each of the
// three products (forward, input gradient, weight gradient) is
// 2 B T D Cg K operations (3.5e11 at B=8, T=749, D=1920, Cg=120, K=128:
// 0.36 ms) against ~23 MB for each of x, y, dy and 59 MB of bf16 weight
// (~0.05 ms of bytes), so the tensor cores bound it.
//
// Layouts. x, y, pre (the conv before GELU), dy, dx and dz (dy times GELU'
// of pre) are [B, T, D] bf16, contiguous; a group's Cg channels are Cg
// consecutive columns. Cg is a multiple of 8 up to 128 and is padded to P
// (64 or 128) columns in shared memory, zero past Cg, so every product over
// the padding adds exact zeros. The weight is read by the weight kernel
// (in the forward, and again in the backward rather than held between them)
// from the fp32 parameter [D, Cg, K] into bf16 tap-major tiles
// wp [G][K][P/8][P][8]: for each (group, tap) a P x P tile whose 16-byte
// chunk (c, co) holds input channels 8c..8c+7 of output channel co.
//
// Shared-memory tiles use wgmma's no-swizzle layout of 8 x 16-byte core
// matrices: a tile of R rows and P columns is P/8 column chunks, each R
// consecutive rows of 16 bytes ([P/8][R][16 B]). Any row offset is then a
// 16-byte step of the descriptor's start address, which is what lets one
// window of R = 128 + K - 1 frames serve all K taps of a convolution: tap j
// reads rows j..j+127 of it. The window's frames outside [0, T) are
// zero-filled on load, which is the convolution's zero padding; computing T
// output frames drops the last one where K is even (padding (K/2, K/2 - 1)).
//
// Kernels:
//   * forward and input gradient: one template, an implicit GEMM per block
//     of 128 output frames of one batch row and one group (M = 128 frames,
//     N = P output channels, K = taps x P input channels). The window is
//     loaded once (x with cp.async; for the input gradient dz = dy GELU'(pre)
//     is computed as dy and pre are loaded, and the block's own 128 frames of
//     dz are written out for the weight gradient); the weight tiles stream
//     through a ring of bulk copies (TMA, cp.async.bulk) on mbarriers filled
//     by a producer warp; two consumer warpgroups of wgmma m64nPk16 with fp32
//     accumulators. The input gradient is the same convolution with the taps
//     flipped (pad K - 1 - K/2) over dz, reading each weight tile transposed
//     (MN-major, wgmma's transpose bit). The forward's epilogue adds the bias
//     and writes pre and GELU(pre). The grid runs the frames and batch rows
//     of one group before the next, so a group's weight stays in L2.
//   * weight gradient: dW[co, ci, j] = sum over (b, t) of dz[b, t, co]
//     x[b, t + j - K/2, ci], per block one group and 256 / P taps over all
//     B x T rows in chunks of 64 frames (a cp.async ring), so every block
//     owns its outputs whole: no atomics and no second pass, and two calls
//     give the same bits. The accumulators are fp32 and written straight into
//     the fp32 gradient; the group's first block also sums dz over the rows
//     into the bias gradient, in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::cp_async16;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::fence_acc;
using flash::fence_proxy_async;
using flash::pack_bf16;
using flash::smem_u32;
using flash::wgmma_commit;
using flash::wgmma_fence;
using flash::wgmma_wait;

constexpr int kBM = 128;          // output frames of a forward / input-gradient block
constexpr int kBT = 64;           // frames of a weight-gradient chunk
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kMaxTaps = 256;
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr float kAlpha = 0.70710678118654752440f;  // 1 / sqrt(2)
constexpr float kBeta = 0.39894228040143267794f;   // 1 / sqrt(2 pi)

__host__ __device__ constexpr int padded(int cg) { return cg <= 64 ? 64 : 128; }
__host__ __device__ constexpr int round8(int x) { return (x + 7) / 8 * 8; }
__host__ __device__ constexpr int window_rows(int k) { return round8(kBM + k - 1); }

template <int P>
struct Conv {
  static constexpr int kStages = P == 128 ? 4 : 8;
  static constexpr int kTileBytes = P * P * 2;
  static constexpr int smem_bytes(int k) {
    return window_rows(k) * P * 2 + kStages * kTileBytes + 2 * kStages * 8;
  }
};

template <int P>
struct Wgrad {
  static constexpr int kStages = 4;
  static constexpr int kTaps = 256 / P;  // two m64 accumulators a warpgroup: 2 (P = 128) or 4
  static constexpr int kXRows = round8(kBT + kTaps - 1);
  static constexpr int kDzBytes = P * kBT * 2, kXBytes = P * kXRows * 2;
  static constexpr int kStageBytes = kDzBytes + kXBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes;
};

// ---------------------------------------------------------------------------
// wgmma on no-swizzle tiles
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle (layout type 0): the start
// address, the byte step between the two 8-element core matrices of a k16
// step along K (leading byte offset) and between 8-row core-matrix groups
// along M or N (stride byte offset), both in either major.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t k_step, uint32_t mn_step) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(k_step >> 4) << 16) |
         ((uint64_t)(mn_step >> 4) << 32);
}

// D[64 x 64] (+)= A . B; `accumulate` = 0 overwrites D
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  flash::wgmma_ss_n64<TA, TB>(d, da, db, accumulate);
}

#define POS_CONV_ACC4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// D[64 x 128] (+)= A . B, both from shared memory; TA / TB = 1: that operand
// is MN-major; `accumulate` = 0 overwrites D. D[j][i] is the accumulator layout of mma.sync, warp w of the
// warpgroup holding rows 16w..16w+15.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : POS_CONV_ACC4(0), POS_CONV_ACC4(1), POS_CONV_ACC4(2), POS_CONV_ACC4(3),
        POS_CONV_ACC4(4), POS_CONV_ACC4(5), POS_CONV_ACC4(6), POS_CONV_ACC4(7),
        POS_CONV_ACC4(8), POS_CONV_ACC4(9), POS_CONV_ACC4(10), POS_CONV_ACC4(11),
        POS_CONV_ACC4(12), POS_CONV_ACC4(13), POS_CONV_ACC4(14), POS_CONV_ACC4(15)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

#undef POS_CONV_ACC4

// ---------------------------------------------------------------------------
// mbarriers and bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` global -> shared in one bulk copy, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---------------------------------------------------------------------------
// windows of frames
// ---------------------------------------------------------------------------

// Item i of a [P/8][rows][16 B] window: row r, chunk c. A warp takes 8 rows
// by 4 chunks, so its global reads are 64 contiguous bytes of each of 8 rows
// and each 8 lanes of it write 128 contiguous bytes of shared memory.
template <int P>
__device__ __forceinline__ void item_pos(int i, int& r, int& c) {
  constexpr int kGroups = P / 32;
  const int lane = i & 31, w = i >> 5;
  r = (w / kGroups) * 8 + (lane & 7);
  c = (w % kGroups) * 4 + (lane >> 3);
}

// rows [0, rows) of a window whose row r is frame time0 + r of `src` (one
// batch row's group columns, frames `ld` elements apart) -> the window at
// `dst`; frames outside [0, T) and chunks from `nch` on are zero-filled
template <int P, int NT>
__device__ __forceinline__ void load_window_async(uint32_t dst, const bf16* src, long long ld,
                                                  int time0, int rows, int T, int nch,
                                                  int tid) {
  const int items = rows * (P / 8);
  for (int i = tid; i < items; i += NT) {
    int r, c;
    item_pos<P>(i, r, c);
    const int t = time0 + r;
    const bool in = t >= 0 && t < T && c < nch;
    cp_async16(dst + (uint32_t)(c * rows + r) * 16, src + (in ? (long long)t * ld + c * 8 : 0),
               in ? 16 : 0);
  }
}

// torch's GELU and its gradient (approximate="none"), in fp32
__device__ __forceinline__ float gelu(float x) { return x * 0.5f * (1.f + erff(x * kAlpha)); }

__device__ __forceinline__ float gelu_grad(float dy, float x) {
  const float cdf = 0.5f * (1.f + erff(x * kAlpha));
  const float pdf = expf(-0.5f * x * x) * kBeta;
  return dy * (cdf + x * pdf);
}

__device__ __forceinline__ uint32_t gelu_grad2(uint32_t dy, uint32_t pre) {
  const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dy));
  const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pre));
  return pack_bf16(gelu_grad(g.x, p.x), gelu_grad(g.y, p.y));
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w) : "memory");
}

// The input gradient's window: dz = bf16(dy GELU'(pre)) of frames time0 +
// r, zero outside [0, T) and past chunk `nch`; rows [own0, own1) are the
// block's own frames, also written to `dz` for the weight gradient.
template <int P>
__device__ __forceinline__ void gelu_grad_window(uint32_t dst, const bf16* __restrict__ dy,
                                                 const bf16* __restrict__ pre,
                                                 bf16* __restrict__ dz, long long ld, int time0,
                                                 int rows, int T, int nch, int own0, int own1,
                                                 int tid) {
  constexpr int kUnroll = 4;
  const int items = rows * (P / 8);
  for (int i0 = tid; i0 < items; i0 += kUnroll * kConsumers) {
    uint4 g[kUnroll], p[kUnroll];
    long long off[kUnroll];
    int rr[kUnroll], cc[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {  // every load first, then the arithmetic
      const int i = i0 + q * kConsumers;
      item_pos<P>(i, rr[q], cc[q]);
      const int t = time0 + rr[q];
      in[q] = i < items && t >= 0 && t < T && cc[q] < nch;
      off[q] = in[q] ? (long long)t * ld + cc[q] * 8 : 0;
      g[q] = p[q] = make_uint4(0, 0, 0, 0);
      if (in[q]) {
        g[q] = __ldg(reinterpret_cast<const uint4*>(dy + off[q]));
        p[q] = __ldg(reinterpret_cast<const uint4*>(pre + off[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (i0 + q * kConsumers >= items) continue;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (in[q]) {
        v = make_uint4(gelu_grad2(g[q].x, p[q].x), gelu_grad2(g[q].y, p[q].y),
                       gelu_grad2(g[q].z, p[q].z), gelu_grad2(g[q].w, p[q].w));
        if (rr[q] >= own0 && rr[q] < own1) *reinterpret_cast<uint4*>(dz + off[q]) = v;
      }
      st_shared16(dst + (uint32_t)(cc[q] * rows + rr[q]) * 16, v);
    }
  }
}

// ---------------------------------------------------------------------------
// forward (kDgrad false) and input gradient (kDgrad true)
// ---------------------------------------------------------------------------
//
// forward:  in = x, out = y = GELU(pre), aux = pre, pad = K/2
// gradient: in = dy, pre_in = pre, out = dx, aux = dz, pad = K - 1 - K/2
template <int P, bool kDgrad>
__global__ void __launch_bounds__(kConsumers + 32, 1)
    pos_conv_kernel(const bf16* __restrict__ in, const bf16* __restrict__ pre_in,
                    const bf16* __restrict__ wp, const float* __restrict__ bias,
                    bf16* __restrict__ out, bf16* __restrict__ aux, int T, int G, int cg, int K,
                    int pad) {
  constexpr int S = Conv<P>::kStages;
  constexpr uint32_t kTile = Conv<P>::kTileBytes;
  extern __shared__ __align__(128) uint8_t smem[];
  const int wr = window_rows(K);
  const uint32_t win = smem_u32(smem), ring = win + wr * P * 2, bars = ring + S * kTile;
  const int tid = threadIdx.x, lane = tid & 31;
  const int t0 = blockIdx.x * kBM, b = blockIdx.y, g = blockIdx.z, D = G * cg;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);                       // full: the producer's expect_tx
      mbar_init(bars + 8 * (S + s), kConsumers / 32);  // empty: one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one lane streams the weight tiles
    if (lane == 0) {
      const bf16* w = wp + (long long)g * K * P * P;
      for (int i = 0; i < K; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(bars + 8 * (S + s), (i / S - 1) & 1);
        mbar_expect_tx(bars + 8 * s, kTile);
        bulk_load(ring + s * kTile, w + (long long)(kDgrad ? K - 1 - i : i) * P * P, kTile,
                  bars + 8 * s);
      }
    }
    return;
  }

  const long long row0 = (long long)b * T * D + (long long)g * cg;
  if (kDgrad) {
    gelu_grad_window<P>(win, in + row0, pre_in + row0, aux + row0, D, t0 - pad, wr, T, cg / 8,
                        pad, pad + kBM, tid);
  } else {
    load_window_async<P, kConsumers>(win, in + row0, D, t0 - pad, wr, T, cg / 8, tid);
    cp_async_commit();
    cp_async_wait<0>();
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");  // the consumers only

  const int wg = tid >> 7;
  float acc[P / 8][4];  // written first by the first product (accumulate 0)
  for (int i = 0; i < K; ++i) {
    const int s = i % S;
    mbar_wait(bars + 8 * s, (i / S) & 1);
    wgmma_fence();
    const uint32_t tile = ring + s * kTile;
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) {
      // A: frames i + 64 wg .. of the window, channels 16kk..16kk+15 (K-major)
      const uint64_t da = desc(win + (uint32_t)(2 * kk * wr + i + 64 * wg) * 16, wr * 16, 128);
      const int accumulate = i > 0 || kk > 0;
      if (kDgrad)  // B[co, ci]: output channels are k, the tile read transposed
        wgmma_ss<0, 1>(acc, da, desc(tile + kk * 256, 128, P * 16), accumulate);
      else  // B[ci, co]: input channels are k
        wgmma_ss<0, 0>(acc, da, desc(tile + 2 * kk * P * 16, P * 16, 128), accumulate);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tap's products are done: release its tile
    if (i > 0 && lane == 0) mbar_arrive(bars + 8 * (S + (i - 1) % S));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  const int wq = (tid >> 5) & 3;
#pragma unroll
  for (int j = 0; j < P / 8; ++j) {
    const int co = 8 * j + 2 * (lane & 3);
    if (co >= cg) continue;
    float b0 = 0.f, b1 = 0.f;  // the bias as bf16 holds it
    if (!kDgrad && bias != nullptr) {
      b0 = __bfloat162float(__float2bfloat16(bias[g * cg + co]));
      b1 = __bfloat162float(__float2bfloat16(bias[g * cg + co + 1]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + 64 * wg + 16 * wq + (lane >> 2) + 8 * h;
      if (t >= T) continue;
      const long long o = row0 + (long long)t * D + co;
      if (kDgrad) {
        *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(acc[j][2 * h] + b0, acc[j][2 * h + 1] + b1);
        const float2 pf = __bfloat1622float2(pr);
        *reinterpret_cast<__nv_bfloat162*>(aux + o) = pr;
        *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(gelu(pf.x), gelu(pf.y));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradient
// ---------------------------------------------------------------------------
//
// Block (tap group, group): taps tap0 .. tap0 + kTaps - 1. Warpgroup wg owns
// output channels 64 cb .. 64 cb + 63 (cb = wg % (P / 64)) of taps tap0 + tl0
// and tap0 + tl0 + 1 (tl0 = 2 (wg / (P / 64))): two m64 x nP accumulators,
// A = dz^T (M = output channels, K = frames) and B = the shifted x window
// (K = frames, N = input channels), both MN-major.
template <int P>
__global__ void __launch_bounds__(kConsumers, 1)
    pos_conv_wgrad_kernel(const bf16* __restrict__ dz, const bf16* __restrict__ x,
                          float* __restrict__ dw, float* __restrict__ db, int B, int T, int G,
                          int cg, int K, int pad) {
  using W = Wgrad<P>;
  constexpr int S = W::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7, wq = (tid >> 5) & 3;
  const int tap0 = blockIdx.x * W::kTaps, g = blockIdx.y, D = G * cg;
  const int nct = (T + kBT - 1) / kBT, nc = B * nct;
  const long long col = (long long)g * cg;

  auto load = [&](int c) {
    if (c < nc) {
      const int b = c / nct, t = (c % nct) * kBT;
      const uint32_t st = base + (c % S) * W::kStageBytes;
      const long long row0 = (long long)b * T * D + col;
      load_window_async<P, kConsumers>(st, dz + row0, D, t, kBT, T, cg / 8, tid);
      load_window_async<P, kConsumers>(st + W::kDzBytes, x + row0, D, t + tap0 - pad,
                                       W::kXRows, T, cg / 8, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // the bias gradient: the group's first block, kPer threads a channel
  constexpr int kPer = kConsumers / P, kRowsPer = kBT / kPer;
  const bool sum_bias = db != nullptr && blockIdx.x == 0;
  const int bco = tid % P, bpart = tid / P;
  float bsum = 0.f;

  const int cb = wg % (P / 64), tl0 = 2 * (wg / (P / 64));
  float acc[2][P / 8][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < P / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;

  for (int c = 0; c < S - 2; ++c) load(c);
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<S - 3>();  // chunk c has landed
    fence_proxy_async();
    __syncthreads();          // ... for every thread; chunk c - 2's products are done
    load(c + S - 2);          // into chunk c - 2's stage
    const uint32_t st = base + (c % S) * W::kStageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {
      // A[co, t]: output channels 64 cb.., frames 16kk.. of the dz chunk
      const uint64_t da = desc(st + (uint32_t)(8 * cb * kBT + 16 * kk) * 16, 128, kBT * 16);
#pragma unroll
      for (int u = 0; u < 2; ++u)  // B[t, ci]: window rows tl0 + u + 16kk..
        wgmma_ss<1, 1>(acc[u], da,
                       desc(st + W::kDzBytes + (uint32_t)(tl0 + u + 16 * kk) * 16, 128,
                            W::kXRows * 16),
                       1);
    }
    wgmma_commit();
    if (sum_bias) {
      const uint8_t* p = smem + (c % S) * W::kStageBytes +
                         ((bco >> 3) * kBT + bpart * kRowsPer) * 16 + (bco & 7) * 2;
#pragma unroll 8
      for (int r = 0; r < kRowsPer; ++r)
        bsum += __bfloat162float(*reinterpret_cast<const bf16*>(p + r * 16));
    }
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);

  const int tap = tap0 + tl0;
#pragma unroll
  for (int j = 0; j < P / 8; ++j) {
    const int ci = 8 * j + 2 * (lane & 3);
    if (ci >= cg) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = 64 * cb + 16 * wq + (lane >> 2) + 8 * h;
      if (co >= cg) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* d = dw + ((long long)(g * cg + co) * cg + ci + e) * K + tap;
        const float v0 = acc[0][j][2 * h + e], v1 = acc[1][j][2 * h + e];
        if (K % 2 == 0 && tap + 1 < K) {  // tap even: 8-byte aligned
          *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
        } else {
          if (tap < K) d[0] = v0;
          if (tap + 1 < K) d[1] = v1;
        }
      }
    }
  }

  if (sum_bias) {  // block-uniform
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
    red[tid] = bsum;
    __syncthreads();
    if (tid < cg) {
      float s = 0.f;
      for (int q = 0; q < kPer; ++q) s += red[q * P + tid];
      db[g * cg + tid] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// the weight as bf16 tap-major tiles
// ---------------------------------------------------------------------------
//
// w [G cg][cg][K] fp32 -> wp [G][K][P/8][P][8] bf16, zero past cg. Block
// (32 taps, 32 output channels, (group, chunk c)): reads 128 contiguous
// bytes of taps per (co, ci), writes 32 x 16 contiguous bytes per tap.
template <int P>
__global__ void __launch_bounds__(256) pos_conv_weight_kernel(const float* __restrict__ w,
                                                              bf16* __restrict__ wp, int cg,
                                                              int K) {
  __shared__ float tile[32][8][33];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tb = blockIdx.x * 32, cob = blockIdx.y * 32;
  const int g = blockIdx.z / (P / 8), c = blockIdx.z % (P / 8);
  for (int r = warp; r < 256; r += 8) {
    const int co = cob + r / 8, ci = c * 8 + r % 8, tap = tb + lane;
    tile[r / 8][r % 8][lane] = co < cg && ci < cg && tap < K
                                   ? w[((long long)(g * cg + co) * cg + ci) * K + tap]
                                   : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < 32 * 32; i += 256) {
    const int tl = i / 32, col = i % 32, tap = tb + tl, co = cob + col;
    if (tap >= K) continue;
    const float* v = &tile[col][0][tl];
    const uint4 q = make_uint4(pack_bf16(v[0], v[33]), pack_bf16(v[2 * 33], v[3 * 33]),
                               pack_bf16(v[4 * 33], v[5 * 33]), pack_bf16(v[6 * 33], v[7 * 33]));
    *reinterpret_cast<uint4*>(wp + (((long long)g * K + tap) * (P / 8) + c) * P * 8 + co * 8) = q;
  }
}

bool shape_ok(int B, int T, int G, int cg, int K) {
  return B > 0 && T > 0 && G > 0 && cg >= 8 && cg <= 128 && cg % 8 == 0 && K > 0 &&
         K <= kMaxTaps;
}

template <int P>
int launch_weight(const float* w, bf16* wp, int G, int cg, int K, cudaStream_t st) {
  const dim3 grid((K + 31) / 32, P / 32, G * (P / 8));
  pos_conv_weight_kernel<P><<<grid, 256, 0, st>>>(w, wp, cg, K);
  return (int)cudaGetLastError();
}

template <int P, bool kDgrad>
int launch_conv(const bf16* in, const bf16* pre, const bf16* wp, const float* bias, bf16* out,
                bf16* aux, int B, int T, int G, int cg, int K, cudaStream_t st) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(pos_conv_kernel<P, kDgrad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Conv<P>::smem_bytes(kMaxTaps));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((T + kBM - 1) / kBM, B, G);
  const int pad = kDgrad ? K - 1 - K / 2 : K / 2;
  pos_conv_kernel<P, kDgrad><<<grid, kConsumers + 32, Conv<P>::smem_bytes(K), st>>>(
      in, pre, wp, bias, out, aux, T, G, cg, K, pad);
  return (int)cudaGetLastError();
}

template <int P>
int launch_wgrad(const bf16* dz, const bf16* x, float* dw, float* db, int B, int T, int G,
                 int cg, int K, cudaStream_t st) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(pos_conv_wgrad_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Wgrad<P>::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((K + Wgrad<P>::kTaps - 1) / Wgrad<P>::kTaps, G);
  pos_conv_wgrad_kernel<P><<<grid, kConsumers, Wgrad<P>::kSmemBytes, st>>>(dz, x, dw, db, B, T,
                                                                          G, cg, K, K / 2);
  return (int)cudaGetLastError();
}

static_assert(Conv<128>::smem_bytes(kMaxTaps) <= kMaxSmem, "the window and ring fit");
static_assert(Conv<64>::smem_bytes(kMaxTaps) <= kMaxSmem, "the window and ring fit");
static_assert(Wgrad<128>::kSmemBytes <= kMaxSmem && Wgrad<64>::kSmemBytes <= kMaxSmem,
              "the chunk ring fits");

}  // namespace

// Plain C entry points (bound with ctypes). Shapes: x, y, pre, dy, dx, dz
// [B, T, G cg] bf16; the weight [G cg, cg, K] fp32 and its gradient; bias
// and its gradient [G cg] fp32 (null: none); wp [G, K, P/8, P, 8] bf16 with
// P = 64 for cg <= 64, else 128. cg is a multiple of 8 up to 128 and K at
// most 256; anything else returns cudaErrorInvalidValue. Each launches on
// `stream`, does not synchronise, and returns cudaGetLastError().

extern "C" int pos_conv_weight(const void* w, void* wp, int G, int cg, int K, void* stream) {
  if (!shape_ok(1, 1, G, cg, K)) return (int)cudaErrorInvalidValue;
  const auto* wf = static_cast<const float*>(w);
  auto* wb = static_cast<bf16*>(wp);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return padded(cg) == 64 ? launch_weight<64>(wf, wb, G, cg, K, st)
                          : launch_weight<128>(wf, wb, G, cg, K, st);
}

// y = GELU(pre), pre = conv(x) + bias (bf16), T frames
extern "C" int pos_conv_fwd(const void* x, const void* wp, const void* bias, void* y, void* pre,
                            int B, int T, int G, int cg, int K, void* stream) {
  if (!shape_ok(B, T, G, cg, K)) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(wp);
  const auto* bf = static_cast<const float*>(bias);
  auto* yb = static_cast<bf16*>(y);
  auto* pb = static_cast<bf16*>(pre);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return padded(cg) == 64
             ? launch_conv<64, false>(xb, nullptr, wb, bf, yb, pb, B, T, G, cg, K, st)
             : launch_conv<128, false>(xb, nullptr, wb, bf, yb, pb, B, T, G, cg, K, st);
}

// dz = dy GELU'(pre) (bf16) and dx = the convolution's input gradient of dz
extern "C" int pos_conv_dgrad(const void* dy, const void* pre, const void* wp, void* dx,
                              void* dz, int B, int T, int G, int cg, int K, void* stream) {
  if (!shape_ok(B, T, G, cg, K)) return (int)cudaErrorInvalidValue;
  const auto* gb = static_cast<const bf16*>(dy);
  const auto* pb = static_cast<const bf16*>(pre);
  const auto* wb = static_cast<const bf16*>(wp);
  auto* xb = static_cast<bf16*>(dx);
  auto* zb = static_cast<bf16*>(dz);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return padded(cg) == 64
             ? launch_conv<64, true>(gb, pb, wb, nullptr, xb, zb, B, T, G, cg, K, st)
             : launch_conv<128, true>(gb, pb, wb, nullptr, xb, zb, B, T, G, cg, K, st);
}

// dw [G cg, cg, K] and db [G cg] (null: none), fp32, each element written once
extern "C" int pos_conv_wgrad(const void* dz, const void* x, void* dw, void* db, int B, int T,
                              int G, int cg, int K, void* stream) {
  if (!shape_ok(B, T, G, cg, K)) return (int)cudaErrorInvalidValue;
  const auto* zb = static_cast<const bf16*>(dz);
  const auto* xb = static_cast<const bf16*>(x);
  auto* wf = static_cast<float*>(dw);
  auto* bf = static_cast<float*>(db);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return padded(cg) == 64 ? launch_wgrad<64>(zb, xb, wf, bf, B, T, G, cg, K, st)
                          : launch_wgrad<128>(zb, xb, wf, bf, B, T, G, cg, K, st);
}
