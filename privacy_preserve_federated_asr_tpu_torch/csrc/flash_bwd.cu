// Flash-attention backward for Hopper (sm_90a), kernel B2 of the port.
//
// Replaces the TPU kernel privacy_preserve_federated_asr_tpu/ops/attention.py
// ::_bwd_kernel (launched by _flash_bwd_call): the recompute backward of
// softmax(q k^T / sqrt(D)) v with masked keys REPLACED by -1e30 and the
// counter-based attention dropout of the forward (kernel B1, flash_fwd.cu):
//   p     = exp(s' - lse)                 (s' the replaced scores; lse saved by B1)
//   keep  = (fmix32((row * t_hash + col) ^ seed_bh) & 0x7FFFFFFF) >= threshold
//   A     = keep * p * inv_keep            dV = A^T dO
//   dP    = keep * (dO V^T) * inv_keep     delta = rowsum(dO * O)
//   dS    = p * (dP - delta)               dQ = dS K * scale,  dK = dS^T q * scale
// The TPU kernel recomputes the row statistics per q block; here B1 saves
// lse = m + log(l) per row (fp32 [B, H, T]), which changes no math: the
// denominator is the UNdropped row sum either way. dS is not zeroed at masked
// keys, exactly like the TPU kernel (p is 0 there for every row with a key;
// a row with no key has p = 1/T on every key, as in B1 and the plain version).
//
// Layout: q, k, v, o and dO are [B, T, H, D] read through strides (the D
// axis contiguous); dq, dk, dv are written contiguous [B, T, H, D]. Keys and
// queries past T are excluded inside the kernels (no padding to a block).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the minimal work
// is 10*B*H*T^2*D FLOPs (S, dP, dV, dQ, dK, two of them counted twice in
// the FA2 split below) against reading q, k, v, o, dO and writing dq, dk,
// dv. At the training shape (B=16, H=16, T=249) that is 1.0e10 FLOP against
// 65 MB: bytes bound it at about 20 us. At B=8, T=1499 it is 1.8e11 FLOP
// against 196 MB: operations bound it at about 186 us.
//
// Design, a simple first one (FA2's split, no atomics, so the gradients are
// deterministic):
//   1. flash_bwd_delta: delta = rowsum(dO * O), one warp per row;
//   2. flash_bwd_dkdv: one block of 4 warps per (64-key tile, b*h); each warp
//      owns 16 keys and loops over 64-query tiles, computing S^T and dP^T on
//      mma.sync m16n8k16 bf16 with fp32 accumulators, then dV += A^T dO and
//      dK += dS^T q with A^T and dS^T re-packed in registers as A operands;
//   3. flash_bwd_dq: one block per (64-query tile, b*h) looping over key
//      tiles, recomputing S and dP and accumulating dQ += dS K.
// S and dP are recomputed by both passes (14 instead of 10 B*H*T^2*D FLOPs).
// Tiles are staged through shared memory synchronously (no TMA, wgmma or
// warp specialisation). The fp32 path (tests, and the card-vs-CPU check) is
// the same split on plain FMA, one thread per key or query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;               // head dim (the only one supported)
constexpr float kMaskFill = -1e30f;  // NEG_INF of the TPU kernel
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Strides {
  long long b, t, h;  // in elements; the D stride is 1
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool keep_elem(uint32_t seed_bh, uint32_t row,
                                          uint32_t col, uint32_t t_hash,
                                          uint32_t threshold) {
  return (fmix32((row * t_hash + col) ^ seed_bh) & 0x7FFFFFFFu) >= threshold;
}

// scaled score after the mask replacement: code 1 valid, 0 masked, -1 past T
__device__ __forceinline__ float replace_masked(float x, int code, float fill) {
  return code > 0 ? x : (code == 0 ? fill : -CUDART_INF_F);
}

// What p = exp(s' - lse) needs of one (b, h): the masked keys' score and the
// LSE of a row < T. B1 saves exactly kMaskFill as the LSE of a row whose
// keys are all masked (flash_fwd.cu row_lse), and the key mask is one per
// sequence, so then every row of this (b, h) has no key, and B1 weighs each
// of its T keys 1/T. There the masked keys score 0 against an LSE of log(T),
// which gives that 1/T with no test per score.
struct NoKeyShift {
  bool none;    // no row of this (b, h) has a key
  float fill;   // the masked keys' replaced score
  float log_t;
  __device__ NoKeyShift(const float* lse_bh, int T)
      : none(lse_bh[0] == kMaskFill), fill(none ? 0.f : kMaskFill),
        log_t(logf((float)T)) {}
  __device__ float lse(const float* lse_bh, int row) const {
    return none ? log_t : lse_bh[row];
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), fp32 [B, H, T]
// ---------------------------------------------------------------------------

template <typename T_>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T_* __restrict__ o, const T_* __restrict__ dout,
                       float* __restrict__ delta, int T, int H, long long rows,
                       Strides os, Strides ds) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long bh = row / T;
  const int t = (int)(row - bh * T);
  const int b = (int)(bh / H), h = (int)(bh - (long long)b * H);
  const T_* orow = o + b * os.b + (long long)t * os.t + h * os.h;
  const T_* drow = dout + b * ds.b + (long long)t * ds.t + h * ds.h;
  float acc = to_f32(orow[lane]) * to_f32(drow[lane]) +
              to_f32(orow[lane + 32]) * to_f32(drow[lane + 32]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // queries per tile
constexpr int kBK = 64;       // keys per tile
constexpr int kLds = kD + 8;  // smem row stride (bf16): conflict-free fragments

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 64 rows of a [T, D] slice (row stride `rs`) starting at row0 -> smem, rows
// past T zero; `nat` holds it as [row][d], `tr` (if given) as [d][row].
__device__ __forceinline__ void load_tile(const __nv_bfloat16* base, long long rs,
                                          int row0, int T,
                                          __nv_bfloat16 (*nat)[kLds],
                                          __nv_bfloat16 (*tr)[kLds], int tid) {
  for (int c = tid; c < 64 * kD / 8; c += 128) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < T)
      val = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * rs + col);
    if (nat != nullptr) *reinterpret_cast<uint4*>(&nat[r][col]) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[col + j][r] = e[j];
    }
  }
}

// A fragments (16 rows x 64 d) of smem rows r0..r0+15
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kD / 16][4],
                                             __nv_bfloat16 (*s)[kLds], int r0,
                                             int g, int t4) {
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    a[kc][0] = lds32(&s[r0 + g][kc * 16 + t4 * 2]);
    a[kc][1] = lds32(&s[r0 + g + 8][kc * 16 + t4 * 2]);
    a[kc][2] = lds32(&s[r0 + g][kc * 16 + 8 + t4 * 2]);
    a[kc][3] = lds32(&s[r0 + g + 8][kc * 16 + 8 + t4 * 2]);
  }
}

// c[nt] = A (16 x 64 d) . X^T for the 64 smem rows of X, 8 per n-tile
__device__ __forceinline__ void mma_rows(float (&c)[8][4],
                                         const uint32_t (&a)[kD / 16][4],
                                         __nv_bfloat16 (*x)[kLds], int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc)
      mma_bf16(c[nt], a[kc], lds32(&x[nt * 8 + g][kc * 16 + t4 * 2]),
               lds32(&x[nt * 8 + g][kc * 16 + 8 + t4 * 2]));
  }
}

// acc[dn] += P (16 x 64, the accumulator tile p re-packed as A) . Y (64 x D),
// Y given transposed in smem as yt[d][row]
__device__ __forceinline__ void mma_acc(float (&acc)[kD / 8][4], const float (&p)[8][4],
                                        __nv_bfloat16 (*yt)[kLds], int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      mma_bf16(acc[dn], pa, lds32(&yt[dn * 8 + g][kk * 16 + t4 * 2]),
               lds32(&yt[dn * 8 + g][kk * 16 + 8 + t4 * 2]));
  }
}

// rows r (g, g+8) of a 16 x 64 accumulator tile, times f, -> bf16 rows
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[kD / 8][4],
                                           const int (&rows)[2], int b, int h,
                                           int T, int H, float f, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    __nv_bfloat16* orow = out + ((long long)b * T + rows[r]) * ((long long)H * kD) +
                          (long long)h * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + t4 * 2) =
          pack_bf16(acc[dn][2 * r] * f, acc[dn][2 * r + 1] * f);
  }
}

__global__ void __launch_bounds__(128)
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ key_mask,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int T, int H,
                           Strides qs, Strides ks, Strides vs, Strides ds,
                           float scale, uint32_t seed, uint32_t t_hash,
                           uint32_t threshold, float inv_keep) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBQ][kLds];  // q tile [query][d]
  __shared__ __align__(16) __nv_bfloat16 Qt[kD][kLds];   // q tile [d][query]
  __shared__ __align__(16) __nv_bfloat16 Ds[kBQ][kLds];  // dO tile [query][d]
  __shared__ __align__(16) __nv_bfloat16 Dt[kD][kLds];   // dO tile [d][query]
  __shared__ float lse_s[kBQ], delta_s[kBQ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBK;
  const int r0 = warp * 16;
  const uint32_t seed_bh = fmix32(seed + (uint32_t)bh * kGolden);

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* db = dout + b * ds.b + h * ds.h;
  const float* lse_b = lse + (long long)bh * T;
  const float* delta_b = delta + (long long)bh * T;
  const NoKeyShift nk(lse_b, T);

  // this block's K and V tiles (staged through Qs / Ds) -> A fragments
  load_tile(kb, ks.t, k0, T, Qs, nullptr, tid);
  load_tile(vb, vs.t, k0, T, Ds, nullptr, tid);
  __syncthreads();
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  load_a_frags(ka, Qs, r0, g, t4);
  load_a_frags(va, Ds, r0, g, t4);

  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  int kcode[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kcode[r] = keys[r] < T ? (key_mask[(long long)b * T + keys[r]] > 0 ? 1 : 0) : -1;

  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = 0; q0 < T; q0 += kBQ) {
    __syncthreads();  // fragments taken / previous tile consumed
    load_tile(qb, qs.t, q0, T, Qs, Qt, tid);
    load_tile(db, ds.t, q0, T, Ds, Dt, tid);
    if (tid < kBQ) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < T ? nk.lse(lse_b, qi) : CUDART_INF_F;  // p = 0 past T
      delta_s[tid] = qi < T ? delta_b[qi] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];  // S^T and dP^T: 16 keys x 64 queries
    mma_rows(st, ka, Qs, g, t4);
    mma_rows(dpt, va, Ds, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1, qc = nt * 8 + t4 * 2 + (j & 1);
        const float p =
            __expf(replace_masked(st[nt][j] * scale, kcode[r], nk.fill) - lse_s[qc]);
        float a = p, dp = dpt[nt][j];
        if (threshold) {
          const bool keep = keep_elem(seed_bh, (uint32_t)(q0 + qc), (uint32_t)keys[r],
                                      t_hash, threshold);
          a = keep ? p * inv_keep : 0.f;
          dp = keep ? dp * inv_keep : 0.f;
        }
        st[nt][j] = a;                        // A^T
        dpt[nt][j] = p * (dp - delta_s[qc]);  // dS^T
      }
    }
    mma_acc(dva, st, Dt, g, t4);   // dV += A^T dO
    mma_acc(dka, dpt, Qt, g, t4);  // dK += dS^T q
  }
  store_rows(dk, dka, keys, b, h, T, H, scale, t4);
  store_rows(dv, dva, keys, b, h, T, H, 1.f, t4);
}

__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const int* __restrict__ key_mask,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int T, int H,
                         Strides qs, Strides ks, Strides vs, Strides ds,
                         float scale, uint32_t seed, uint32_t t_hash,
                         uint32_t threshold, float inv_keep) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK][kLds];  // k tile [key][d]
  __shared__ __align__(16) __nv_bfloat16 Kt[kD][kLds];   // k tile [d][key]
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK][kLds];  // v tile [key][d]
  __shared__ int mcode[kBK];  // 1 valid, 0 masked, -1 past T

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const int r0 = warp * 16;
  const uint32_t seed_bh = fmix32(seed + (uint32_t)bh * kGolden);

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* db = dout + b * ds.b + h * ds.h;
  const int* mb = key_mask + (long long)b * T;

  // this block's q and dO tiles (staged through Ks / Vs) -> A fragments
  load_tile(qb, qs.t, q0, T, Ks, nullptr, tid);
  load_tile(db, ds.t, q0, T, Vs, nullptr, tid);
  __syncthreads();
  uint32_t qa[kD / 16][4], da[kD / 16][4];
  load_a_frags(qa, Ks, r0, g, t4);
  load_a_frags(da, Vs, r0, g, t4);

  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const NoKeyShift nk(lse + (long long)bh * T, T);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = rows[r] < T ? nk.lse(lse + (long long)bh * T, rows[r]) : CUDART_INF_F;
    delta_r[r] = rows[r] < T ? delta[(long long)bh * T + rows[r]] : 0.f;
  }

  float dqa[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();  // fragments taken / previous tile consumed
    load_tile(kb, ks.t, k0, T, Ks, Kt, tid);
    load_tile(vb, vs.t, k0, T, Vs, nullptr, tid);
    if (tid < kBK) {
      const int col = k0 + tid;
      mcode[tid] = col < T ? (mb[col] > 0 ? 1 : 0) : -1;
    }
    __syncthreads();

    float s[8][4], dp[8][4];  // S and dP: 16 queries x 64 keys
    mma_rows(s, qa, Ks, g, t4);
    mma_rows(dp, da, Vs, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1, col = nt * 8 + t4 * 2 + (j & 1);
        const float p =
            __expf(replace_masked(s[nt][j] * scale, mcode[col], nk.fill) - lse_r[r]);
        float dpv = dp[nt][j];
        if (threshold)
          dpv = keep_elem(seed_bh, (uint32_t)rows[r], (uint32_t)(k0 + col), t_hash,
                          threshold) ? dpv * inv_keep : 0.f;
        s[nt][j] = p * (dpv - delta_r[r]);  // dS
      }
    }
    mma_acc(dqa, s, Kt, g, t4);  // dQ += dS k
  }
  store_rows(dq, dqa, rows, b, h, T, H, scale, t4);
}

// ---------------------------------------------------------------------------
// fp32: one thread per key (dK/dV) or query (dQ) row, FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kB32 = 64;  // rows per block = threads per block
constexpr int kT32 = 16;  // rows per staged tile (keeps static smem < 48 KB)

__global__ void __launch_bounds__(kB32)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ key_mask,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int T, int H, Strides qs,
                          Strides ks, Strides vs, Strides ds, float scale,
                          uint32_t seed, uint32_t t_hash, uint32_t threshold,
                          float inv_keep) {
  __shared__ float Ks[kB32][kD + 1];
  __shared__ float Vs[kB32][kD + 1];
  __shared__ float Qs[kT32][kD];  // q * scale, as the forward's fp32 path
  __shared__ float Ds[kT32][kD];
  __shared__ float lse_s[kT32], delta_s[kT32];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kB32;
  const int key = k0 + tid;
  const uint32_t seed_bh = fmix32(seed + (uint32_t)bh * kGolden);
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* db = dout + b * ds.b + h * ds.h;

  for (int i = tid; i < kB32 * kD; i += kB32) {
    const int r = i / kD, d = i - r * kD;
    const bool in = k0 + r < T;
    Ks[r][d] = in ? kb[(long long)(k0 + r) * ks.t + d] : 0.f;
    Vs[r][d] = in ? vb[(long long)(k0 + r) * vs.t + d] : 0.f;
  }
  const int code = key < T ? (key_mask[(long long)b * T + key] > 0 ? 1 : 0) : -1;
  const NoKeyShift nk(lse + (long long)bh * T, T);

  float dka[kD], dva[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) dka[d] = dva[d] = 0.f;

  for (int q0 = 0; q0 < T; q0 += kT32) {
    __syncthreads();
    for (int i = tid; i < kT32 * kD; i += kB32) {
      const int r = i / kD, d = i - r * kD;
      const bool in = q0 + r < T;
      Qs[r][d] = in ? qb[(long long)(q0 + r) * qs.t + d] * scale : 0.f;
      Ds[r][d] = in ? db[(long long)(q0 + r) * ds.t + d] : 0.f;
    }
    if (tid < kT32) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < T ? nk.lse(lse + (long long)bh * T, qi) : CUDART_INF_F;
      delta_s[tid] = qi < T ? delta[(long long)bh * T + qi] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kT32; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(Qs[i][d], Ks[tid][d], s);
        dp = fmaf(Ds[i][d], Vs[tid][d], dp);
      }
      const float p = expf(replace_masked(s, code, nk.fill) - lse_s[i]);
      float a = p;
      if (threshold) {
        const bool keep = keep_elem(seed_bh, (uint32_t)(q0 + i), (uint32_t)key, t_hash,
                                    threshold);
        a = keep ? p * inv_keep : 0.f;
        dp = keep ? dp * inv_keep : 0.f;
      }
      const float dsv = p * (dp - delta_s[i]);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        dva[d] = fmaf(a, Ds[i][d], dva[d]);
        dka[d] = fmaf(dsv, Qs[i][d], dka[d]);  // Qs is pre-scaled
      }
    }
  }
  if (key < T) {
    const long long off = ((long long)b * T + key) * ((long long)H * kD) + (long long)h * kD;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      dk[off + d] = dka[d];
      dv[off + d] = dva[d];
    }
  }
}

__global__ void __launch_bounds__(kB32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ key_mask,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int T, int H, Strides qs, Strides ks, Strides vs,
                        Strides ds, float scale, uint32_t seed, uint32_t t_hash,
                        uint32_t threshold, float inv_keep) {
  __shared__ float Qs[kB32][kD + 1];  // q * scale
  __shared__ float Ds[kB32][kD + 1];
  __shared__ float Ks[kT32][kD];
  __shared__ float Vs[kT32][kD];
  __shared__ int mcode[kT32];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kB32;
  const int row = q0 + tid;
  const uint32_t seed_bh = fmix32(seed + (uint32_t)bh * kGolden);
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* db = dout + b * ds.b + h * ds.h;
  const int* mb = key_mask + (long long)b * T;

  for (int i = tid; i < kB32 * kD; i += kB32) {
    const int r = i / kD, d = i - r * kD;
    const bool in = q0 + r < T;
    Qs[r][d] = in ? qb[(long long)(q0 + r) * qs.t + d] * scale : 0.f;
    Ds[r][d] = in ? db[(long long)(q0 + r) * ds.t + d] : 0.f;
  }
  const NoKeyShift nk(lse + (long long)bh * T, T);
  const float lse_r = row < T ? nk.lse(lse + (long long)bh * T, row) : CUDART_INF_F;
  const float delta_r = row < T ? delta[(long long)bh * T + row] : 0.f;

  float dqa[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) dqa[d] = 0.f;

  for (int k0 = 0; k0 < T; k0 += kT32) {
    __syncthreads();
    for (int i = tid; i < kT32 * kD; i += kB32) {
      const int r = i / kD, d = i - r * kD;
      const bool in = k0 + r < T;
      Ks[r][d] = in ? kb[(long long)(k0 + r) * ks.t + d] : 0.f;
      Vs[r][d] = in ? vb[(long long)(k0 + r) * vs.t + d] : 0.f;
    }
    if (tid < kT32) {
      const int col = k0 + tid;
      mcode[tid] = col < T ? (mb[col] > 0 ? 1 : 0) : -1;
    }
    __syncthreads();
    for (int j = 0; j < kT32; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        s = fmaf(Qs[tid][d], Ks[j][d], s);
        dp = fmaf(Ds[tid][d], Vs[j][d], dp);
      }
      const float p = expf(replace_masked(s, mcode[j], nk.fill) - lse_r);
      if (threshold)
        dp = keep_elem(seed_bh, (uint32_t)row, (uint32_t)(k0 + j), t_hash, threshold)
                 ? dp * inv_keep : 0.f;
      const float dsv = p * (dp - delta_r);
#pragma unroll
      for (int d = 0; d < kD; ++d) dqa[d] = fmaf(dsv, Ks[j][d], dqa[d]);
    }
  }
  if (row < T) {
    float* orow = dq + ((long long)b * T + row) * ((long long)H * kD) + (long long)h * kD;
#pragma unroll
    for (int d = 0; d < kD; ++d) orow[d] = dqa[d] * scale;
  }
}

template <typename T_>
int launch_all(const T_* q, const T_* k, const T_* v, const int* key_mask,
               const T_* o, const T_* dout, const float* lse, float* delta,
               T_* dq, T_* dk, T_* dv, int B, int T, int H, Strides qs,
               Strides ks, Strides vs, Strides os, Strides ds, float scale,
               uint32_t seed, uint32_t t_hash, uint32_t threshold,
               float inv_keep, cudaStream_t st);

template <>
int launch_all<__nv_bfloat16>(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const int* key_mask,
                              const __nv_bfloat16* o, const __nv_bfloat16* dout,
                              const float* lse, float* delta, __nv_bfloat16* dq,
                              __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int T,
                              int H, Strides qs, Strides ks, Strides vs,
                              Strides os, Strides ds, float scale, uint32_t seed,
                              uint32_t t_hash, uint32_t threshold, float inv_keep,
                              cudaStream_t st) {
  const long long rows = (long long)B * H * T;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      o, dout, delta, T, H, rows, os, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_bf16_kernel<<<dim3((T + kBK - 1) / kBK, B * H), 128, 0, st>>>(
      q, k, v, key_mask, dout, lse, delta, dk, dv, T, H, qs, ks, vs, ds, scale,
      seed, t_hash, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_bf16_kernel<<<dim3((T + kBQ - 1) / kBQ, B * H), 128, 0, st>>>(
      q, k, v, key_mask, dout, lse, delta, dq, T, H, qs, ks, vs, ds, scale, seed,
      t_hash, threshold, inv_keep);
  return (int)cudaGetLastError();
}

template <>
int launch_all<float>(const float* q, const float* k, const float* v,
                      const int* key_mask, const float* o, const float* dout,
                      const float* lse, float* delta, float* dq, float* dk,
                      float* dv, int B, int T, int H, Strides qs, Strides ks,
                      Strides vs, Strides os, Strides ds, float scale,
                      uint32_t seed, uint32_t t_hash, uint32_t threshold,
                      float inv_keep, cudaStream_t st) {
  const long long rows = (long long)B * H * T;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      o, dout, delta, T, H, rows, os, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_f32_kernel<<<dim3((T + kB32 - 1) / kB32, B * H), kB32, 0, st>>>(
      q, k, v, key_mask, dout, lse, delta, dk, dv, T, H, qs, ks, vs, ds, scale,
      seed, t_hash, threshold, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_f32_kernel<<<dim3((T + kB32 - 1) / kB32, B * H), kB32, 0, st>>>(
      q, k, v, key_mask, dout, lse, delta, dq, T, H, qs, ks, vs, ds, scale, seed,
      t_hash, threshold, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// `lse` is B1's fp32 [B, H, T] output, `delta` an fp32 [B, H, T] scratch
// buffer. Launches three kernels on `stream`, does not synchronise, and
// returns the first launch error (cudaGetLastError()), 0 on success.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* key_mask, const void* o, const void* dout,
                         const void* lse, void* delta, void* dq, void* dk,
                         void* dv, int dtype, int B, int T, int H, int D,
                         long long qsb, long long qst, long long qsh,
                         long long ksb, long long kst, long long ksh,
                         long long vsb, long long vst, long long vsh,
                         long long osb, long long ost, long long osh,
                         long long dsb, long long dst, long long dsh,
                         float scale, int seed, int t_hash,
                         unsigned int threshold, float inv_keep, void* stream) {
  if (D != kD || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh},
      os{osb, ost, osh}, ds{dsb, dst, dsh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  const int* km = static_cast<const int*>(key_mask);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return launch_all<bf>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        km, static_cast<const bf*>(o), static_cast<const bf*>(dout), lse_f, delta_f,
        static_cast<bf*>(dq), static_cast<bf*>(dk), static_cast<bf*>(dv), B, T, H, qs,
        ks, vs, os, ds, scale, (uint32_t)seed, (uint32_t)t_hash, threshold, inv_keep,
        st);
  }
  if (dtype == 0) {
    return launch_all<float>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), km, static_cast<const float*>(o),
        static_cast<const float*>(dout), lse_f, delta_f, static_cast<float*>(dq),
        static_cast<float*>(dk), static_cast<float*>(dv), B, T, H, qs, ks, vs, os, ds,
        scale, (uint32_t)seed, (uint32_t)t_hash, threshold, inv_keep, st);
  }
  return (int)cudaErrorInvalidValue;
}
