// Flash-attention forward for Hopper (sm_90a), kernel B1 of the port.
//
// Replaces the TPU kernel privacy_preserve_federated_asr_tpu/ops/attention.py
// ::_fwd_kernel (launched by _flash_fwd_call). It computes the same function:
// softmax(q k^T / sqrt(D)) v per (batch, head), with fp32 accumulation, keys
// whose mask is 0 REPLACED by -1e30 (not biased), an online softmax over key
// tiles, and the counter-based attention-dropout of the TPU kernel:
//   seed_bh = fmix32(seed + bh * 0x9E3779B9)
//   keep    = (fmix32((row * t_hash + col) ^ seed_bh) & 0x7FFFFFFF) >= threshold
// The denominator uses the UNdropped probabilities; the output is
// acc * inv_keep / max(l, 1e-30). t_hash is the padded length the TPU wrapper
// hashed with, so the keep masks are bit-identical to the TPU kernel's.
//
// Layout: q, k, v are [B, T, H, D] read through strides (the D axis must be
// contiguous), so the head split needs no transpose; the output is a
// contiguous [B, T, H, D]. The key mask is int32 [B, T], indexed by bh / H.
// Keys past T are excluded inside the kernel (no padding to a block).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the serving
// shapes (B=8, H=16, D=64) the work is 4*B*H*T^2*D FLOPs against
// 4*B*T*H*D*2 bytes of q, k, v and o, so a 5 s bucket (T=249, 2.0 GFLOP,
// 16 MB) is memory-bound at about 5 us and a 30 s bucket (T=1499, 73.6 GFLOP,
// 98 MB) compute-bound at about 74 us. The design meets the compute side with
// tensor cores: bf16 QK^T and PV run on mma.sync m16n8k16 with fp32
// accumulators, and the [T, T] probabilities never leave registers (each
// warp's S tile is re-packed in registers as the A operand of PV). The memory
// side is met by reading q once per block and k, v once per (block, tile)
// through shared memory. It is a simple first design: one block of 4 warps
// per (bh, 64-query tile), 64-key tiles staged synchronously, no TMA, wgmma
// or warp specialisation. The fp32 path (tests and the fp32 serving option)
// uses plain FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;             // head dim (the only one supported)
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

// The LSE the backward reads. A row whose keys are all masked ends with
// m = kMaskFill and l = T (every key's score replaced by the fill); its
// m + log(l) would round to kMaskFill in fp32 and lose log(T), so such a row
// saves exactly kMaskFill, which flash_bwd.cu reads as B1's weights 1/T.
__device__ __forceinline__ float row_lse(float m, float l) {
  return m == kMaskFill ? kMaskFill : m + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;            // queries per block (16 per warp)
constexpr int kBK = 64;            // keys per tile
constexpr int kLds = kD + 8;       // smem row stride (bf16): conflict-free fragments
constexpr int kLdv = kBK + 8;      // transposed-V row stride (bf16)

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

__global__ void __launch_bounds__(128)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ key_mask,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int T, int H,
                      Strides qs, Strides ks, Strides vs, float scale,
                      uint32_t seed, uint32_t t_hash, uint32_t threshold,
                      float inv_keep) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBQ][kLds];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK][kLds];
  __shared__ __align__(16) __nv_bfloat16 Vt[kD][kLdv];
  __shared__ int mcode[kBK];  // 1 valid, 0 masked, -1 past T

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const uint32_t seed_bh = fmix32(seed + (uint32_t)bh * kGolden);

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const int* mb = key_mask + (long long)b * T;

  // q tile -> smem (16-byte chunks; rows past T are zero)
  for (int c = tid; c < kBQ * kD / 8; c += 128) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < T)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * qs.t + col);
    *reinterpret_cast<uint4*>(&Qs[r][col]) = val;
  }
  __syncthreads();
  uint32_t qa[kD / 16][4];
  const int r0 = warp * 16;
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    qa[kc][0] = lds32(&Qs[r0 + g][kc * 16 + t4 * 2]);
    qa[kc][1] = lds32(&Qs[r0 + g + 8][kc * 16 + t4 * 2]);
    qa[kc][2] = lds32(&Qs[r0 + g][kc * 16 + 8 + t4 * 2]);
    qa[kc][3] = lds32(&Qs[r0 + g + 8][kc * 16 + 8 + t4 * 2]);
  }

  float oacc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m[2] = {kMaskFill, kMaskFill};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums (quad-reduced at the end)
  const uint32_t rows[2] = {(uint32_t)(q0 + r0 + g), (uint32_t)(q0 + r0 + g + 8)};

  for (int k0 = 0; k0 < T; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int c = tid; c < kBK * kD / 8; c += 128) {
      const int r = c >> 3, col = (c & 7) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < T) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * ks.t + col);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * vs.t + col);
      }
      *reinterpret_cast<uint4*>(&Ks[r][col]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[col + j][r] = ve[j];
    }
    if (tid < kBK) {
      const int col = k0 + tid;
      mcode[tid] = col < T ? (mb[col] > 0 ? 1 : 0) : -1;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
        const uint32_t b0 = lds32(&Ks[nt * 8 + g][kc * 16 + t4 * 2]);
        const uint32_t b1 = lds32(&Ks[nt * 8 + g][kc * 16 + 8 + t4 * 2]);
        mma_bf16(s[nt], qa[kc], b0, b1);
      }
    }

    // mask, then the online-softmax statistics
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int code = mcode[nt * 8 + t4 * 2 + (j & 1)];
        float x = s[nt][j] * scale;
        x = code > 0 ? x : (code == 0 ? kMaskFill : -CUDART_INF_F);
        s[nt][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        float p = __expf(s[nt][j] - m[r]);
        l[r] += p;  // the denominator sees the undropped p
        if (threshold) {
          const uint32_t col = (uint32_t)(k0 + nt * 8 + t4 * 2 + (j & 1));
          if (!keep_elem(seed_bh, rows[r], col, t_hash, threshold)) p = 0.f;
        }
        s[nt][j] = p;
      }
    }
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      oacc[dn][0] *= alpha[0];
      oacc[dn][1] *= alpha[0];
      oacc[dn][2] *= alpha[1];
      oacc[dn][3] *= alpha[1];
    }

    // O += P V: the S accumulators re-packed as A fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        const uint32_t b0 = lds32(&Vt[dn * 8 + g][kk * 16 + t4 * 2]);
        const uint32_t b1 = lds32(&Vt[dn * 8 + g][kk * 16 + 8 + t4 * 2]);
        mma_bf16(oacc[dn], pa, b0, b1);
      }
    }
  }

  // epilogue: the full row sums, then acc * inv_keep / max(l, 1e-30)
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    f[r] = inv_keep / fmaxf(lr, 1e-30f);
    if (lse != nullptr && t4 == 0 && (int)rows[r] < T)
      lse[(long long)bh * T + rows[r]] = row_lse(m[r], lr);
  }
  const long long ost = (long long)H * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = (int)rows[r];
    if (row >= T) continue;
    __nv_bfloat16* orow = o + ((long long)b * T + row) * ost + (long long)h * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + t4 * 2) =
          pack_bf16(oacc[dn][2 * r] * f[r], oacc[dn][2 * r + 1] * f[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: one thread per query row, FMA on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ32 = 64;  // queries per block = threads per block
constexpr int kBK32 = 32;  // keys per tile

__global__ void __launch_bounds__(kBQ32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ key_mask, float* __restrict__ o,
                     float* __restrict__ lse, int T, int H, Strides qs,
                     Strides ks, Strides vs, float scale, uint32_t seed, uint32_t t_hash,
                     uint32_t threshold, float inv_keep) {
  __shared__ float Qs[kBQ32][kD + 1];
  __shared__ float Ks[kBK32][kD];
  __shared__ float Vs[kBK32][kD];
  __shared__ int mcode[kBK32];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ32;
  const uint32_t seed_bh = fmix32(seed + (uint32_t)bh * kGolden);
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int* mb = key_mask + (long long)b * T;

  // q is scaled in fp32 before the dot, as the TPU kernel does
  for (int i = tid; i < kBQ32 * kD; i += kBQ32) {
    const int r = i / kD, d = i - r * kD;
    Qs[r][d] = q0 + r < T ? qb[(long long)(q0 + r) * qs.t + d] * scale : 0.f;
  }

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  float m = kMaskFill, l = 0.f;
  const uint32_t row = (uint32_t)(q0 + tid);

  for (int k0 = 0; k0 < T; k0 += kBK32) {
    __syncthreads();
    for (int i = tid; i < kBK32 * kD; i += kBQ32) {
      const int r = i / kD, d = i - r * kD;
      const bool in = k0 + r < T;
      Ks[r][d] = in ? kb[(long long)(k0 + r) * ks.t + d] : 0.f;
      Vs[r][d] = in ? vb[(long long)(k0 + r) * vs.t + d] : 0.f;
    }
    if (tid < kBK32) {
      const int col = k0 + tid;
      mcode[tid] = col < T ? (mb[col] > 0 ? 1 : 0) : -1;
    }
    __syncthreads();

    float s[kBK32];
#pragma unroll
    for (int j = 0; j < kBK32; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float qd = Qs[tid][d];
#pragma unroll
      for (int j = 0; j < kBK32; ++j) s[j] = fmaf(qd, Ks[j][d], s[j]);
    }
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      const int code = mcode[j];
      s[j] = code > 0 ? s[j] : (code == 0 ? kMaskFill : -CUDART_INF_F);
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      float p = expf(s[j] - m);
      l += p;
      if (threshold && !keep_elem(seed_bh, row, (uint32_t)(k0 + j), t_hash, threshold))
        p = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, Vs[j][d], acc[d]);
    }
  }

  if ((int)row < T) {
    const float f = inv_keep / fmaxf(l, 1e-30f);
    if (lse != nullptr) lse[(long long)bh * T + row] = row_lse(m, l);
    float* orow = o + ((long long)b * T + row) * ((long long)H * kD) + (long long)h * kD;
#pragma unroll
    for (int d = 0; d < kD; ++d) orow[d] = acc[d] * f;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// `lse` is null (serving) or an fp32 [B, H, T] buffer that receives each
// row's log-sum-exp m + log(l) of the scaled, mask-replaced scores, which
// the backward (flash_bwd.cu) reads. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* key_mask, void* o, int dtype, int B,
                         int T, int H, int D, long long qsb, long long qst,
                         long long qsh, long long ksb, long long kst,
                         long long ksh, long long vsb, long long vst,
                         long long vsh, float scale, int seed, int t_hash,
                         unsigned int threshold, float inv_keep, void* lse,
                         void* stream) {
  if (D != kD || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((T + kBQ - 1) / kBQ, B * H);
    flash_fwd_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(key_mask),
        static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), T, H, qs, ks,
        vs, scale, (uint32_t)seed, (uint32_t)t_hash, threshold, inv_keep);
  } else if (dtype == 0) {
    const dim3 grid((T + kBQ32 - 1) / kBQ32, B * H);
    flash_fwd_f32_kernel<<<grid, kBQ32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(key_mask),
        static_cast<float*>(o), static_cast<float*>(lse), T, H, qs, ks, vs,
        scale, (uint32_t)seed, (uint32_t)t_hash, threshold, inv_keep);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
