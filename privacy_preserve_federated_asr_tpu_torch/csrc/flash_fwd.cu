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
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): the work is
// 4*B*H*T^2*D FLOPs against 4*B*T*H*D*2 bytes of q, k, v and o, so at the
// serving shapes (B=8, H=16, D=64) a 5 s bucket (T=249, 2.0 GFLOP, 16 MB) is
// bound by bytes at about 5 us and a 30 s bucket (T=1499, 73.6 GFLOP, 98 MB)
// by the tensor cores at about 74 us. What held the first design at
// ~10% of that was its feeding of the tensor cores: each 64-key tile was
// staged synchronously (no copy overlapped any product), V was transposed
// through 2-byte shared-memory stores, fragments were gathered by 32-bit
// shared loads, and mma.sync cannot reach the card's tensor-core rate.
//
// The design now (bf16):
//   * one block of two warpgroups per (b*h, 128-query tile), 64 query rows a
//     warpgroup;
//   * a ring of two K/V (+ key mask) stages filled by cp.async, with zero fill
//     for rows past T, so tile j+1 is in flight while tile j is computed;
//   * tiles stored in the 128-byte swizzle of wgmma's descriptors
//     (flash_common.cuh), so no tile is transposed anywhere;
//   * S = Q K^T on wgmma m64n64k16 with both operands in shared memory, and
//     O += P V with P from registers (the S accumulators re-packed as bf16)
//     and V read MN-major through the descriptor's transpose bit; the online
//     softmax and the epilogue as before.
// What holds it now: each warpgroup waits for its products before its
// softmax (no overlap of the two within a warpgroup) and the element-wise
// work (exp, the keep hash) runs on the CUDA cores beside them.
// The fp32 path (tests and the fp32 serving option) uses plain FMA.

#include "flash_common.cuh"

namespace {

using namespace flash;

// The LSE the backward reads. A row whose keys are all masked ends with
// m = kMaskFill and l = T (every key's score replaced by the fill); its
// m + log(l) would round to kMaskFill in fp32 and lose log(T), so such a row
// saves exactly kMaskFill, which flash_bwd.cu reads as B1's weights 1/T.
__device__ __forceinline__ float row_lse(float m, float l) {
  return m == kMaskFill ? kMaskFill : m + logf(fmaxf(l, 1e-30f));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through wgmma, a cp.async ring of K/V tiles
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;                 // 2 warpgroups
constexpr int kBQ = 128;                      // queries per block (64 per warpgroup)
constexpr int kBK = 64;                       // keys per tile
constexpr int kStages = 2;                    // K/V ring depth
constexpr int kQBytes = kBQ * kRowBytes;      // 16 KB
constexpr int kTileBytes = kBK * kRowBytes;   // 8 KB
constexpr int kSmemBytes =                    // + slack to align the tiles to 1 KB
    1024 + kQBytes + kStages * (2 * kTileBytes + kBK * 4);

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ key_mask,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int T, int H,
                      Strides qs, Strides ks, Strides vs, float scale,
                      uint32_t seed, uint32_t t_hash, uint32_t threshold,
                      float inv_keep) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sKV = sQ + kQBytes;  // stage s: K at + 2s tiles, V after it
  int* mask_s = reinterpret_cast<int*>(smem + kQBytes + kStages * 2 * kTileBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBQ;
  const uint32_t seed_bh = seed_of(seed, bh);

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const int* mb = key_mask + (long long)b * T;
  const int n_tiles = (T + kBK - 1) / kBK;

  auto load_kv = [&](int kt) {
    const int st = kt % kStages;
    load_tile_async<kBK, kThreads>(sKV + 2 * st * kTileBytes, kb, ks.t, kt * kBK, T, tid);
    load_tile_async<kBK, kThreads>(sKV + (2 * st + 1) * kTileBytes, vb, vs.t, kt * kBK, T,
                                   tid);
    load_vec_async<kBK>(mask_s + st * kBK, mb, kt * kBK, T, tid);
    cp_async_commit();
  };

  load_tile_async<kBQ, kThreads>(sQ, qb, qs.t, q0, T, tid);  // rows past T zero
  load_kv(0);

  const uint64_t q_desc = gmma_desc(sQ + 64 * wg * kRowBytes);  // this warpgroup's rows
  float oacc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m[2] = {kMaskFill, kMaskFill};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums (quad-reduced at the end)
  const uint32_t rows[2] = {(uint32_t)(q0 + warp * 16 + g),
                            (uint32_t)(q0 + warp * 16 + g + 8)};

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile kt landed for all; tile kt-1's stage is free
    if (kt + 1 < n_tiles) load_kv(kt + 1);  // in flight while tile kt computes
    const int st = kt % kStages, k0 = kt * kBK;
    const int* mc = mask_s + st * kBK;
    const uint32_t sK = sKV + 2 * st * kTileBytes, sV = sK + kTileBytes;

    // S = Q K^T: 64 rows x 64 keys per warpgroup, both operands K-major
    float s[kBK / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss_n64<0, 0>(s, q_desc + 2 * kc, gmma_desc(sK) + 2 * kc, kc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // mask, then the online-softmax statistics
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nt * 8 + t4 * 2 + (j & 1);
        const int code = k0 + col < T ? (mc[col] > 0 ? 1 : 0) : -1;
        const float x = replace_masked(s[nt][j] * scale, code, kMaskFill);
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

    // O += P V: P from registers, V MN-major (k = keys, 16 rows a step)
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) acc_as_a(pa[kk], s, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_n64<1>(oacc, pa[kk], gmma_desc(sV + kk * 16 * kRowBytes), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(oacc);
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
  const uint32_t seed_bh = seed_of(seed, bh);
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
    if (tid < kBK32) mcode[tid] = key_code(mb, k0 + tid, T);
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
      s[j] = replace_masked(s[j], mcode[j], kMaskFill);
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
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((T + kBQ - 1) / kBQ, B * H);
    flash_fwd_bf16_kernel<<<grid, kThreads, kSmemBytes, st>>>(
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
