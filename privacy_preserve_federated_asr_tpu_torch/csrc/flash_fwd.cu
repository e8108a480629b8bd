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
//
// The fp32 path (cli extract's default, the federated evaluations, fp32
// training and serving) is flash_fwd_f32_kernel: the same function with
// every product on the tensor cores in TF32 and fp32's accuracy kept by the
// 3xTF32 split of flash_common.cuh (x = hi + lo, both TF32; a product is
// lo.hi + hi.lo + hi.hi into one fp32 accumulator), on wgmma m64n64k8.
// wgmma takes tf32 shared-memory operands K-major only, which decides the
// layout:
//   * one block of 2 warpgroups per (b*h, 128-query tile); each warp's q
//     rows, scaled in fp32 and split once, stay in registers as S's A
//     operand for the whole key loop;
//   * per 64-key tile, cp.async lands the next raw K, V and key mask (zero
//     fill past T) while this tile computes; the block splits each raw tile
//     once into swizzled K-major hi and lo planes: K as stored (S = q K^T
//     contracts over D), V transposed with its keys permuted within each 8
//     (P V contracts over keys);
//   * S's accumulators become P's register A operand with no shuffle: a
//     thread's accumulator columns 2t4, 2t4+1 stand for k positions t4,
//     t4+4, the key order of V^T's planes; the online softmax (precise
//     expf), the keep hash and the epilogue are the bf16 path's.
// Bound: 3 TF32 products per product at 495 TFLOP/s (dense TF32), so
// 3 * 4*B*H*T^2*D / 495e12 s, 0.446 ms at B=8, H=16, T=1499 (on FMA at
// 67 TFLOP/s: 1.099 ms). What holds it: in each tile the split pass, the
// products and the softmax run in turn in both warpgroups between two block
// barriers, so the tensor cores idle outside the products; the q fragments
// take 64 of a thread's registers, so one block runs per SM.

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
// fp32: 3xTF32 on wgmma; the next raw K/V tile lands by cp.async while the
// planes of this one compute
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;                   // 2 warpgroups, 64 query rows each
constexpr int kF32BQ = 128;                        // queries per block
constexpr int kF32BK = 64;                         // keys per tile
constexpr int kF32Raw = kF32BK * kLdF;             // floats of one raw K or V tile
constexpr int kF32Plane = kF32BK * kD * 4;         // bytes of one plane of K or V^T
constexpr int kF32SmemBytes =                      // + slack to align the planes to 1 KB
    1024 + 4 * kF32Plane + (2 * kF32Raw + 2 * kF32BK) * 4;

__global__ void __launch_bounds__(kF32Threads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const int* __restrict__ key_mask, float* __restrict__ o,
                     float* __restrict__ lse, int T, int H, Strides qs,
                     Strides ks, Strides vs, float scale, uint32_t seed, uint32_t t_hash,
                     uint32_t threshold, float inv_keep) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem);       // tile kt: K's planes (hi, lo)
  const uint32_t sVt = sK + 2 * kF32Plane;  // V^T's planes, keys permuted
  float* rawK = reinterpret_cast<float*>(smem + 4 * kF32Plane);  // tile kt+1 lands here
  float* rawV = rawK + kF32Raw;
  int* rawM = reinterpret_cast<int*>(rawV + kF32Raw);
  int* mc = rawM + kF32BK;  // tile kt's key mask

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kF32BQ;
  const uint32_t seed_bh = seed_of(seed, bh);
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int* mb = key_mask + (long long)b * T;
  const int n_tiles = (T + kF32BK - 1) / kF32BK;

  auto load_kv = [&](int kt) {
    load_tile_f32_async<kF32BK, kF32Threads>(rawK, kb, ks.t, kt * kF32BK, T, tid);
    load_tile_f32_async<kF32BK, kF32Threads>(rawV, vb, vs.t, kt * kF32BK, T, tid);
    load_vec_async<kF32BK>(rawM, mb, kt * kF32BK, T, tid);
    cp_async_commit();
  };
  load_kv(0);

  // this warp's 16 query rows (of its warpgroup's 64), scaled in fp32 (as
  // the TPU kernel does) and split once: S's A operand for the whole loop
  const uint32_t rows[2] = {(uint32_t)(q0 + warp * 16 + g), (uint32_t)(q0 + warp * 16 + g + 8)};
  FragA qa[kD / 8];
#pragma unroll
  for (int kc = 0; kc < kD / 8; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (int)rows[i & 1], col = kc * 8 + t4 + (i >> 1) * 4;
      qa[kc].set(i, row < T ? qb[(long long)row * qs.t + col] * scale : 0.f);
    }

  float oacc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m[2] = {kMaskFill, kMaskFill};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums (quad-reduced at the end)

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // raw tile kt landed; tile kt-1's planes are free
    split_rows_sw<kF32BK, kF32Threads>(sK, rawK, tid);
    split_cols_sw<kF32BK, kF32Threads>(sVt, rawV, tid);
    if (tid < kF32BK) mc[tid] = rawM[tid];
    fence_proxy_async();
    __syncthreads();  // planes written; the raw stage is free
    if (kt + 1 < n_tiles) load_kv(kt + 1);  // in flight while tile kt computes
    const int k0 = kt * kF32BK;

    // S = (q * scale) K^T: 64 rows x 64 keys per warpgroup
    float s[kF32BK / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc)
      wgmma_3xtf32(s, qa[kc], sK, kF32Plane, kc, kF32BK, kc == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    // mask, then the online-softmax statistics (precise expf, as fp32 wants)
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kF32BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nt * 8 + t4 * 2 + (j & 1);
        const int code = k0 + col < T ? (mc[col] > 0 ? 1 : 0) : -1;
        const float x = replace_masked(s[nt][j], code, kMaskFill);
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
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kF32BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1;
        float p = expf(s[nt][j] - m[r]);
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

    // O += P V: P from the S accumulators (keys permuted), V^T's planes
    FragA pa[kF32BK / 8];
#pragma unroll
    for (int kc = 0; kc < kF32BK / 8; ++kc) pa[kc] = acc_as_frag_a(s[kc]);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kF32BK / 8; ++kc)
      wgmma_3xtf32(oacc, pa[kc], sVt, kF32Plane, kc, kD, false);
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
    float* orow = o + ((long long)b * T + row) * ost + (long long)h * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      *reinterpret_cast<float2*>(orow + dn * 8 + t4 * 2) =
          make_float2(oacc[dn][2 * r] * f[r], oacc[dn][2 * r + 1] * f[r]);
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
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32SmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((T + kF32BQ - 1) / kF32BQ, B * H);
    flash_fwd_f32_kernel<<<grid, kF32Threads, kF32SmemBytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(key_mask),
        static_cast<float*>(o), static_cast<float*>(lse), T, H, qs, ks, vs,
        scale, (uint32_t)seed, (uint32_t)t_hash, threshold, inv_keep);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
