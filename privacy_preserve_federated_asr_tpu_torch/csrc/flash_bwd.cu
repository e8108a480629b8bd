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
// is 10*B*H*T^2*D FLOPs (the five products S, dP, dV, dK, dQ) against
// reading q, k, v, o, dO and writing dq, dk, dv. At the training shape
// (B=16, H=16, T=249) that is 1.0e10 FLOP against 65 MB: bytes bound it at
// about 20 us. At B=8, T=1499 it is 1.8e11 FLOP against 196 MB: operations
// bound it at about 186 us. The first design reached ~10% of that: it
// split the work FA2's way into a dK/dV kernel and a dQ kernel that both
// recomputed S and dP (14 instead of 10 units of FLOPs), staged every tile
// synchronously and transposed q, dO and K through 2-byte shared stores.
//
// The design now (bf16), one pass, three launches:
//   1. flash_bwd_delta: delta = rowsum(dO * O) / inv_keep, one warp per row;
//   2. flash_bwd_bf16: one block per (128-key tile, b*h) of two compute
//      warpgroups (64 keys each) and a third warpgroup whose first warp adds
//      dQ to global memory; that warpgroup gives its registers to the
//      compute warpgroups (setmaxnreg), which then hold their accumulators
//      without spilling. The K and V tiles stay in shared memory; the block
//      loops over 64-query tiles that a two-stage cp.async ring (q, dO, lse,
//      delta; zero fill past T) brings in while the previous tile computes.
//      Per tile each warpgroup runs on wgmma (m64nNk16, bf16 in, fp32
//      accumulators):
//        S^T = K q^T and dP^T = V dO^T, both operands in shared memory;
//        A^T and dS^T element-wise in registers (exp2 of the saved LSE, the
//        keep hash, dS = p (dP - delta)), inv_keep left to the end;
//        dV += A^T dO and dK += dS^T q with A^T and dS^T re-packed as
//        register A operands, dO and q read MN-major (transpose bit);
//        dS^T to shared memory, then its dQ share dS K (64 queries x 32
//        columns; dS^T and K both MN-major), handed to the writer warp
//        through a ring of four shared buffers and named barriers.
//      The tiles lie in the 128-byte swizzle of the wgmma descriptors
//      (flash_common.cuh), so nothing is transposed by hand.
//   3. Deterministic dQ: the writer adds each share to an fp32 [B*H, T, 64]
//      sum by the TMA unit, as one bulk copy (a q tile's first adder) or
//      bulk reduce-add (the others), waited for before a counter per (b*h,
//      q tile) in global memory lets the next adder go (FA3's deterministic
//      mode). The adders of a q tile follow a fixed order, so two calls on
//      the same inputs give bit-equal dq, dk and dv. Key tile kt walks the q
//      tiles from tile kt on, so the key tiles of one (b, h) reach a q tile
//      at different steps and rarely wait for each other; the order is the
//      order of those steps. flash_bwd_dq_convert then writes
//      dq = sum * scale * inv_keep in bf16.
// What holds it now: the products and the element-wise work (much of it the
// keep hash at dropout 0.1) do not overlap, since both warpgroups run the
// same phase at once (no ping-pong), and each tile pays two block barriers
// and the dQ hand-off.
//
// The fp32 path (the programmatic API's default dtype, --compute_dtype
// float32 in train, federated and sweep asr) keeps the two-kernel split:
// flash_bwd_delta, then flash_bwd_dkdv_f32 (dK, dV) and flash_bwd_dq_f32
// (dQ), each recomputing S and dP (14 units of FLOPs instead of 10). Each
// output has one owner that sums in a fixed order, so two calls give
// bit-equal gradients with no ordering machinery. Every product runs on the
// tensor cores in TF32 with the 3xTF32 split of flash_common.cuh (x = hi +
// lo, both TF32; lo.hi + hi.lo + hi.hi into one fp32 accumulator), on wgmma
// (m64n64k8, m64n32k8). wgmma takes tf32 shared-memory operands K-major
// only, so each B operand is split once per block into swizzled K-major
// hi/lo planes, as stored or transposed, and each A operand into registers:
//   * dK/dV: one block of 2 warpgroups per 128 keys walks 32-query tiles.
//     Its raw K and V stay resident, their A fragments split as read.
//     cp.async lands the next raw q, dO, lse and delta while this tile
//     computes; the block splits q (scaled in fp32) and dO as stored (B of
//     S^T = K q^T and dP^T = V dO^T) and transposed with the queries
//     permuted within each 8 (B of dV += A^T dO and dK += dS^T q, whose A^T
//     and dS^T are the S^T and dP^T accumulators with no shuffle).
//   * dQ: one block of 2 warpgroups per 128 queries (raw q and dO resident,
//     A fragments split as read) walks 64-key tiles; K is split as stored
//     (S = q K^T) and transposed (dQ += dS K), V as stored (dP = dO V^T).
//   The element-wise work: p = exp(s' - lse) (precise expf), the keep hash,
//   dP and A scaled by inv_keep where kept, dS = p (dP - delta). The two A operands of S and dP are built and used
//   one after the other: both would not fit beside the accumulators. nvcc's
//   -Xptxas -v report reads 0 bytes of spill (chip_smoke.py phase 1).
// Bound: 3 TF32 products per product at 495 TFLOP/s, 3 * 10*B*H*T^2*D /
// 495e12 s (1.116 ms at B=8, H=16, T=1499; on FMA: 2.747 ms); the
// split pays 14 units, so it can reach at most 10/14 of that bound. What
// holds it besides: in each tile the split pass, the products and the
// element-wise work run in turn in both warpgroups between two block
// barriers.

#include "flash_common.cuh"

namespace {

using namespace flash;

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
  __device__ float lse(float saved) const { return none ? log_t : saved; }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O) * f, fp32 [B, H, T]
// ---------------------------------------------------------------------------

template <typename T_>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T_* __restrict__ o, const T_* __restrict__ dout,
                       float* __restrict__ delta, int T, int H, long long rows,
                       Strides os, Strides ds, float f) {
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
  if (lane == 0) delta[row] = acc * f;
}

// ---------------------------------------------------------------------------
// 2. bf16: one pass, tensor cores through wgmma
// ---------------------------------------------------------------------------

constexpr int kCompute = 256;                   // 2 warpgroups compute
constexpr int kThreads = kCompute + 128;        // + 1 warpgroup, whose first warp adds dQ
constexpr int kHandoff = kCompute + 32;         // threads of the dQ hand-off barriers
constexpr int kBK = 128;                        // keys per block (64 per warpgroup)
constexpr int kBQ = 64;                         // queries per tile
constexpr int kStages = 2;                      // q-side ring depth
constexpr int kDqBufs = 4;                      // dQ shares in flight to the writer
constexpr int kKeyBytes = kBK * kRowBytes;      // 16 KB
constexpr int kQBytes = kBQ * kRowBytes;        // 8 KB
constexpr int kSmemBytes =                      // + slack to align the tiles to 1 KB
    1024 + 3 * kKeyBytes + kStages * (2 * kQBytes + 2 * kBQ * 4) +
    kDqBufs * kBQ * kD * 4;
// named barriers: the compute warps among themselves, and per dQ buffer
// "full" (compute -> writer) and "empty" (writer -> compute)
constexpr int kBarCompute = 1, kBarFull = 2, kBarEmpty = kBarFull + kDqBufs;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// orders this thread's async-proxy (bulk copy) and generic accesses of
// global memory against each other
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// `bytes` of fp32 from shared to global memory by the TMA unit, stored or
// (add) reduce-added, and waited for until the writes are done
__device__ __forceinline__ void bulk_to_global(float* dst, const float* src, int bytes,
                                               bool add) {
  if (add)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(smem_u32(src)), "r"(bytes)
        : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                 "r"(smem_u32(src)), "r"(bytes)
                 : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 3. dq = dq_accum * scale, [B*H, T, 64] fp32 -> [B, T, H, 64] bf16, 8 a thread
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                            int T, int H, long long n8, float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n8) return;
  const long long row = i >> 3;  // (b*H + h) * T + t
  const int c = (int)(i & 7) * 8;
  const long long bh = row / T;
  const int t = (int)(row - bh * T);
  const float4 x = __ldg(reinterpret_cast<const float4*>(acc + row * kD + c));
  const float4 y = __ldg(reinterpret_cast<const float4*>(acc + row * kD + c + 4));
  const uint4 out = make_uint4(pack_bf16(x.x * scale, x.y * scale),
                               pack_bf16(x.z * scale, x.w * scale),
                               pack_bf16(y.x * scale, y.y * scale),
                               pack_bf16(y.z * scale, y.w * scale));
  const long long b = bh / H, h = bh - b * H;
  *reinterpret_cast<uint4*>(dq + ((b * T + t) * H + h) * kD + c) = out;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// rows (g, g+8) of a 16-row accumulator tile, times f, -> bf16 rows of a
// contiguous [B, T, H, D] output
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

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ key_mask,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq_accum, int* __restrict__ dq_sem,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int T, int H,
                      Strides qs, Strides ks, Strides vs, Strides ds,
                      float scale, uint32_t seed, uint32_t t_hash,
                      uint32_t threshold, float inv_keep) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + kKeyBytes;
  const uint32_t sdS = sV + kKeyBytes;       // dS^T [key][query], bf16
  const uint32_t sQD = sdS + kKeyBytes;      // stage s: q at + 2s tiles, dO after it
  uint8_t* dS_ptr = smem + 2 * kKeyBytes;
  float* lse_s = reinterpret_cast<float*>(smem + 3 * kKeyBytes + kStages * 2 * kQBytes);
  float* delta_s = lse_s + kStages * kBQ;
  float* dq_s = delta_s + kStages * kBQ;     // kDqBufs x [kBQ][kD] fp32

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wiw = warp & 3;  // warpgroup, warp in it
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kt = blockIdx.x, n_kt = gridDim.x;
  const int k0 = kt * kBK;
  const int n_qt = (T + kBQ - 1) / kBQ;
  const uint32_t seed_bh = seed_of(seed, bh);

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  const __nv_bfloat16* db = dout + b * ds.b + h * ds.h;
  const float* lse_b = lse + (long long)bh * T;
  const float* delta_b = delta + (long long)bh * T;
  const NoKeyShift nk(lse_b, T);
  // Key tile kt visits the q tiles starting at tile kt: at step `it` it
  // works on q tile (it + kt) mod n_qt, so the key tiles of one (b, h) reach
  // each q tile at different steps and rarely wait on each other's dQ adds.
  auto q_tile = [&](int it) { return (it + kt) % n_qt; };

  if (warp >= kCompute / 32) {
    // the writer's warpgroup gives its registers to the compute warpgroups
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp > kCompute / 32) return;
    // The dQ writer: adds each q tile's share to the fp32 sum, off the
    // compute warps' path, as one bulk copy (the first adder) or bulk
    // reduce-add (the others) by the TMA unit. The adders of a q tile go in
    // the order of the steps at which they reach it, a function of (q tile,
    // key tile) alone, so the sums are the same on every call.
    for (int it = 0; it < n_qt; ++it) {
      const int buf = it % kDqBufs, qt = q_tile(it), q0 = qt * kBQ;
      bar_sync(kBarFull + buf, kHandoff);
      if (lane == 0) {
        int rank = 0;  // key tiles that reach q tile qt before this one (at step it)
        for (int j = 0; j < n_kt; ++j) rank += (qt - j + n_qt) % n_qt < it;
        int* sem = dq_sem + (long long)bh * n_qt + qt;
        if (rank > 0)
          while (ld_acquire(sem) < rank) {
          }
        fence_proxy_async_global();
        bulk_to_global(dq_accum + ((long long)bh * T + q0) * kD, dq_s + buf * kBQ * kD,
                       min(kBQ, T - q0) * kD * 4, rank > 0);
        if (rank < n_kt - 1) {
          fence_proxy_async_global();
          __threadfence();
          atomicAdd(sem, 1);
        }
      }
      __syncwarp();
      if (it + kDqBufs < n_qt) bar_arrive(kBarEmpty + buf, kHandoff);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  auto load_q = [&](int it) {
    const int st = it % kStages, q0 = q_tile(it) * kBQ;
    load_tile_async<kBQ, kCompute>(sQD + 2 * st * kQBytes, qb, qs.t, q0, T, tid);
    load_tile_async<kBQ, kCompute>(sQD + (2 * st + 1) * kQBytes, db, ds.t, q0, T, tid);
    load_vec_async<kBQ>(lse_s + st * kBQ, lse_b, q0, T, tid);
    load_vec_async<kBQ>(delta_s + st * kBQ, delta_b, q0, T, tid - kBQ);
    cp_async_commit();
  };

  load_tile_async<kBK, kCompute>(sK, kb, ks.t, k0, T, tid);
  load_tile_async<kBK, kCompute>(sV, vb, vs.t, k0, T, tid);
  load_q(0);

  // this thread's keys: rows g and g+8 of its warp's 16 in the warpgroup's 64
  const int r0 = 64 * wg + 16 * wiw;
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const int kcode[2] = {key_code(key_mask + (long long)b * T, keys[0], T),
                        key_code(key_mask + (long long)b * T, keys[1], T)};
  // p of the two keys: exp2(s * scale * log2(e) - lse * log2(e)) for a valid
  // key, 0 past T, and for a masked key exp(fill - lse): 1/T where no key of
  // this (b, h) is valid (NoKeyShift), else 0
  const float scale2 = scale * 1.4426950408889634f;
  float p_masked[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) p_masked[r] = kcode[r] == 0 && nk.none ? 1.f / (float)T : 0.f;
  const uint64_t k_desc = gmma_desc(sK + 64 * wg * kRowBytes);  // this warpgroup's keys
  const uint64_t v_desc = gmma_desc(sV + 64 * wg * kRowBytes);

  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    cp_async_wait<0>();
    fence_proxy_async();
    bar_sync(kBarCompute, kCompute);  // tile it landed; tile it-1's stage and dS^T are free
    if (it + 1 < n_qt) load_q(it + 1);  // in flight while tile it computes
    const int st = it % kStages, q0 = q_tile(it) * kBQ;
    const uint32_t sQ = sQD + 2 * st * kQBytes, sD = sQ + kQBytes;
    const float* ls = lse_s + st * kBQ;
    const float* dl = delta_s + st * kBQ;

    // S^T = K q^T and dP^T = V dO^T: 64 keys x 64 queries per warpgroup,
    // both operands K-major in shared memory, k stepping 16 columns (32 B)
    float stt[8][4], dpt[8][4];
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss_n64<0, 0>(stt, k_desc + 2 * kc, gmma_desc(sQ) + 2 * kc, kc);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_ss_n64<0, 0>(dpt, v_desc + 2 * kc, gmma_desc(sD) + 2 * kc, kc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(stt);
    fence_acc(dpt);

    float nlse2[8][2];  // -lse * log2(e) of this thread's query columns
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qc = nt * 8 + t4 * 2 + c;
        nlse2[nt][c] = q0 + qc < T ? -nk.lse(ls[qc]) * 1.4426950408889634f
                                   : -CUDART_INF_F;  // p = 0 past T
      }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1, qc = nt * 8 + t4 * 2 + (j & 1);
        const float p = kcode[r] > 0 ? ex2(fmaf(stt[nt][j], scale2, nlse2[nt][j & 1]))
                                     : p_masked[r];
        float a = p, dp = dpt[nt][j];
        if (threshold) {
          const bool keep = keep_elem(seed_bh, (uint32_t)(q0 + qc), (uint32_t)keys[r],
                                      t_hash, threshold);
          a = keep ? p : 0.f;
          dp = keep ? dp : 0.f;
        }
        stt[nt][j] = a;                  // A^T / inv_keep
        dpt[nt][j] = p * (dp - dl[qc]);  // dS^T / inv_keep (dl is delta / inv_keep)
      }
    }
    // dS^T -> shared memory for the block's dQ product
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(dS_ptr + swz(r0 + g + 8 * r, nt) + t4 * 4) =
            pack_bf16(dpt[nt][2 * r], dpt[nt][2 * r + 1]);

    // dV += A^T dO and dK += dS^T q: A^T and dS^T from registers, dO and q
    // MN-major (k = queries, 16 rows a step)
    uint32_t at[4][4], dst[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_as_a(at[kk], stt, kk);
      acc_as_a(dst[kk], dpt, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64<1>(dva, at[kk], gmma_desc(sD + kk * 16 * kRowBytes), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64<1>(dka, dst[kk], gmma_desc(sQ + kk * 16 * kRowBytes), 1);
    wgmma_commit();

    fence_proxy_async();
    bar_sync(kBarCompute, kCompute);  // both warpgroups' dS^T rows written

    // this warpgroup's dQ share: dS (64 queries x 128 keys, MN-major from
    // dS^T) . K (128 keys x columns 32wg..32wg+31, MN-major)
    float dqa[4][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss_n32<1, 1>(dqa, gmma_desc(sdS + kk * 16 * kRowBytes),
                         gmma_desc(sK + kk * 16 * kRowBytes + wg * 64), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dqa);
    fence_acc(dka);
    fence_acc(dva);

    // hand the share to the writer warp
    const int buf = it % kDqBufs;
    if (it >= kDqBufs) bar_sync(kBarEmpty + buf, kHandoff);
    float* share = dq_s + buf * kBQ * kD;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(share + (16 * wiw + g + 8 * r) * kD + 32 * wg + nt * 8 +
                                   2 * t4) = make_float2(dqa[nt][2 * r], dqa[nt][2 * r + 1]);
    fence_proxy_async();  // the bulk copy reads the share through the async proxy
    bar_arrive(kBarFull + buf, kHandoff);
  }
  store_rows(dk, dka, keys, b, h, T, H, scale * inv_keep, t4);
  store_rows(dv, dva, keys, b, h, T, H, inv_keep, t4);
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 on wgmma, the dK/dV and dQ kernels
// ---------------------------------------------------------------------------

// dK/dV: one block of 2 warpgroups per 128 keys (64 a warpgroup, 16 a warp)
// walks 32-query tiles
constexpr int kDkThreads = 256;
constexpr int kDkBK = 128;                               // keys per block
constexpr int kDkBQ = 32;                                // queries per tile
constexpr int kDkRaw = kDkBQ * kLdF;                     // floats of one raw q or dO tile
constexpr int kDkPlane = kDkBQ * kD * 4;                 // bytes of a plane of q, dO or their T
constexpr int kDkSmemBytes =                             // + slack to align the planes to 1 KB
    1024 + 8 * kDkPlane + (2 * kDkBK * kLdF + 2 * kDkRaw + 4 * kDkBQ) * 4;

__global__ void __launch_bounds__(kDkThreads, 1)
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
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // tile it: the planes (hi, lo) of q * scale and dO, and of their
  // transposes (queries permuted)
  const uint32_t sq = smem_u32(smem);
  const uint32_t sd = sq + 2 * kDkPlane;
  const uint32_t sqt = sd + 2 * kDkPlane;
  const uint32_t sdt = sqt + 2 * kDkPlane;
  float* sK = reinterpret_cast<float*>(smem + 8 * kDkPlane);  // the block's raw K and V
  float* sV = sK + kDkBK * kLdF;
  float* rawQ = sV + kDkBK * kLdF;  // tile it+1 lands here
  float* rawD = rawQ + kDkRaw;
  float* rawL = rawD + kDkRaw;      // lse, then delta
  float* ls = rawL + 2 * kDkBQ;     // tile it's lse (as p reads it), then delta
  float* dl = ls + kDkBQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kDkBK;
  const int n_qt = (T + kDkBQ - 1) / kDkBQ;
  const uint32_t seed_bh = seed_of(seed, bh);
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* db = dout + b * ds.b + h * ds.h;
  const float* lse_b = lse + (long long)bh * T;
  const float* delta_b = delta + (long long)bh * T;

  auto load_q = [&](int it) {
    load_tile_f32_async<kDkBQ, kDkThreads>(rawQ, qb, qs.t, it * kDkBQ, T, tid);
    load_tile_f32_async<kDkBQ, kDkThreads>(rawD, db, ds.t, it * kDkBQ, T, tid);
    load_vec_async<kDkBQ>(rawL, lse_b, it * kDkBQ, T, tid);
    load_vec_async<kDkBQ>(rawL + kDkBQ, delta_b, it * kDkBQ, T, tid - kDkBQ);
    cp_async_commit();
  };
  load_tile_f32_async<kDkBK, kDkThreads>(sK, kb, ks.t, k0, T, tid);
  load_tile_f32_async<kDkBK, kDkThreads>(sV, vb, vs.t, k0, T, tid);
  load_q(0);

  const NoKeyShift nk(lse_b, T);
  // this thread's keys: rows g and g+8 of its warp's 16
  const int r0 = 16 * warp;
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const int kcode[2] = {key_code(key_mask + (long long)b * T, keys[0], T),
                        key_code(key_mask + (long long)b * T, keys[1], T)};

  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    const int q0 = it * kDkBQ;
    cp_async_wait<0>();
    __syncthreads();  // raw tile it landed; tile it-1's planes are free
    split_rows_sw<kDkBQ, kDkThreads>(sq, rawQ, tid, scale);  // q is scaled in fp32
    split_cols_sw<kDkBQ, kDkThreads>(sqt, rawQ, tid, scale);
    split_rows_sw<kDkBQ, kDkThreads>(sd, rawD, tid);
    split_cols_sw<kDkBQ, kDkThreads>(sdt, rawD, tid);
    if (tid < kDkBQ)  // p = 0 past T
      ls[tid] = q0 + tid < T ? nk.lse(rawL[tid]) : CUDART_INF_F;
    else if (tid < 2 * kDkBQ)
      dl[tid - kDkBQ] = rawL[tid];
    fence_proxy_async();
    __syncthreads();  // planes written; the raw stage is free
    if (it + 1 < n_qt) load_q(it + 1);  // in flight while tile it computes

    // S^T = K (q * scale)^T and dP^T = V dO^T: 64 keys x 32 queries a
    // warpgroup; K's, then V's A fragments (split as read: both would not
    // fit beside the accumulators)
    float stt[kDkBQ / 8][4], dpt[kDkBQ / 8][4];
    FragA xa[kD / 8];
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc) xa[kc] = frag_a(sK, r0 + g, kc * 8 + t4);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc)
      wgmma_3xtf32(stt, xa[kc], sq, kDkPlane, kc, kDkBQ, kc == 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc) xa[kc] = frag_a(sV, r0 + g, kc * 8 + t4);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc)
      wgmma_3xtf32(dpt, xa[kc], sd, kDkPlane, kc, kDkBQ, kc == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(stt);
    fence_acc(dpt);

    // A^T = keep p inv_keep and dS^T = p (dP - delta), dP = keep dP inv_keep
#pragma unroll
    for (int nt = 0; nt < kDkBQ / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1, qc = nt * 8 + t4 * 2 + (j & 1);
        const float p = expf(replace_masked(stt[nt][j], kcode[r], nk.fill) - ls[qc]);
        float a = p, dp = dpt[nt][j];
        if (threshold) {
          const bool keep = keep_elem(seed_bh, (uint32_t)(q0 + qc), (uint32_t)keys[r], t_hash,
                                      threshold);
          a = keep ? p * inv_keep : 0.f;
          dp = keep ? dp * inv_keep : 0.f;
        }
        stt[nt][j] = a;
        dpt[nt][j] = p * (dp - dl[qc]);
      }
    }

    // dV += A^T dO and dK += dS^T (q * scale): A^T and dS^T from the
    // accumulators (queries permuted), B from the transposed planes
    FragA aa[kDkBQ / 8], sa[kDkBQ / 8];
#pragma unroll
    for (int kc = 0; kc < kDkBQ / 8; ++kc) {
      aa[kc] = acc_as_frag_a(stt[kc]);
      sa[kc] = acc_as_frag_a(dpt[kc]);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kDkBQ / 8; ++kc)
      wgmma_3xtf32(dva, aa[kc], sdt, kDkPlane, kc, kD, false);
#pragma unroll
    for (int kc = 0; kc < kDkBQ / 8; ++kc)
      wgmma_3xtf32(dka, sa[kc], sqt, kDkPlane, kc, kD, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dva);
    fence_acc(dka);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= T) continue;
    const long long off = ((long long)b * T + keys[r]) * ((long long)H * kD) + (long long)h * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      *reinterpret_cast<float2*>(dk + off + dn * 8 + 2 * t4) =
          make_float2(dka[dn][2 * r], dka[dn][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + off + dn * 8 + 2 * t4) =
          make_float2(dva[dn][2 * r], dva[dn][2 * r + 1]);
    }
  }
}

// dQ: one block of 2 warpgroups per 128 queries (64 a warpgroup, 16 a warp)
// walks 64-key tiles
constexpr int kDqThreads = 256;
constexpr int kDqBQ = 128;                               // queries per block
constexpr int kDqBK = 64;                                // keys per tile
constexpr int kDqRaw = kDqBK * kLdF;                     // floats of one raw K or V tile
constexpr int kDqPlane = kDqBK * kD * 4;                 // bytes of a plane of K, K^T or V
constexpr int kDqSmemBytes =                             // + slack to align the planes to 1 KB
    1024 + 6 * kDqPlane + (2 * kDqBQ * kLdF + 2 * kDqRaw + 2 * kDqBK) * 4;

__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ key_mask,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
                        int T, int H, Strides qs, Strides ks, Strides vs,
                        Strides ds, float scale, uint32_t seed, uint32_t t_hash,
                        uint32_t threshold, float inv_keep) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // tile kt: the planes (hi, lo) of K, of K^T (keys permuted) and of V
  const uint32_t sk = smem_u32(smem);
  const uint32_t skt = sk + 2 * kDqPlane;
  const uint32_t sv = skt + 2 * kDqPlane;
  float* sQ = reinterpret_cast<float*>(smem + 6 * kDqPlane);  // the block's raw q and dO
  float* sD = sQ + kDqBQ * kLdF;
  float* rawK = sD + kDqBQ * kLdF;  // tile kt+1 lands here
  float* rawV = rawK + kDqRaw;
  int* rawM = reinterpret_cast<int*>(rawV + kDqRaw);
  int* mc = rawM + kDqBK;  // tile kt's key mask

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kDqBQ;
  const int n_kt = (T + kDqBK - 1) / kDqBK;
  const uint32_t seed_bh = seed_of(seed, bh);
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* db = dout + b * ds.b + h * ds.h;
  const int* mb = key_mask + (long long)b * T;

  auto load_kv = [&](int kt) {
    load_tile_f32_async<kDqBK, kDqThreads>(rawK, kb, ks.t, kt * kDqBK, T, tid);
    load_tile_f32_async<kDqBK, kDqThreads>(rawV, vb, vs.t, kt * kDqBK, T, tid);
    load_vec_async<kDqBK>(rawM, mb, kt * kDqBK, T, tid);
    cp_async_commit();
  };
  load_tile_f32_async<kDqBQ, kDqThreads>(sQ, qb, qs.t, q0, T, tid);
  load_tile_f32_async<kDqBQ, kDqThreads>(sD, db, ds.t, q0, T, tid);
  load_kv(0);

  const NoKeyShift nk(lse + (long long)bh * T, T);
  const int r0 = 16 * warp;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = rows[r] < T ? nk.lse(lse[(long long)bh * T + rows[r]]) : CUDART_INF_F;
    delta_r[r] = rows[r] < T ? delta[(long long)bh * T + rows[r]] : 0.f;
  }

  float dqa[kD / 8][4];
#pragma unroll
  for (int i = 0; i < kD / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // raw tile kt landed; tile kt-1's planes are free
    split_rows_sw<kDqBK, kDqThreads>(sk, rawK, tid);
    split_cols_sw<kDqBK, kDqThreads>(skt, rawK, tid);
    split_rows_sw<kDqBK, kDqThreads>(sv, rawV, tid);
    if (tid < kDqBK) mc[tid] = rawM[tid];
    fence_proxy_async();
    __syncthreads();  // planes written; the raw stage is free
    if (kt + 1 < n_kt) load_kv(kt + 1);  // in flight while tile kt computes
    const int k0 = kt * kDqBK;

    // S = (q * scale) K^T and dP = dO V^T: 64 queries x 64 keys a
    // warpgroup; q's, then dO's A fragments (split as read: both would not
    // fit beside the accumulators)
    float s[kDqBK / 8][4], dp[kDqBK / 8][4];
    FragA xa[kD / 8];
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc) xa[kc] = frag_a(sQ, r0 + g, kc * 8 + t4, scale);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc) wgmma_3xtf32(s, xa[kc], sk, kDqPlane, kc, kDqBK, kc == 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc) xa[kc] = frag_a(sD, r0 + g, kc * 8 + t4);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc) wgmma_3xtf32(dp, xa[kc], sv, kDqPlane, kc, kDqBK, kc == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);

#pragma unroll
    for (int nt = 0; nt < kDqBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1, col = nt * 8 + t4 * 2 + (j & 1);
        const int code = k0 + col < T ? (mc[col] > 0 ? 1 : 0) : -1;
        const float p = expf(replace_masked(s[nt][j], code, nk.fill) - lse_r[r]);
        float dpv = dp[nt][j];
        if (threshold)
          dpv = keep_elem(seed_bh, (uint32_t)rows[r], (uint32_t)(k0 + col), t_hash, threshold)
                    ? dpv * inv_keep : 0.f;
        s[nt][j] = p * (dpv - delta_r[r]);
      }
    }

    // dQ += dS K: dS from the accumulators (keys permuted), K^T's planes
    FragA sa[kDqBK / 8];
#pragma unroll
    for (int kc = 0; kc < kDqBK / 8; ++kc) sa[kc] = acc_as_frag_a(s[kc]);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kDqBK / 8; ++kc) wgmma_3xtf32(dqa, sa[kc], skt, kDqPlane, kc, kD, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dqa);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T) continue;
    float* orow = dq + ((long long)b * T + rows[r]) * ((long long)H * kD) + (long long)h * kD;
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn)
      *reinterpret_cast<float2*>(orow + dn * 8 + 2 * t4) =
          make_float2(dqa[dn][2 * r] * scale, dqa[dn][2 * r + 1] * scale);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// `lse` is B1's fp32 [B, H, T] output, `delta` an fp32 [B, H, T] scratch
// buffer. For bf16, `dq_accum` is an fp32 [B*H, T, 64] scratch buffer (no
// initial value needed) and `dq_sem` an int32 buffer of B*H*ceil(T/64)
// ZEROS (the key-tile order counters); both are unused for fp32. Launches
// three kernels on `stream`, does not synchronise, and returns the first
// launch error (cudaGetLastError()), 0 on success.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* key_mask, const void* o, const void* dout,
                         const void* lse, void* delta, void* dq_accum, void* dq_sem,
                         void* dq, void* dk, void* dv, int dtype, int B, int T, int H,
                         int D, long long qsb, long long qst, long long qsh,
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
  const long long rows = (long long)B * H * T;
  const unsigned delta_blocks = (unsigned)((rows + 7) / 8);
  cudaError_t err;
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (attr != cudaSuccess) return (int)attr;
    // the element loop leaves inv_keep out: A, dP and delta carry 1/inv_keep,
    // and dk, dv and dq take it back once at the end
    flash_bwd_delta_kernel<<<delta_blocks, 256, 0, st>>>(
        static_cast<const bf*>(o), static_cast<const bf*>(dout), delta_f, T, H, rows, os,
        ds, 1.f / inv_keep);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    flash_bwd_bf16_kernel<<<dim3((T + kBK - 1) / kBK, B * H), kThreads, kSmemBytes, st>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), km,
        static_cast<const bf*>(dout), lse_f, delta_f, static_cast<float*>(dq_accum),
        static_cast<int*>(dq_sem), static_cast<bf*>(dk),
        static_cast<bf*>(dv), T, H, qs, ks, vs, ds, scale, (uint32_t)seed,
        (uint32_t)t_hash, threshold, inv_keep);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const long long n8 = rows * (kD / 8);
    flash_bwd_dq_convert_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(dq_accum), static_cast<bf*>(dq), T, H, n8, scale * inv_keep);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *df = static_cast<const float*>(dout);
    flash_bwd_delta_kernel<<<delta_blocks, 256, 0, st>>>(static_cast<const float*>(o), df,
                                                         delta_f, T, H, rows, os, ds, 1.f);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    static const cudaError_t attr_dk = cudaFuncSetAttribute(
        flash_bwd_dkdv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkSmemBytes);
    if (attr_dk != cudaSuccess) return (int)attr_dk;
    static const cudaError_t attr_dq = cudaFuncSetAttribute(
        flash_bwd_dq_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
    if (attr_dq != cudaSuccess) return (int)attr_dq;
    flash_bwd_dkdv_f32_kernel<<<dim3((T + kDkBK - 1) / kDkBK, B * H), kDkThreads, kDkSmemBytes,
                                st>>>(
        qf, kf, vf, km, df, lse_f, delta_f, static_cast<float*>(dk), static_cast<float*>(dv),
        T, H, qs, ks, vs, ds, scale, (uint32_t)seed, (uint32_t)t_hash, threshold, inv_keep);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    flash_bwd_dq_f32_kernel<<<dim3((T + kDqBQ - 1) / kDqBQ, B * H), kDqThreads, kDqSmemBytes,
                              st>>>(
        qf, kf, vf, km, df, lse_f, delta_f, static_cast<float*>(dq), T, H, qs, ks, vs, ds,
        scale, (uint32_t)seed, (uint32_t)t_hash, threshold, inv_keep);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
