// What kernels B1 (flash_fwd.cu) and B2 (flash_bwd.cu) share, so that the
// two cannot drift apart: the constants and the keep hash of the TPU
// kernels, the swizzled shared-memory tile layout, the asynchronous tile
// loaders (cp.async with zero fill past T and past the head dim), the wgmma
// descriptors, instructions and fences, and the fp32 paths' 3xTF32 split,
// planes and TF32 wgmma products (last section).
//
// Head dims. The kernels are templates on the head dim D: 64 (every
// encoder of 16 heads at 1024) and 120 (XLS-R's 1920 at 16 heads). A tile
// holds DP = D rounded up to 64 columns (padded_dim); the columns from D to
// DP are zero-filled on load, so every product over them adds exact zeros,
// and are never stored. In global memory a row is D elements (240 bytes at
// D = 120, still whole 16-byte chunks); in shared memory it is DP.
//
// Tile layout. A [rows, DP] bf16 tile is stored as DP / 64 column blocks,
// each [rows, 64] of 128-byte rows of eight 16-byte chunks, the blocks
// rows * 128 bytes apart; chunk c of row r of a block sits at chunk
// c ^ (r & 7). That is the 128-byte swizzle of wgmma's shared-memory
// descriptors (layout type 1) when the block starts on a 1024-byte boundary,
// and it makes every 4-byte accumulator store of 8 consecutive rows free of
// bank conflicts. A product over the head dim (K-major operands) steps k
// through the blocks in turn; one whose n is the head dim runs once per
// block, so no descriptor spans two blocks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr float kMaskFill = -1e30f;  // NEG_INF of the TPU kernel
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kAtom = 64;            // bf16 columns of one swizzle atom (a column block)
constexpr int kRowBytes = kAtom * 2; // one row of a column block

// the head dim a tile holds: D rounded up to whole column blocks
__host__ __device__ constexpr int padded_dim(int d) { return (d + kAtom - 1) / kAtom * kAtom; }

struct Strides {
  long long b, t, h;  // in elements; the D stride is 1
};

// ---------------------------------------------------------------------------
// the TPU kernels' counter-based dropout and mask replacement
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t seed_of(uint32_t seed, int bh) {
  return fmix32(seed + (uint32_t)bh * kGolden);
}

// Where a call's rows sit in the logical batch (ops/attention.py): the hash
// indexes the global (b * h_total + h_off + h) and query row q_off + row.
// All zero, h_total = H: the call is the whole batch.
struct HashPos {
  int b_off, q_off, h_off, h_total;
  __device__ __forceinline__ int bh(int b, int h) const {
    return (b_off + b) * h_total + h_off + h;
  }
};

__device__ __forceinline__ bool keep_elem(uint32_t seed_bh, uint32_t row,
                                          uint32_t col, uint32_t t_hash,
                                          uint32_t threshold) {
  return (fmix32((row * t_hash + col) ^ seed_bh) & 0x7FFFFFFFu) >= threshold;
}

// key code: 1 valid, 0 masked, -1 past T
__device__ __forceinline__ int key_code(const int* mask_b, int col, int T) {
  return col < T ? (mask_b[col] > 0 ? 1 : 0) : -1;
}

// scaled score after the mask replacement
__device__ __forceinline__ float replace_masked(float x, int code, float fill) {
  return code > 0 ? x : (code == 0 ? fill : -CUDART_INF_F);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// shared memory: swizzled tiles and asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `ch` of row `r` in a swizzled tile of `rows`
// rows (chunks 8 and up lie in the later column blocks)
__device__ __forceinline__ uint32_t swz(int r, int ch, int rows) {
  return (uint32_t)((ch >> 3) * rows * kRowBytes + r * kRowBytes + (((ch & 7) ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; with `n` = 0 the destination is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + R) of a [T, D] bf16 slice with row stride `rs` ->
// the swizzled [R, padded_dim(D)] tile at `dst`; rows past T and the
// columns past D are zero-filled
template <int R, int NT, int D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* base,
                                                long long rs, int row0, int T, int tid) {
  constexpr int kCh = padded_dim(D) / 8;  // 16-byte chunks of a tile row
  static_assert(D % 8 == 0 && (R * kCh) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * kCh / NT; ++i) {
    const unsigned c = tid + i * NT;  // unsigned: the divisions are shifts
    const int r = c / kCh, ch = c % kCh;
    const bool in = row0 + r < T && ch < D / 8;
    const __nv_bfloat16* src = base + (in ? (long long)(row0 + r) * rs + ch * 8 : 0);
    cp_async16(dst + swz(r, ch, R), src, in ? 16 : 0);
  }
}

// entries [i0, i0 + N) of an fp32 or int32 vector of length T -> smem
// (entries past T are zero-filled); threads 0 <= tid < N copy one each
template <int N, typename E>
__device__ __forceinline__ void load_vec_async(E* dst, const E* src, int i0, int T,
                                               int tid) {
  if ((unsigned)tid < (unsigned)N) {
    const bool in = i0 + tid < T;
    cp_async4(smem_u32(dst + tid), src + (in ? i0 + tid : 0), in ? 4 : 0);
  }
}

// The accumulator of a 16-row product over 16 k columns (c[2kk], c[2kk+1],
// 8 columns each) re-packed as the A fragment of the next product: the
// row/column layout of a wgmma accumulator in each warp (as mma.sync's C)
// coincides with that of a register A operand (as mma.sync's A).
template <int N>
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// ---------------------------------------------------------------------------
// wgmma: a warpgroup's 64-row products, operands in swizzled tiles
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled tile (128-byte swizzle,
// layout type 1) whose 8-row groups lie 1024 bytes apart. Both orientations
// use it: a K-major operand (rows = M or N, 64 k columns) steps k by 32
// bytes from its start; an MN-major one (rows = k, 64 m or n columns) steps
// k by 16 rows (2048 bytes), and n by 2 bytes a column. Every tile starts on
// a 1024-byte boundary, so the swizzle phase is the row index. The leading
// byte offset is never read: no operand spans more than one 64-column atom.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of this thread (st.shared, cp.async) made visible to
// the async proxy that wgmma reads through; a barrier must follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

// D[64 x 64] (+)= A . B, both from shared memory; TA / TB = 1: that operand
// is stored MN-major (transposed). D[j][i] is the accumulator layout of
// mma.sync, warp w of the warpgroup holding rows 16w..16w+15.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 32] (+)= A . B, both from shared memory; TA / TB = 1: that operand
// is stored MN-major (transposed). D[j][i] is the accumulator layout of
// mma.sync, warp w of the warpgroup holding rows 16w..16w+15.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// D[64 x 64] (+)= A . B with A from registers (each warp the mma.sync A
// fragment of its 16 rows, acc_as_a) and B from shared memory; TB = 1: B is
// stored MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 products on wgmma
// ---------------------------------------------------------------------------
//
// Each fp32 operand x is split into hi = rna(x) and lo = rna(x - hi) in TF32,
// and a product is lo.hi + hi.lo + hi.hi, small terms first, into one fp32
// accumulator: about fp32's accuracy (the dropped lo.lo term is 2^-22 of the
// product) where one TF32 product keeps about three decimal digits.
//
// wgmma takes tf32 operands from shared memory K-major only (no transpose
// bit), or A from registers. So each B operand is split once per block
// into a hi and a lo plane in the 128-byte swizzle of the descriptors,
// either as the raw tile is stored (split_rows_sw) or transposed
// (split_cols_sw), and an A operand is split into registers (frag_a, or
// acc_as_frag_a from the accumulator of the product before).
//
// Tiles. A raw tile is fp32 as cp.async lands it, [rows, DP] with rows
// ldf(DP) = DP + 4 floats apart (68 at D = 64, 132 at D = 120): the 4-float
// pad puts the 8 rows x 4 columns of an A fragment on distinct banks. A
// plane of R rows holds K = DP (or R) tf32 columns as atoms of 32 columns
// (128-byte rows, 16-byte chunk c of row r at c ^ (r & 7)), R * 128 bytes
// apart, each 1024-byte aligned.

__host__ __device__ constexpr int ldf(int dp) { return dp + 4; }  // floats per raw tile row
constexpr int kLdF = ldf(64);  // the D = 64 tiles' (fp32 B2 runs at D = 64 only)

// rows [row0, row0 + R) of a [T, D] fp32 slice with row stride `rs` -> the
// raw [R, padded_dim(D)] tile at `dst`; rows past T and the columns past D
// are zero-filled
template <int R, int NT, int D = 64>
__device__ __forceinline__ void load_tile_f32_async(float* dst, const float* base, long long rs,
                                                    int row0, int T, int tid) {
  constexpr int kCh = padded_dim(D) / 4, kLd = ldf(padded_dim(D));
  static_assert(D % 4 == 0 && (R * kCh) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * kCh / NT; ++i) {
    const unsigned c = tid + i * NT;
    const int r = c / kCh, ch = c % kCh;
    const bool in = row0 + r < T && ch < D / 4;
    const float* src = base + (in ? (long long)(row0 + r) * rs + ch * 4 : 0);
    cp_async16(smem_u32(dst + r * kLd + ch * 4), src, in ? 16 : 0);
  }
}

struct Tf32Pair {
  uint32_t hi, lo;
};

// x rounded to TF32, to nearest with ties away from zero: the value of
// cvt.rna.tf32.f32 for every input but a NaN, in two integer operations
// where that instruction compiles to a NaN-guarded sequence
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ Tf32Pair split_tf32(float x) {
  const uint32_t hi = tf32_rna(x);
  return {hi, tf32_rna(x - __uint_as_float(hi))};  // x - hi is exact
}

// byte offset of element (r, k) of a plane of `rows` rows
__device__ __forceinline__ uint32_t swz32(int r, int k, int rows) {
  return (uint32_t)((k >> 5) * (rows * 128) + r * 128 + ((((k & 31) >> 2) ^ (r & 7)) << 4));
}

// descriptor of k columns [8kc, 8kc + 8) of the plane at `base`
__device__ __forceinline__ uint64_t plane_desc(uint32_t base, int kc, int rows) {
  return gmma_desc(base + (kc >> 2) * (rows * 128)) + 2 * (kc & 3);
}

// x times f, split: hi's 16 bytes at `hi`, lo's at `lo` (shared addresses)
__device__ __forceinline__ void st_split4(uint32_t hi, uint32_t lo, float4 x, float f) {
  const Tf32Pair p0 = split_tf32(x.x * f), p1 = split_tf32(x.y * f), p2 = split_tf32(x.z * f),
                 p3 = split_tf32(x.w * f);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi), "r"(p0.hi), "r"(p1.hi),
               "r"(p2.hi), "r"(p3.hi) : "memory");
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo), "r"(p0.lo), "r"(p1.lo),
               "r"(p2.lo), "r"(p3.lo) : "memory");
}

// the raw tile (rows [0, R), DP columns) times f -> its hi plane at dst
// ([R rows, DP k]) and its lo plane after it
template <int R, int NT, int DP = 64>
__device__ __forceinline__ void split_rows_sw(uint32_t dst, const float* raw, int tid,
                                              float f = 1.f) {
  constexpr int kCh = DP / 4, kLd = ldf(DP);
  static_assert((R * kCh) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * kCh / NT; ++i) {
    const unsigned c = tid + i * NT;
    const int r = c / kCh, ch = c % kCh;
    const uint32_t at = dst + swz32(r, ch * 4, R);
    st_split4(at, at + R * DP * 4, *reinterpret_cast<const float4*>(raw + r * kLd + ch * 4), f);
  }
}

// the transpose of the raw tile (rows [0, R), DP columns) times f -> hi
// plane at dst ([DP rows, R k]) and lo after it, the R columns permuted
// within each 8: source rows 8a + e + 2j (j = 0..3) land at k = 8a + 4e + j,
// the order in which acc_as_frag_a holds them
template <int R, int NT, int DP = 64>
__device__ __forceinline__ void split_cols_sw(uint32_t dst, const float* raw, int tid,
                                              float f = 1.f) {
  constexpr int kLd = ldf(DP);
  static_assert((R / 4 * DP) % NT == 0, "whole items per thread");
#pragma unroll
  for (int i = 0; i < R / 4 * DP / NT; ++i) {
    const int it = tid + i * NT, c = it & (DP - 1), grp = it / DP;
    const int r0 = (grp >> 1) * 8 + (grp & 1);
    const float4 x = make_float4(raw[r0 * kLd + c], raw[(r0 + 2) * kLd + c],
                                 raw[(r0 + 4) * kLd + c], raw[(r0 + 6) * kLd + c]);
    const uint32_t at = dst + swz32(c, (grp >> 1) * 8 + (grp & 1) * 4, DP);
    st_split4(at, at + DP * R * 4, x, f);
  }
}

// a warp's A fragment of a k8 step (a0 row g col t4, a1 row g+8, a2 col
// t4+4, a3 both: mma.sync m16n8k8's layout, which wgmma's tf32 A in
// registers shares, warp w of the warpgroup holding rows 16w..16w+15), split
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int i, float x) {
    const Tf32Pair p = split_tf32(x);
    hi[i] = p.hi;
    lo[i] = p.lo;
  }
};

// A fragment from a raw tile of rows LD floats apart: rows r, r + 8,
// columns c, c + 4, times f
template <int LD = kLdF>
__device__ __forceinline__ FragA frag_a(const float* tile, int r, int c, float f = 1.f) {
  FragA a;
#pragma unroll
  for (int i = 0; i < 4; ++i) a.set(i, tile[(r + (i & 1) * 8) * LD + c + (i >> 1) * 4] * f);
  return a;
}

// The accumulator of an n-tile (c0 row g col 2t4, c1 col 2t4+1, c2 row g+8,
// c3 both) as the A fragment of the next product over those 8 columns, whose
// k positions t4 and t4 + 4 then stand for columns 2t4 and 2t4 + 1: the
// order of split_cols_sw, so the sum over k is the same.
__device__ __forceinline__ FragA acc_as_frag_a(const float (&c)[4]) {
  FragA a;
  a.set(0, c[0]);
  a.set(1, c[2]);
  a.set(2, c[1]);
  a.set(3, c[3]);
  return a;
}

#define FLASH_ACC16(d)                                                                       \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),            \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])

// D[64 x 64] (+)= A . B, TF32: A from registers, B K-major from a plane
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : FLASH_ACC16(d), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A . B, TF32: A from registers, B K-major from a plane
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : FLASH_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef FLASH_ACC16

// D (+)= A . B over k columns [8kc, 8kc + 8) in 3xTF32, lo.hi + hi.lo +
// hi.hi: B's hi plane (of `rows` rows) at `hi`, its lo plane at hi + lo_off;
// `first` overwrites D
template <int N>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[N][4], const FragA& a, uint32_t hi,
                                             uint32_t lo_off, int kc, int rows, bool first) {
  wgmma_tf32_rs(d, a.lo, plane_desc(hi, kc, rows), first ? 0 : 1);
  wgmma_tf32_rs(d, a.hi, plane_desc(hi + lo_off, kc, rows), 1);
  wgmma_tf32_rs(d, a.hi, plane_desc(hi, kc, rows), 1);
}

}  // namespace flash
