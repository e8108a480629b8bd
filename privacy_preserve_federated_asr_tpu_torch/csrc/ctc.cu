// CTC loss recursions for Hopper (sm_90a): the alpha pass and the beta pass
// with the path posterior, for ops/ctc.py's _CTCNLL on CUDA tensors.
//
// Replaces no TPU kernel: the JAX package runs both recursions as a lax.scan
// over time (privacy_preserve_federated_asr_tpu/ops/ctc.py::_ctc_fwd_pass and
// ::_ctc_fast_bwd), and the port's plain version loops over the frames in
// Python (ops/ctc.py::_alphas, ::_dnll), a few launches per frame. On the card
// those launches set the time: the device work is one [B, S] state per frame.
// Here each kernel walks all the frames of a row in one launch.
//
// Both kernels do the loop's arithmetic in fp32 in the loop's order, with its
// LOG_EPSILON = -1e5 floors and torch's logaddexp (max + log1p(exp(-|x-y|))):
//   alpha: prev2 = max(a[s-2] + skip_pen[s], NEG)
//          a'[s] = max(logaddexp(logaddexp(a[s], a[s-1]), prev2) + emit_inv[t, s], NEG)
//          kept while t < len, else a[s]; frame 0 is emit_inv[0, s] for s < 2.
//   beta:  c[s] = max(emit[min(t+1, T-1), s] + beta[s], NEG), c[S] = c[S+1] = NEG
//          beta'[s] = max(logaddexp(logaddexp(c[s], c[s+1]), max(c[s+2] + skip_fwd[s], NEG))
//                         + invalid[s], NEG)
//          init_row at t = (int)(len - 1), NEG for t >= len.
//   dnll[t, s] = -exp(clamp(alpha + beta - log_z, 2 NEG, 0)) * feasible * (t < len)
// The betas are never stored: the beta kernel writes the posterior gradient
// dnll [T, B, S] frame by frame.
//
// Layout: emit [B, T, S] (the einsum's output), alphas and dnll [T, B, S],
// the structure tensors valid_s, can_skip, final_ind [B, S], lengths and
// log_z [B], all contiguous fp32. Lengths are read on the device, so a launch
// needs no host sync and a CUDA graph can capture it.
//
// Bound on an H100: the bytes (emit, alphas and dnll, ~25 MB at B=64, T=249,
// S=129) need ~7 us at 3.35 TB/s; what bounds a kernel is the serial chain of
// T frames, each two logaddexps (an exp and a log1p each) deep plus one
// shared-memory exchange. So:
//   * one CTA per batch row, threads strided over the S = 2L+1 states; a
//     thread owns K states (K a power of two, up to 16), so any S up to
//     kMaxThreads * kMaxPerThread runs, however wide the block;
//   * the previous frame's values live in shared memory, double-buffered, with
//     two NEG sentinel slots (the s-1, s-2 predecessors before state 0 in the
//     alpha kernel; the s+1, s+2 successors after state S-1 in the beta
//     kernel): one __syncthreads per frame;
//   * the next frame's emission (and, in the beta kernel, alpha) is loaded
//     into registers while the current frame is computed;
//   * every output element is written by one thread, in a fixed order: no
//     atomics, so two calls give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e5f;  // LOG_EPSILON
constexpr int kMaxThreads = 512;
constexpr int kMaxPerThread = 16;
constexpr int kMaxStates = kMaxThreads * kMaxPerThread;
constexpr int kMaxSmemBytes = 2 * (kMaxStates + 2) * (int)sizeof(float);

// torch's clamp_min / clamp: NaN passes through
__device__ __forceinline__ float floor_at(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch's CUDA logaddexp, term for term
__device__ __forceinline__ float logaddexp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// the last frame t with t < len (-1 if none), at most T - 1
__device__ __forceinline__ int last_active(float len, int T) {
  return (int)fminf(fmaxf(ceilf(len), 0.0f), (float)T) - 1;
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
ctc_alpha_kernel(const float* __restrict__ emit, const float* __restrict__ valid_s,
                 const float* __restrict__ can_skip, const float* __restrict__ len_f,
                 float* __restrict__ alphas, int B, int T, int S) {
  extern __shared__ float buf[];  // two frames of [NEG, NEG, a_0 .. a_{S-1}]
  const int b = blockIdx.x;
  const int top = last_active(len_f[b], T);
  const float* e = emit + (size_t)b * T * S;
  const float* row_valid = valid_s + (size_t)b * S;
  const float* row_skip = can_skip + (size_t)b * S;
  float* out = alphas + (size_t)b * S;
  const size_t frame = (size_t)B * S;
  if (threadIdx.x < 2) {
    buf[threadIdx.x] = kNeg;
    buf[S + 2 + threadIdx.x] = kNeg;
  }
  float inv[K], pen[K], a[K], nxt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = threadIdx.x + k * blockDim.x;
    if (s < S) {
      inv[k] = (1.0f - row_valid[s]) * kNeg;
      pen[k] = (1.0f - row_skip[s]) * kNeg;
      a[k] = floor_at(s < 2 ? e[s] + inv[k] : kNeg, kNeg);
      buf[s + 2] = a[k];
      out[s] = a[k];
      if (top >= 1) nxt[k] = e[S + s];
    }
  }
  __syncthreads();
  for (int t = 1; t <= top; ++t) {
    const float* prev = buf + ((t - 1) & 1) * (S + 2);
    float* cur = buf + (t & 1) * (S + 2);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s < S) {
        const float emit_inv = nxt[k] + inv[k];
        if (t < top) nxt[k] = e[(size_t)(t + 1) * S + s];
        const float prev2 = floor_at(prev[s] + pen[k], kNeg);
        float v = logaddexp(logaddexp(prev[s + 2], prev[s + 1]), prev2);
        v = floor_at(v + emit_inv, kNeg);
        a[k] = v;
        cur[s + 2] = v;
        out[t * frame + s] = v;
      }
    }
    __syncthreads();
  }
  // past the row's length the loop keeps every alpha: copies of the last frame
  for (int t = max(top + 1, 1); t < T; ++t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s < S) out[t * frame + s] = a[k];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
ctc_beta_kernel(const float* __restrict__ emit, const float* __restrict__ alphas,
                const float* __restrict__ log_z, const float* __restrict__ valid_s,
                const float* __restrict__ can_skip, const float* __restrict__ final_ind,
                const float* __restrict__ len_f, float* __restrict__ dnll, int B, int T,
                int S) {
  extern __shared__ float buf[];  // two frames of [c_0 .. c_{S-1}, NEG, NEG]
  const int b = blockIdx.x;
  const float len = len_f[b];
  const int top = last_active(len, T);
  const int last = (int)fminf(fmaxf(len - 1.0f, -1.0f), (float)T);  // (len - 1).long()
  const float lz = log_z[b];
  const float feasible = lz > 0.5f * kNeg ? 1.0f : 0.0f;
  const float* e = emit + (size_t)b * T * S;
  const float* al = alphas + (size_t)b * S;
  const float* row_valid = valid_s + (size_t)b * S;
  const float* row_skip = can_skip + (size_t)b * S;
  const float* row_final = final_ind + (size_t)b * S;
  float* out = dnll + (size_t)b * S;
  const size_t frame = (size_t)B * S;
  if (threadIdx.x < 2) {
    buf[S + threadIdx.x] = kNeg;
    buf[2 * S + 2 + threadIdx.x] = kNeg;
  }
  float invalid[K], skip[K], init[K], beta[K], e_next[K], a_cur[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = threadIdx.x + k * blockDim.x;
    if (s < S) {
      invalid[k] = (1.0f - row_valid[s]) * kNeg;
      skip[k] = s + 2 < S ? (1.0f - row_skip[s + 2]) * kNeg : kNeg;
      init[k] = row_final[s] > 0.0f ? 0.0f : kNeg;
      beta[k] = kNeg;
      // frames past the row's length: beta is NEG and the time mask 0
      for (int t = T - 1; t > top; --t)
        out[t * frame + s] =
            -expf(clamp(al[t * frame + s] + kNeg - lz, 2.0f * kNeg, 0.0f)) * feasible * 0.0f;
      if (top >= 0) {
        e_next[k] = e[(size_t)min(top + 1, T - 1) * S + s];
        a_cur[k] = al[top * frame + s];
      }
    }
  }
  for (int t = top; t >= 0; --t) {
    float* c = buf + (t & 1) * (S + 2);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s < S) {
        c[s] = floor_at(e_next[k] + beta[k], kNeg);
        if (t > 0) e_next[k] = e[(size_t)t * S + s];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s < S) {
        const float nxt2 = floor_at(c[s + 2] + skip[k], kNeg);
        float v = logaddexp(logaddexp(c[s], c[s + 1]), nxt2);
        v = floor_at(v + invalid[k], kNeg);
        if (t == last) v = init[k];
        beta[k] = v;
        const float alpha = a_cur[k];
        if (t > 0) a_cur[k] = al[(t - 1) * frame + s];
        out[t * frame + s] = -expf(clamp(alpha + v - lz, 2.0f * kNeg, 0.0f)) * feasible * 1.0f;
      }
    }
  }
}

template <int K>
int launch_alpha(const float* emit, const float* valid_s, const float* can_skip,
                 const float* len_f, float* alphas, int B, int T, int S, int threads,
                 cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ctc_alpha_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = 2 * (size_t)(S + 2) * sizeof(float);
  ctc_alpha_kernel<K><<<B, threads, smem, st>>>(emit, valid_s, can_skip, len_f, alphas, B,
                                                T, S);
  return (int)cudaGetLastError();
}

template <int K>
int launch_beta(const float* emit, const float* alphas, const float* log_z,
                const float* valid_s, const float* can_skip, const float* final_ind,
                const float* len_f, float* dnll, int B, int T, int S, int threads,
                cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ctc_beta_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = 2 * (size_t)(S + 2) * sizeof(float);
  ctc_beta_kernel<K><<<B, threads, smem, st>>>(emit, alphas, log_z, valid_s, can_skip,
                                               final_ind, len_f, dnll, B, T, S);
  return (int)cudaGetLastError();
}

// States per thread (a power of two) and threads per block for S states.
bool block_shape(int S, int* per_thread, int* threads) {
  if (S <= 0 || S > kMaxStates) return false;
  int k = 1;
  while (k * kMaxThreads < S) k *= 2;
  *per_thread = k;
  *threads = ((S + k - 1) / k + 31) / 32 * 32;
  return true;
}

}  // namespace

// alphas [T, B, S] of the forward recursion; returns a cudaError_t.
extern "C" int ctc_alpha(const void* emit, const void* valid_s, const void* can_skip,
                         const void* len_f, void* alphas, int B, int T, int S,
                         void* stream) {
  int k, threads;
  if (B <= 0 || T <= 0 || !block_shape(S, &k, &threads)) return (int)cudaErrorInvalidValue;
  const auto* em = static_cast<const float*>(emit);
  const auto* va = static_cast<const float*>(valid_s);
  const auto* sk = static_cast<const float*>(can_skip);
  const auto* ln = static_cast<const float*>(len_f);
  auto* al = static_cast<float*>(alphas);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_alpha<1>(em, va, sk, ln, al, B, T, S, threads, st);
    case 2: return launch_alpha<2>(em, va, sk, ln, al, B, T, S, threads, st);
    case 4: return launch_alpha<4>(em, va, sk, ln, al, B, T, S, threads, st);
    case 8: return launch_alpha<8>(em, va, sk, ln, al, B, T, S, threads, st);
    default: return launch_alpha<16>(em, va, sk, ln, al, B, T, S, threads, st);
  }
}

// dnll [T, B, S], the posterior gradient of each row's NLL; returns a cudaError_t.
extern "C" int ctc_beta(const void* emit, const void* alphas, const void* log_z,
                        const void* valid_s, const void* can_skip, const void* final_ind,
                        const void* len_f, void* dnll, int B, int T, int S, void* stream) {
  int k, threads;
  if (B <= 0 || T <= 0 || !block_shape(S, &k, &threads)) return (int)cudaErrorInvalidValue;
  const auto* em = static_cast<const float*>(emit);
  const auto* al = static_cast<const float*>(alphas);
  const auto* lz = static_cast<const float*>(log_z);
  const auto* va = static_cast<const float*>(valid_s);
  const auto* sk = static_cast<const float*>(can_skip);
  const auto* fi = static_cast<const float*>(final_ind);
  const auto* ln = static_cast<const float*>(len_f);
  auto* out = static_cast<float*>(dnll);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_beta<1>(em, al, lz, va, sk, fi, ln, out, B, T, S, threads, st);
    case 2: return launch_beta<2>(em, al, lz, va, sk, fi, ln, out, B, T, S, threads, st);
    case 4: return launch_beta<4>(em, al, lz, va, sk, fi, ln, out, B, T, S, threads, st);
    case 8: return launch_beta<8>(em, al, lz, va, sk, fi, ln, out, B, T, S, threads, st);
    default: return launch_beta<16>(em, al, lz, va, sk, fi, ln, out, B, T, S, threads, st);
  }
}
