// Fused softmax cross-entropy forward for Hopper (sm_90a): per-row
// logsumexp and target logit over [N, V] logits -> nll, lse (f32).
//
// Replaces the TPU kernel
//   distributed_training_with_pipeline_parallelism_tpu/ops/pallas_xent.py
//     _xent_fwd_kernel (K1), called through _xent_fwd_pallas.
// The JAX package falls back to XLA when its row tiling degenerates
// (_pick_block_n == 1, e.g. an odd N); that is a TPU tiling limit and is
// not ported: this kernel takes any N.
//
// Bound on an H100 SXM: bytes. The logits are read once (N*V*itemsize),
// targets read and nll/lse written (N*16 bytes); about 4 operations per
// logit are far below the card's ratio of operations to bytes. At the
// decode head ([4, 50257] bf16) that is ~0.4 MB, ~0.12 us at 3.35 TB/s,
// well under one launch's overhead.
//
// Design: one block of 1024 threads per row. Each thread walks the row
// with a stride of the block size, eight independent loads in flight per
// step (so one SM keeps enough bytes in flight even when N is small), and
// keeps an online (max, sum of exp) pair; the tail past V is masked by
// the index test. The pairs merge by warp shuffles and then across the 32
// warps through shared memory. The target logit is one gather by thread 0;
// a target outside [0, V) contributes 0, as the JAX kernel's one-hot sum
// does. Nothing of [N, V] is written back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;  // threads per row
constexpr int U = 8;      // loads in flight per thread
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// merge two online-softmax partials (m, s) into (m, s)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * exp2f((m - mn) * LOG2E) + s2 * exp2f((m2 - mn) * LOG2E);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(NT)
xent_fwd_kernel(const T* __restrict__ logits, long long row_stride,
                const long long* __restrict__ targets, float* __restrict__ nll,
                float* __restrict__ lse, int vocab) {
  __shared__ float wm[NT / 32], ws[NT / 32];
  const int tid = threadIdx.x;
  const T* x = logits + blockIdx.x * row_stride;

  float m = NEG_INF, s = 0.f;
  for (int base = 0; base < vocab; base += NT * U) {
    float xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT + tid;
      xv[u] = i < vocab ? to_f(x[i]) : NEG_INF;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * NT + tid >= vocab) break;  // masked tail
      if (xv[u] > m) {
        s = s * exp2f((m - xv[u]) * LOG2E) + 1.f;
        m = xv[u];
      } else {
        s += exp2f((xv[u] - m) * LOG2E);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if (tid % 32 == 0) {
    wm[tid / 32] = m;
    ws[tid / 32] = s;
  }
  __syncthreads();
  if (tid < 32) {
    m = wm[tid];
    s = ws[tid];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      merge(m, s, m2, s2);
    }
    if (tid == 0) {
      const float row_lse = m + logf(s);
      const long long t = targets[blockIdx.x];
      const float tl = (t >= 0 && t < vocab) ? to_f(x[t]) : 0.f;
      lse[blockIdx.x] = row_lse;
      nll[blockIdx.x] = row_lse - tl;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. logits rows are row_stride elements
// apart with a contiguous vocab dim; targets are int64. n >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int xent_fwd(const void* logits, const void* targets, void* nll,
                        void* lse, int dtype, int n, int vocab,
                        long long row_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* tg = static_cast<const long long*>(targets);
  float* nl = static_cast<float*>(nll);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    xent_fwd_kernel<float><<<n, NT, 0, st>>>(static_cast<const float*>(logits),
                                             row_stride, tg, nl, ls, vocab);
  else if (dtype == 1)
    xent_fwd_kernel<__nv_bfloat16><<<n, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), row_stride, tg, nl, ls, vocab);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xent_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
