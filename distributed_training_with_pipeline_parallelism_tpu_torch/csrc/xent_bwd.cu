// Fused softmax cross-entropy backward for Hopper (sm_90a):
//   grad[i, j] = (exp(x[i, j] - lse[i]) - [j == t[i]]) * g[i]
// written straight in the logits dtype, from the logits, the targets, the
// forward's saved lse (f32, natural log) and the incoming cotangent g (f32).
//
// Replaces the backward half of the fused op of
//   distributed_training_with_pipeline_parallelism_tpu/ops/pallas_xent.py
//     _xent_vjp_bwd (an XLA fusion on the TPU, paired with the Pallas
//     _xent_fwd_kernel, K1).
// The [N, V] f32 softmax is never written: each element is read once,
// turned into its gradient in registers and written once.
//
// Bound on an H100 SXM: bytes. The logits are read once and the gradient
// written once (2*N*V*itemsize), plus N*(8 + 4 + 4) bytes of targets, lse
// and g; about 4 operations per element are far below the card's ratio of
// operations to bytes. At the training head ([6144, 50257] bf16) that is
// ~1.24 GB, ~0.37 ms at 3.35 TB/s.
//
// Design: one block of 1024 threads per row; each thread walks the row
// with a stride of the block size, eight independent loads in flight per
// step, and writes each gradient once (no reduction, no shared memory).
// A row whose cotangent is 0 (an ignore-index pad row) is written as
// exact +0 without reading its logits. A target outside
// [0, V) matches no column, as the JAX one-hot does. Any N is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;  // threads per row
constexpr int U = 8;      // loads in flight per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
xent_bwd_kernel(const T* __restrict__ logits, long long row_stride,
                const long long* __restrict__ targets,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ grad, long long grad_row_stride, int vocab) {
  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const T* x = logits + row * row_stride;
  T* out = grad + row * grad_row_stride;
  const float gi = g[row];
  if (gi == 0.f) {  // pad row: exact zero gradient
    for (int i = tid; i < vocab; i += NT) out[i] = from_f<T>(0.f);
    return;
  }
  const float li = lse[row];
  const long long t = targets[row];
  for (int base = 0; base < vocab; base += NT * U) {
    float xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT + tid;
      xv[u] = i < vocab ? to_f(x[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * NT + tid;
      if (i < vocab) {
        const float p = expf(xv[u] - li);
        out[i] = from_f<T>((p - (i == t ? 1.f : 0.f)) * gi);
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. logits and grad rows are row_stride and
// grad_row_stride elements apart with a contiguous vocab dim; targets are
// int64, lse and g f32, all [n]. n >= 1. Returns cudaGetLastError() after
// the launch.
extern "C" int xent_bwd(const void* logits, const void* targets,
                        const void* lse, const void* g, void* grad, int dtype,
                        int n, int vocab, long long row_stride,
                        long long grad_row_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* tg = static_cast<const long long*>(targets);
  const float* ls = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  if (dtype == 0)
    xent_bwd_kernel<float><<<n, NT, 0, st>>>(
        static_cast<const float*>(logits), row_stride, tg, ls, gg,
        static_cast<float*>(grad), grad_row_stride, vocab);
  else if (dtype == 1)
    xent_bwd_kernel<__nv_bfloat16><<<n, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), row_stride, tg, ls, gg,
        static_cast<__nv_bfloat16*>(grad), grad_row_stride, vocab);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* xent_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
