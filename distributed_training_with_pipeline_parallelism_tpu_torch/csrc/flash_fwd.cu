// Flash-attention forward for Hopper (sm_90a), CUDA cores, f32 statistics.
//
// Replaces two TPU kernels of the JAX package with one:
//   distributed_training_with_pipeline_parallelism_tpu/ops/pallas_attention.py
//     _flash_fwd_kernel         (K2: [b*h, s, dh] layout; causal, window,
//                                ragged true_len, dead-block skipping)
//     _flash_fwd_kernel_packed  (K4: head-packed [b, s, h*dh], causal,
//                                full length)
// Both read the same [b, s, h, dh] tensor in different layouts. This kernel
// reads q, k and v through the (batch, seq, head) element strides it is
// given, with a contiguous head_dim, so the packed route and the
// transposed route are both served without a host-side transpose.
//
// Bound on an H100 SXM: 4*b*h*dh*pairs FLOPs (pairs = s*(s+1)/2 causal, s*s
// full) against 989 TFLOP/s bf16 tensor cores / 67 TFLOP/s f32; bytes are
// q, k, v read once and o written once (4*b*s*h*dh*itemsize) plus the f32
// lse. At the GPT-2 prefill ([4, 512, 12, 64] causal bf16) the bytes
// (~12.6 MB, ~3.8 us at 3.35 TB/s) bound it just above the tensor-core
// FLOPs (~1.6 GFLOP, ~1.6 us). This first version does the arithmetic on
// the CUDA cores in f32 (FMA, 67 TFLOP/s peak, ~24 us for those FLOPs), so
// in practice the arithmetic limits it. wgmma/TMA is later work.
//
// Design: one CTA of 128 threads per (64-row q tile, head, batch). The q
// tile, then each 64-key K/V tile, is staged in shared memory as f32 with a
// padded row stride (dh + 1) so column reads are free of bank conflicts.
// Each thread owns a 4x8 block of the 64x64 score tile and a 4 x dh/8 block
// of the output accumulator. Online softmax in the exp2 domain (the
// softmax scale and log2(e) fold into the staged q), running max/sum and
// accumulator in f32, row reductions by warp shuffles over the 8 threads of
// a row group, the probability tile through shared memory for P.V.
// Causal tiles above the diagonal are never visited; a sliding window
// starts at its first live tile; keys at or past s (the ragged tail) are
// masked and their K/V rows staged as zeros. Masked scores are NEG_INF
// (finite), and a probability whose score is masked is forced to 0, which
// is the dead-row guard the window needs: a row whose first visited tile is
// entirely outside its window keeps l = 0 and acc = 0 instead of summing
// exp2(NEG_INF - NEG_INF) = 1 (pallas_attention.py:151-158).
// Outputs: o in the input dtype, and lse in the natural log ([b, h, s] f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;    // q rows per CTA
constexpr int BK = 64;    // keys per staged tile
constexpr int NT = 128;   // threads per CTA
constexpr int RM = 4;     // score rows per thread   (BQ / 16 row groups)
constexpr int CN = 8;     // score columns per thread (BK / 8 column lanes)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // element strides of a [b, s, h, dh] view; dh is contiguous
  long long b, s, h;
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (DH + 1) + 2 * BK * (DH + 1) + BQ * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s, int h, Strides qs, Strides ks,
                 Strides vs, Strides os, int causal, int window,
                 float scale_log2) {
  constexpr int LD = DH + 1;  // padded row stride of the staged tiles
  constexpr int LP = BK + 1;  // padded row stride of the probability tile
  constexpr int DC = DH / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;           // [BQ][LD]
  float* sk = sq + BQ * LD;   // [BK][LD]
  float* sv = sk + BK * LD;   // [BK][LD]
  float* sp = sv + BK * LD;   // [BQ][LP]

  const int tid = threadIdx.x;
  const int ty = tid / 8;  // row group: tile rows ty*RM .. ty*RM+RM-1
  const int tx = tid % 8;  // column lane: tile columns tx + 8*j
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const T* qb = q + bb * qs.b + hh * qs.h;
  const T* kb = k + bb * ks.b + hh * ks.h;
  const T* vb = v + bb * vs.b + hh * vs.h;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, c = i % DH, row = q0 + r;
    sq[r * LD + c] = row < s ? to_f(qb[row * qs.s + c]) * scale_log2 : 0.f;
  }

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (s + BK - 1) / BK;
  // causal: the last row of this tile sees keys up to q0 + BQ - 1
  const int kv_end = causal ? min(n_kv, (q0 + BQ - 1) / BK + 1) : n_kv;
  // window: the first row's oldest visible key is q0 - (window - 1)
  const int kv_start = window > 0 ? max(0, q0 - (window - 1)) / BK : 0;

  for (int kt = kv_start; kt < kv_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // sq is staged; the previous tile's readers are done
    for (int i = tid; i < BK * DH; i += NT) {
      const int r = i / DH, c = i % DH, col = k0 + r;
      const bool in = col < s;
      sk[r * LD + c] = in ? to_f(kb[col * ks.s + c]) : 0.f;
      sv[r * LD + c] = in ? to_f(vb[col * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = sq[(ty * RM + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = sk[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = k0 + tx + 8 * j;
        bool keep = col < s;
        if (causal) keep = keep && col <= row;
        if (window > 0) keep = keep && row - col < window;
        if (!keep) sc[i][j] = NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // while m is NEG_INF every earlier p was forced to 0, so l and acc
      // are 0 and the rescale below is harmless
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = sc[i][j] <= 0.5f * NEG_INF ? 0.f : exp2f(sc[i][j] - m_new);
        sp[(ty * RM + i) * LP + tx + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RM], vv[DC];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = sp[(ty * RM + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sv[kk * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= s) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    T* ob = o + bb * os.b + hh * os.h + row * os.s;
#pragma unroll
    for (int c = 0; c < DC; ++c) ob[tx + 8 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0) lse[((long long)bb * h + hh) * s + row] = (m[i] + log2f(lc)) * LN2;
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int b, int s, int h, Strides qs, Strides ks,
                   Strides vs, Strides os, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = LOG2E / sqrtf((float)DH);
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_fwd_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s, h, qs, ks, vs, os, causal,
      window, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v,
                        void* o, void* lse, int b, int s, int h, Strides qs,
                        Strides ks, Strides vs, Strides os, int causal,
                        int window, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, s, h, qs, ks, vs, os, causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, s, h, qs, ks, vs, os, causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, b, s, h, qs, ks, vs, os, causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. window <= 0
// means no window. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int dtype, int b, int s, int h, int dh,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         int causal, int window, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(dh, q, k, v, o, lse, b, s, h, qs, ks, vs, os, causal, window, st);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, lse, b, s, h, qs, ks, vs, os, causal,
                                     window, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
