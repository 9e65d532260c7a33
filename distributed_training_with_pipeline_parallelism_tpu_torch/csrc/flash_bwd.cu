// Flash-attention backward for Hopper (sm_90a), CUDA cores, f32 arithmetic.
//
// Replaces two TPU kernels of the JAX package with one entry point:
//   distributed_training_with_pipeline_parallelism_tpu/ops/pallas_attention.py
//     _flash_bwd_kernel         (K3: [b*h, s, dh] layout; causal, window,
//                                ragged true_len, dead-block pruning)
//     _flash_bwd_kernel_packed  (K5: head-packed [b, s, h*dh], causal,
//                                full length)
// As in flash_fwd.cu, q, k, v, o, do and the outputs are read and written
// through (batch, seq, head) element strides with a contiguous head_dim, so
// the packed and the transposed routes are one kernel with no host-side
// transpose. Inputs: q, k, v, the forward's output o and lse ([b, h, s]
// f32, natural log), and the cotangent do. Outputs: dq, dk, dv in the input
// dtype, each accumulated in f32 and cast once.
//
// The TPU grid is sequential: Pallas keeps one dq block resident and adds
// into it across the k-grid axis. Blocks on this card run in parallel, so
// that revisit does not carry over. Two kernels instead, no atomics, and a
// deterministic result:
//   1. dq kernel, one CTA per 64-row q tile: first the delta pre-pass,
//      delta_i = rowsum(do_i * o_i), for its own rows (written to a scratch
//      [b, h, s] f32 buffer), then a loop over the live k tiles that
//      recomputes p = exp(s - lse), dp = do.v^T, ds = p * (dp - delta) and
//      accumulates dq = scale * ds.k in registers.
//   2. dk/dv kernel, one CTA per 64-key tile: a loop over the live q tiles
//      that recomputes p and ds the same way (reading the delta the first
//      kernel wrote) and accumulates dv = p^T.do and dk = scale * ds^T.q.
// The recompute of p and dp in both kernels is the price of no atomics:
// 7 tile products per (q, k) tile pair against the one-sweep form's 5.
//
// Tiles: a CTA of 256 threads owns 64 rows (2 per thread row group of 8
// lanes) and steps over inner tiles of 64 rows (32 at head_dim 256, so the
// four f32 tiles fit in shared memory: 206 KB). Tiles are staged in shared
// memory as f32 with a padded row stride (dh + 1). Scores run in the exp2
// domain (scale * log2(e) folded into one multiply; lse * log2(e) staged).
// Masks: causal, a sliding window (causal only) and a ragged length, as in
// the forward; a masked element's p is forced to 0, and tiles wholly
// outside the causal band or the window are never visited, in both
// directions (the JAX pruning at pallas_attention.py:275-287).
//
// Bound on an H100 SXM: 10*b*h*dh*pairs FLOPs for the five products of
// the algorithm (pairs = live (q, k) pairs) against 989 TFLOP/s bf16 tensor
// cores / 67 TFLOP/s f32, and 8 [b, s, h, dh] tensors read or written once
// plus lse. At the training shape [6, 1024, 12, 64] causal bf16 the FLOPs
// (~24.2 GFLOP, ~24 us on the tensor cores) bound it just above the bytes
// (~75 MB, ~23 us). This first version runs its arithmetic on the CUDA
// cores in f32 (67 TFLOP/s FMA peak), so it is far slower; mma/wgmma tiles
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BO = 64;   // rows a CTA owns (q rows or keys)
constexpr int RM = 2;    // owned rows per thread
constexpr int NT = 256;  // threads per CTA: (BO / RM) row groups x 8 lanes
constexpr float LOG2E = 1.4426950408889634f;

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

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // [b, h, s], natural log
  float* delta;      // [b, h, s] scratch: written by the dq kernel
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int s, h, causal, window;
  float scale, scale_log2;
};

// the inner tile: 64 rows, 32 at head_dim 256 (shared memory)
template <int DH> constexpr int kInner = DH >= 256 ? 32 : 64;

template <int DH>
constexpr size_t smem_bytes() {
  constexpr int BI = kInner<DH>;
  return sizeof(float) *
         (size_t)((2 * BO + 2 * BI) * (DH + 1) + BO * (BI + 1) + 2 * BI);
}

__device__ __forceinline__ bool live(int row, int col, int s, int causal,
                                     int window) {
  bool keep = row < s && col < s;
  if (causal) keep = keep && col <= row;
  if (window > 0) keep = keep && row - col < window;
  return keep;
}

// stage rows r0 .. r0+n-1 of a [b, s, h, dh] tensor (fixed b, h) as f32,
// zero past s
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* base, long long ss,
                                      int r0, int n, int s) {
  constexpr int LD = DH + 1;
  for (int i = threadIdx.x; i < n * DH; i += NT) {
    const int r = i / DH, c = i % DH, row = r0 + r;
    dst[r * LD + c] = row < s ? to_f(base[row * ss + c]) : 0.f;
  }
}

// dq (and the delta pre-pass): one CTA per 64-row q tile of one (b, h)
template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(Args a) {
  constexpr int BI = kInner<DH>;
  constexpr int LD = DH + 1, LP = BI + 1;
  constexpr int CN = BI / 8, DC = DH / 8;
  extern __shared__ float smem[];
  float* sq = smem;            // [BO][LD]
  float* sdo = sq + BO * LD;   // [BO][LD]
  float* sk = sdo + BO * LD;   // [BI][LD]
  float* sv = sk + BI * LD;    // [BI][LD]
  float* sp = sv + BI * LD;    // [BO][LP]: ds

  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int q0 = blockIdx.x * BO, hh = blockIdx.y, bb = blockIdx.z;
  const int s = a.s;
  const T* qb = static_cast<const T*>(a.q) + bb * a.qs.b + hh * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + bb * a.ks.b + hh * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + bb * a.vs.b + hh * a.vs.h;
  const T* ob = static_cast<const T*>(a.o) + bb * a.os.b + hh * a.os.h;
  const T* dob = static_cast<const T*>(a.dout) + bb * a.dos.b + hh * a.dos.h;
  const long long rbase = ((long long)bb * a.h + hh) * s;  // lse/delta row 0

  stage<T, DH>(sq, qb, a.qs.s, q0, BO, s);
  stage<T, DH>(sdo, dob, a.dos.s, q0, BO, s);
  __syncthreads();

  float lse2[RM], delta[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i, row = q0 + r;
    float acc = 0.f;
    if (row < s) {
#pragma unroll
      for (int c = 0; c < DC; ++c)
        acc += sdo[r * LD + tx + 8 * c] * to_f(ob[row * a.os.s + tx + 8 * c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    delta[i] = acc;
    lse2[i] = row < s ? a.lse[rbase + row] * LOG2E : 0.f;
    if (tx == 0 && row < s) a.delta[rbase + row] = acc;
  }

  float dq[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  const int n_k = (s + BI - 1) / BI;
  // causal: the tile's last row sees keys up to q0 + BO - 1; window: its
  // first row's oldest visible key is q0 - (window - 1)
  const int kt_end = a.causal ? min(n_k, (q0 + BO - 1) / BI + 1) : n_k;
  const int kt_start = a.window > 0 ? max(0, q0 - (a.window - 1)) / BI : 0;

  for (int kt = kt_start; kt < kt_end; ++kt) {
    const int k0 = kt * BI;
    __syncthreads();  // the previous tile's readers of sk, sv, sp are done
    stage<T, DH>(sk, kb, a.ks.s, k0, BI, s);
    stage<T, DH>(sv, vb, a.vs.s, k0, BI, s);
    __syncthreads();

    float sc[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RM], gv[RM], kv[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = sq[(ty * RM + i) * LD + d];
        gv[i] = sdo[(ty * RM + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        kv[j] = sk[(tx + 8 * j) * LD + d];
        vv[j] = sv[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = k0 + tx + 8 * j;
        const float p = live(row, col, s, a.causal, a.window)
                            ? exp2f(sc[i][j] * a.scale_log2 - lse2[i]) : 0.f;
        sp[(ty * RM + i) * LP + tx + 8 * j] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BI; ++kk) {
      float dv_[RM], kv[DC];
#pragma unroll
      for (int i = 0; i < RM; ++i) dv_[i] = sp[(ty * RM + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sk[kk * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[i][c] = fmaf(dv_[i], kv[c], dq[i][c]);
    }
  }

  T* dqb = static_cast<T*>(a.dq) + bb * a.dqs.b + hh * a.dqs.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= s) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[row * a.dqs.s + tx + 8 * c] = from_f<T>(dq[i][c] * a.scale);
  }
}

// dk and dv: one CTA per 64-key tile of one (b, h); reads the delta the dq
// kernel wrote
template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(Args a) {
  constexpr int BI = kInner<DH>;
  constexpr int LD = DH + 1, LP = BI + 1;
  constexpr int CN = BI / 8, DC = DH / 8;
  extern __shared__ float smem[];
  float* sk = smem;            // [BO][LD]
  float* sv = sk + BO * LD;    // [BO][LD]
  float* sq = sv + BO * LD;    // [BI][LD]
  float* sdo = sq + BI * LD;   // [BI][LD]
  float* sp = sdo + BI * LD;   // [BO][LP]: p^T, then ds^T
  float* slse = sp + BO * LP;  // [BI], log2 domain
  float* sdelta = slse + BI;   // [BI]

  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int k0 = blockIdx.x * BO, hh = blockIdx.y, bb = blockIdx.z;
  const int s = a.s;
  const T* qb = static_cast<const T*>(a.q) + bb * a.qs.b + hh * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + bb * a.ks.b + hh * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + bb * a.vs.b + hh * a.vs.h;
  const T* dob = static_cast<const T*>(a.dout) + bb * a.dos.b + hh * a.dos.h;
  const long long rbase = ((long long)bb * a.h + hh) * s;

  stage<T, DH>(sk, kb, a.ks.s, k0, BO, s);
  stage<T, DH>(sv, vb, a.vs.s, k0, BO, s);

  float dk[RM][DC], dv[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_q = (s + BI - 1) / BI;
  // causal: only rows at or after the tile's first key see it; window: the
  // last row that sees its newest key is k0 + BO - 1 + window - 1
  const int qt_start = a.causal ? k0 / BI : 0;
  const int qt_end =
      a.window > 0 ? min(n_q, (k0 + BO - 1 + a.window - 1) / BI + 1) : n_q;

  for (int qt = qt_start; qt < qt_end; ++qt) {
    const int q0 = qt * BI;
    __syncthreads();  // sk/sv staged; the previous tile's readers are done
    stage<T, DH>(sq, qb, a.qs.s, q0, BI, s);
    stage<T, DH>(sdo, dob, a.dos.s, q0, BI, s);
    for (int r = tid; r < BI; r += NT) {
      const int row = q0 + r;
      slse[r] = row < s ? a.lse[rbase + row] * LOG2E : 0.f;
      sdelta[r] = row < s ? a.delta[rbase + row] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are this CTA's keys, columns the q rows
    float p[RM][CN], ds[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) p[i][j] = ds[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float kv[RM], vv[RM], qv[CN], gv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        kv[i] = sk[(ty * RM + i) * LD + d];
        vv[i] = sv[(ty * RM + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        qv[j] = sq[(tx + 8 * j) * LD + d];
        gv[j] = sdo[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          p[i][j] = fmaf(kv[i], qv[j], p[i][j]);    // s^T
          ds[i][j] = fmaf(vv[i], gv[j], ds[i][j]);  // dp^T
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int col = k0 + ty * RM + i;  // the key
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int r = tx + 8 * j, row = q0 + r;
        const float pij = live(row, col, s, a.causal, a.window)
                              ? exp2f(p[i][j] * a.scale_log2 - slse[r]) : 0.f;
        ds[i][j] = pij * (ds[i][j] - sdelta[r]);
        p[i][j] = pij;
        sp[(ty * RM + i) * LP + r] = pij;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BI; ++qq) {
      float pv[RM], gv[DC];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = sp[(ty * RM + i) * LP + qq];
#pragma unroll
      for (int c = 0; c < DC; ++c) gv[c] = sdo[qq * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dv[i][c] = fmaf(pv[i], gv[c], dv[i][c]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sp[(ty * RM + i) * LP + tx + 8 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < BI; ++qq) {
      float dsv[RM], qv[DC];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsv[i] = sp[(ty * RM + i) * LP + qq];
#pragma unroll
      for (int c = 0; c < DC; ++c) qv[c] = sq[qq * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
    }
  }

  T* dkb = static_cast<T*>(a.dk) + bb * a.dks.b + hh * a.dks.h;
  T* dvb = static_cast<T*>(a.dv) + bb * a.dvs.b + hh * a.dvs.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = k0 + ty * RM + i;
    if (key >= s) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[key * a.dks.s + tx + 8 * c] = from_f<T>(dk[i][c] * a.scale);
      dvb[key * a.dvs.s + tx + 8 * c] = from_f<T>(dv[i][c]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + BO - 1) / BO, a.h, b);
  flash_bwd_dq_kernel<T, DH><<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, DH><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(int dh, const Args& a, int b, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(a, b, stream);
    case 128:
      return launch<T, 128>(a, b, stream);
    case 256:
      return launch<T, 256>(a, b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 24 element strides, the
// (batch, seq, head) strides of q, k, v, o, do, dq, dk, dv in that order.
// lse is [b, h, s] f32 (natural log); delta is a [b, h, s] f32 scratch
// buffer. window <= 0 means no window. Returns cudaGetLastError() after
// the launches.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int dtype,
                         int b, int s, int h, int dh,
                         const long long* strides, int causal, int window,
                         void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  Strides* st[8] = {&a.qs, &a.ks, &a.vs, &a.os, &a.dos, &a.dqs, &a.dks, &a.dvs};
  for (int i = 0; i < 8; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1],
                                               strides[3 * i + 2]};
  a.s = s; a.h = h; a.causal = causal; a.window = window;
  a.scale = 1.f / sqrtf((float)dh);
  a.scale_log2 = a.scale * LOG2E;
  const cudaStream_t stm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(dh, a, b, stm);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(dh, a, b, stm);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
