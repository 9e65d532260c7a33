// Flash-attention backward for Hopper (sm_90a): bf16 on the tensor cores,
// f32 on the CUDA cores.
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
// deterministic result (repeated runs give identical bits):
//   1. dq kernel, one CTA per 64-row q tile: first the delta pre-pass,
//      delta_i = rowsum(do_i * o_i), for its own rows (written to a scratch
//      [b, h, s] f32 buffer), then a loop over the live k tiles that
//      recomputes p = exp(s - lse), dp = do.v^T, ds = p * (dp - delta) and
//      accumulates dq = scale * ds.k.
//   2. dk/dv kernel, one CTA per 64-key tile: a loop over the live q tiles
//      that recomputes p and ds the same way (reading the delta the first
//      kernel wrote; it runs after it on the same stream) and accumulates
//      dv = p^T.do and dk = scale * ds^T.q.
// The recompute of p and dp in both kernels is the price of no atomics:
// 7 tile products per (q, k) tile pair against the one-sweep form's 5.
// Masks: causal, a sliding window (causal only) and a ragged length, as in
// the forward; a masked element's p is forced to 0, and tiles wholly
// outside the causal band or the window are never visited, in both
// directions (the JAX pruning at pallas_attention.py:275-287).
//
// Bound on an H100 SXM: 10*b*h*dh*pairs FLOPs for the five products of
// the algorithm (pairs = live (q, k) pairs) against 989 TFLOP/s of bf16
// tensor cores, and 8 [b, s, h, dh] tensors read or written once plus lse.
// At the training shape [6, 1024, 12, 64] causal bf16 the FLOPs
// (~24.2 GFLOP, ~24 us) bound it just above the bytes (~75 MB, ~23 us).
// The two-kernel form does 7/5 of those FLOPs, so ~34 us is its own floor.
//
// bf16 design (flash_bwd_dq_tc, flash_bwd_dkdv_tc): every one of the seven
// tile products is an mma.sync m16n8k16 (bf16 in, f32 accumulate), and its
// operands are bf16 rows in shared memory padded by 8 elements, copied by
// cp.async (16 bytes a thread; rows at or past s zero-filled by the copy),
// with the inner tile in a two-stage ring so that the next tile's copy is
// in flight during this tile's products. A CTA is 4 warps; each warp owns
// 16 of the CTA's 64 rows and walks the inner tile 16 rows at a time, so
// one 16x16 score block is live at once: p = exp2(s - lse2) needs no row
// max in the backward, and a 16-deep step of the output product consumes
// each block as soon as it is made, from registers (the C-to-A fragment
// reuse of tc_bf16.cuh). The arithmetic is the JAX kernel's: q scaled by
// scale*log2(e) and rounded to bf16 for the scores (pallas_attention.py
// :521), p rounded to bf16 for p^T.do, ds rounded to bf16 for ds.k and
// ds^T.q (:538), every product accumulated in f32, dq and dk scaled once
// at the end.
//   - dq kernel: the q tile (scaled in place) and do stay in shared memory
//     (and, at head_dim 64, in registers as A fragments); per 16 keys it
//     forms S = q.k^T and dP = do.v^T, then dS, then dQ += dS.k with k read
//     by ldmatrix.trans. The delta pre-pass reads do from shared memory and
//     o from device memory, four lanes a row.
//   - dk/dv kernel: the k and v tiles stay; per 16 q rows it forms the
//     transposed scores S^T = k.qc^T and dP^T = v.do^T, so that p^T and
//     dS^T come out with keys as rows and feed dV += p^T.do and
//     dK += dS^T.q from registers. Each q tile lands in shared memory as
//     stored and is copied once, scaled, for the scores; its lse and delta
//     are staged beside it.
//   - head_dim 128 and 256 take a 32-row inner tile; at 256 a CTA owns a
//     quarter of the output columns (four CTAs per row tile, each
//     recomputing the scores), so the f32 accumulators fit in registers
//     without spilling.
//   - Under causal, both kernels launch their heaviest row tiles first.
// f32 design (flash_bwd_dq_kernel, flash_bwd_dkdv_kernel, the first version
// of this file, kept as it was): the same two kernels on the CUDA cores in
// f32 FMA, tiles staged as f32 with a (dh + 1) padded stride, 256 threads
// owning 64 rows. It is the exact gate of the port (tf32 would not hold
// its 1e-4 bounds) and no timed path runs in f32. The entry point
// dispatches on the dtype; neither path falls back to the other.
//
// Resources of the bf16 kernels (ptxas, sm_90a, nvcc 12.9; chip_smoke.py
// prints them at every build and fails on a spill), at head_dim 64 / 128 /
// 256: dq 125 / 124 / 152 registers and 55,296 / 69,632 / 135,168 bytes
// of shared memory a CTA; dk/dv 167 / 241 / 168 registers and 65,024 /
// 78,592 / 152,320 bytes; no spills (dynamic shared memory, above 48 KB
// by cudaFuncSetAttribute). At head_dim 64 that is three or four CTAs on
// an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "tc_bf16.cuh"

namespace {

constexpr int BO = 64;   // rows a CTA owns (q rows or keys)
constexpr int RM = 2;    // owned rows per thread
constexpr int NT = 256;  // threads per CTA: (BO / RM) row groups x 8 lanes
constexpr float LOG2E = 1.4426950408889634f;

// the f32 kernels are templates of their element type, instantiated for
// float only (bf16 takes the tensor-core kernels)
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

using tc::Strides;

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // [b, h, s], natural log
  float* delta;      // [b, h, s] scratch: written by the dq kernel
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int s, h, causal, window;
  float scale, scale_log2;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using tc::bf16;

template <int DH>
struct TcBwd {
  static constexpr int BO = 64;                   // rows a CTA owns, 16 a warp
  static constexpr int NT = 128;                  // 4 warps
  static constexpr int BI = DH >= 128 ? 32 : 64;  // rows of the inner tile
  static constexpr int DO = DH > 128 ? 64 : DH;  // output columns of a CTA
  static constexpr int NSPLIT = DH / DO;          // CTAs per row tile
  static constexpr bool AREG = DH <= 64;          // own A fragments in registers
  static constexpr int LD = DH + tc::PAD;         // shared row stride
  // dq: q (scaled in place), do, two stages of (k, v)
  static constexpr size_t smem_dq = sizeof(bf16) * (size_t)(2 * BO + 4 * BI) * LD;
  // dk/dv: k, v, two stages of (q, do), the scaled q, lse and delta
  static constexpr size_t smem_dkdv =
      sizeof(bf16) * (size_t)(2 * BO + 5 * BI) * LD + 2 * BI * sizeof(float);
};

template <int DH>
__global__ void __launch_bounds__(128) flash_bwd_dq_tc(Args a) {
  using C = TcBwd<DH>;
  constexpr int BO = C::BO, BI = C::BI, NT = C::NT, LD = C::LD;
  constexpr int KD = DH / 16;   // 16-deep steps over head_dim
  constexpr int NO = C::DO / 8; // 8-wide output tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BO][LD], scaled
  bf16* sdo = sq + BO * LD;                      // [BO][LD]
  bf16* skv = sdo + BO * LD;  // stage i: k at skv + 2i BI LD, v BI LD after

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s = a.s;
  const int n_t = (s + BO - 1) / BO;
  const int q0 = (a.causal ? n_t - 1 - (int)blockIdx.z : (int)blockIdx.z) * BO;
  const int hh = blockIdx.x / C::NSPLIT, d0 = (blockIdx.x % C::NSPLIT) * C::DO;
  const int bb = blockIdx.y;
  const bf16* qb = static_cast<const bf16*>(a.q) + bb * a.qs.b + hh * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + bb * a.ks.b + hh * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + bb * a.vs.b + hh * a.vs.h;
  const bf16* ob = static_cast<const bf16*>(a.o) + bb * a.os.b + hh * a.os.h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + bb * a.dos.b + hh * a.dos.h;
  const long long rbase = ((long long)bb * a.h + hh) * s;  // lse/delta row 0

  const int n_k = (s + BI - 1) / BI;
  // causal: the tile's last row sees keys up to q0 + BO - 1; window: its
  // first row's oldest visible key is q0 - (window - 1)
  const int kt_end = a.causal ? min(n_k, (q0 + BO - 1) / BI + 1) : n_k;
  const int kt_start = a.window > 0 ? max(0, q0 - (a.window - 1)) / BI : 0;

  tc::load_rows<BO, DH, NT>(sq, qb, a.qs.s, q0, s);
  tc::load_rows<BO, DH, NT>(sdo, dob, a.dos.s, q0, s);
  tc::cp_async_commit();
  tc::load_rows<BI, DH, NT>(skv, kb, a.ks.s, kt_start * BI, s);
  tc::load_rows<BI, DH, NT>(skv + BI * LD, vb, a.vs.s, kt_start * BI, s);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();  // q and do have landed
  __syncthreads();
  tc::scale_rows<BO, DH, NT>(sq, sq, a.scale_log2);

  // this thread's rows are row0 (fragment entries 0, 1) and row0 + 8 (2, 3)
  const int row0 = q0 + warp * 16 + g;
  // delta = rowsum(do * o): the four lanes of a quad split a row
  float delta[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + g + 8 * r, row = q0 + lr;
    float acc = 0.f;
    if (row < s) {
#pragma unroll
      for (int c = 0; c < DH / 32; ++c) {
        const int col = t * (DH / 4) + c * 8;
        uint4 x = *reinterpret_cast<const uint4*>(sdo + lr * LD + col);
        uint4 y = *reinterpret_cast<const uint4*>(ob + row * a.os.s + col);
        const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xf = __bfloat1622float2(xp[j]), yf = __bfloat1622float2(yp[j]);
          acc = fmaf(xf.x, yf.x, acc);
          acc = fmaf(xf.y, yf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta[r] = acc;
    lse2[r] = row < s ? a.lse[rbase + row] * LOG2E : 0.f;
    if (t == 0 && row < s && d0 == 0) a.delta[rbase + row] = acc;
  }
  __syncthreads();  // the scaled q is visible

  const bf16* sqw = sq + warp * 16 * LD;
  const bf16* sdow = sdo + warp * 16 * LD;
  uint32_t qf[C::AREG ? KD : 1][4], gf[C::AREG ? KD : 1][4];
  if constexpr (C::AREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      tc::ldsm_x4(qf[kd], sqw + tc::a_off(lane, LD) + kd * 16);
      tc::ldsm_x4(gf[kd], sdow + tc::a_off(lane, LD) + kd * 16);
    }
  }
  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = kt_start; kt < kt_end; ++kt) {
    const int st = (kt - kt_start) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile kt is visible; stage st ^ 1 has no readers
    if (kt + 1 < kt_end) {
      bf16* nx = skv + (st ^ 1) * 2 * BI * LD;
      tc::load_rows<BI, DH, NT>(nx, kb, a.ks.s, (kt + 1) * BI, s);
      tc::load_rows<BI, DH, NT>(nx + BI * LD, vb, a.vs.s, (kt + 1) * BI, s);
      tc::cp_async_commit();
    }
    const bf16* sk = skv + st * 2 * BI * LD;
    const bf16* sv = sk + BI * LD;
    const int k0 = kt * BI;
    const bool masked = q0 + BO > s || k0 + BI > s ||
                        (a.causal && k0 + BI - 1 > q0) ||
                        (a.window > 0 && q0 + BO - 1 - k0 >= a.window);
#pragma unroll 1  // unrolled, the chunks' loads crowd the registers
    for (int kc = 0; kc < BI / 16; ++kc) {  // 16 keys at a time
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t aq[4], ag[4], b[4];
        if constexpr (C::AREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            aq[i] = qf[kd][i];
            ag[i] = gf[kd][i];
          }
        } else {
          tc::ldsm_x4(aq, sqw + tc::a_off(lane, LD) + kd * 16);
          tc::ldsm_x4(ag, sdow + tc::a_off(lane, LD) + kd * 16);
        }
        tc::ldsm_x4(b, sk + kc * 16 * LD + tc::b_off(lane, LD) + kd * 16);
        tc::mma(sc[0], aq, b[0], b[1]);
        tc::mma(sc[1], aq, b[2], b[3]);
        tc::ldsm_x4(b, sv + kc * 16 * LD + tc::b_off(lane, LD) + kd * 16);
        tc::mma(dp[0], ag, b[0], b[1]);
        tc::mma(dp[1], ag, b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = tc::ex2(sc[n][e] - lse2[r]);
          if (masked && !live(row0 + 8 * r, k0 + kc * 16 + n * 8 + 2 * t + (e & 1),
                              s, a.causal, a.window))
            p = 0.f;
          sc[n][e] = p * (dp[n][e] - delta[r]);  // ds
        }
      uint32_t ads[4];
      tc::c_to_a(ads, sc[0], sc[1]);  // ds, rounded to bf16
#pragma unroll
      for (int dn = 0; dn < C::DO / 16; ++dn) {
        uint32_t b[4];
        tc::ldsm_x4_t(b, sk + kc * 16 * LD + tc::bt_off(lane, LD) + d0 + dn * 16);
        tc::mma(dq[2 * dn], ads, b[0], b[1]);
        tc::mma(dq[2 * dn + 1], ads, b[2], b[3]);
      }
    }
  }

  bf16* dqb = static_cast<bf16*>(a.dq) + bb * a.dqs.b + hh * a.dqs.h + d0 + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dqb + row * a.dqs.s + n * 8) =
          tc::pack(dq[n][2 * r] * a.scale, dq[n][2 * r + 1] * a.scale);
  }
}

template <int DH>
__global__ void __launch_bounds__(128) flash_bwd_dkdv_tc(Args a) {
  using C = TcBwd<DH>;
  constexpr int BO = C::BO, BI = C::BI, NT = C::NT, LD = C::LD;
  constexpr int KD = DH / 16;
  constexpr int NO = C::DO / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [BO][LD]
  bf16* sv = sk + BO * LD;                       // [BO][LD]
  bf16* sqg = sv + BO * LD;  // stage i: q at sqg + 2i BI LD, do BI LD after
  bf16* sqc = sqg + 4 * BI * LD;  // [BI][LD]: the stage's q, scaled
  float* slse = reinterpret_cast<float*>(sqc + BI * LD);  // [BI], log2
  float* sdelta = slse + BI;                               // [BI]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s = a.s;
  const int k0 = blockIdx.z * BO;  // under causal the first tiles are heaviest
  const int hh = blockIdx.x / C::NSPLIT, d0 = (blockIdx.x % C::NSPLIT) * C::DO;
  const int bb = blockIdx.y;
  const bf16* qb = static_cast<const bf16*>(a.q) + bb * a.qs.b + hh * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + bb * a.ks.b + hh * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + bb * a.vs.b + hh * a.vs.h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + bb * a.dos.b + hh * a.dos.h;
  const long long rbase = ((long long)bb * a.h + hh) * s;

  const int n_q = (s + BI - 1) / BI;
  // causal: only rows at or after the tile's first key see it; window: the
  // last row that sees its newest key is k0 + BO - 1 + window - 1
  const int qt_start = a.causal ? k0 / BI : 0;
  const int qt_end =
      a.window > 0 ? min(n_q, (k0 + BO - 1 + a.window - 1) / BI + 1) : n_q;

  tc::load_rows<BO, DH, NT>(sk, kb, a.ks.s, k0, s);
  tc::load_rows<BO, DH, NT>(sv, vb, a.vs.s, k0, s);
  tc::load_rows<BI, DH, NT>(sqg, qb, a.qs.s, qt_start * BI, s);
  tc::load_rows<BI, DH, NT>(sqg + BI * LD, dob, a.dos.s, qt_start * BI, s);
  tc::cp_async_commit();

  // this thread's keys are key0 (fragment entries 0, 1) and key0 + 8 (2, 3)
  const int key0 = k0 + warp * 16 + g;
  const bf16* skw = sk + warp * 16 * LD;
  const bf16* svw = sv + warp * 16 * LD;
  uint32_t kf[C::AREG ? KD : 1][4], vf[C::AREG ? KD : 1][4];
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int qt = qt_start; qt < qt_end; ++qt) {
    const int st = (qt - qt_start) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile qt is visible; stage st ^ 1 and sqc have no readers
    if (qt + 1 < qt_end) {
      bf16* nx = sqg + (st ^ 1) * 2 * BI * LD;
      tc::load_rows<BI, DH, NT>(nx, qb, a.qs.s, (qt + 1) * BI, s);
      tc::load_rows<BI, DH, NT>(nx + BI * LD, dob, a.dos.s, (qt + 1) * BI, s);
      tc::cp_async_commit();
    }
    if constexpr (C::AREG) {
      if (qt == qt_start) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          tc::ldsm_x4(kf[kd], skw + tc::a_off(lane, LD) + kd * 16);
          tc::ldsm_x4(vf[kd], svw + tc::a_off(lane, LD) + kd * 16);
        }
      }
    }
    const bf16* sq = sqg + st * 2 * BI * LD;
    const bf16* sdo = sq + BI * LD;
    const int q0 = qt * BI;
    tc::scale_rows<BI, DH, NT>(sqc, sq, a.scale_log2);
    for (int r = threadIdx.x; r < BI; r += NT) {
      const int row = q0 + r;
      slse[r] = row < s ? a.lse[rbase + row] * LOG2E : 0.f;
      sdelta[r] = row < s ? a.delta[rbase + row] : 0.f;
    }
    __syncthreads();
    const bool masked = k0 + BO > s || q0 + BI > s ||
                        (a.causal && q0 < k0 + BO - 1) ||
                        (a.window > 0 && q0 + BI - 1 - k0 >= a.window);
#pragma unroll 1  // unrolled, the chunks' loads crowd the registers
    for (int qc = 0; qc < BI / 16; ++qc) {  // 16 q rows at a time
      float pt[2][4] = {}, dpt[2][4] = {};
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ak[4], av[4], b[4];
        if constexpr (C::AREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[kd][i];
            av[i] = vf[kd][i];
          }
        } else {
          tc::ldsm_x4(ak, skw + tc::a_off(lane, LD) + kd * 16);
          tc::ldsm_x4(av, svw + tc::a_off(lane, LD) + kd * 16);
        }
        tc::ldsm_x4(b, sqc + qc * 16 * LD + tc::b_off(lane, LD) + kd * 16);
        tc::mma(pt[0], ak, b[0], b[1]);
        tc::mma(pt[1], ak, b[2], b[3]);
        tc::ldsm_x4(b, sdo + qc * 16 * LD + tc::b_off(lane, LD) + kd * 16);
        tc::mma(dpt[0], av, b[0], b[1]);
        tc::mma(dpt[1], av, b[2], b[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = qc * 16 + n * 8 + 2 * t + (e & 1);  // q row in the tile
          float p = tc::ex2(pt[n][e] - slse[c]);
          if (masked && !live(q0 + c, key0 + 8 * (e >> 1), s, a.causal, a.window))
            p = 0.f;
          pt[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sdelta[c]);  // ds^T
        }
      uint32_t ap[4], ads[4];
      tc::c_to_a(ap, pt[0], pt[1]);    // p^T, rounded to bf16
      tc::c_to_a(ads, dpt[0], dpt[1]); // ds^T, rounded to bf16
#pragma unroll
      for (int dn = 0; dn < C::DO / 16; ++dn) {
        uint32_t b[4];
        tc::ldsm_x4_t(b, sdo + qc * 16 * LD + tc::bt_off(lane, LD) + d0 + dn * 16);
        tc::mma(dv[2 * dn], ap, b[0], b[1]);
        tc::mma(dv[2 * dn + 1], ap, b[2], b[3]);
        tc::ldsm_x4_t(b, sq + qc * 16 * LD + tc::bt_off(lane, LD) + d0 + dn * 16);
        tc::mma(dk[2 * dn], ads, b[0], b[1]);
        tc::mma(dk[2 * dn + 1], ads, b[2], b[3]);
      }
    }
  }

  bf16* dkb = static_cast<bf16*>(a.dk) + bb * a.dks.b + hh * a.dks.h + d0 + 2 * t;
  bf16* dvb = static_cast<bf16*>(a.dv) + bb * a.dvs.b + hh * a.dvs.h + d0 + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= s) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dkb + key * a.dks.s + n * 8) =
          tc::pack(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvb + key * a.dvs.s + n * 8) =
          tc::pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int DH>
cudaError_t launch_tc(const Args& a, int b, cudaStream_t stream) {
  using C = TcBwd<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::smem_dkdv);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.h * C::NSPLIT, b, (a.s + C::BO - 1) / C::BO);
  flash_bwd_dq_tc<DH><<<grid, C::NT, C::smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_tc<DH><<<grid, C::NT, C::smem_dkdv, stream>>>(a);
  return cudaGetLastError();
}

template <bool TC>
cudaError_t dispatch_dh(int dh, const Args& a, int b, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return TC ? launch_tc<64>(a, b, stream) : launch<float, 64>(a, b, stream);
    case 128:
      return TC ? launch_tc<128>(a, b, stream) : launch<float, 128>(a, b, stream);
    case 256:
      return TC ? launch_tc<256>(a, b, stream) : launch<float, 256>(a, b, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// the tensor-core kernels' alignment rule (tc_bf16.cuh) over all eight views
bool aligned16(const Args& a, int b) {
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  const Strides st[8] = {a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs};
  return tc::aligned16(ptrs, st, 8, b, a.s, a.h);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; 16-byte
// aligned pointers and strides a multiple of 8 elements). strides: 24
// element strides, the (batch, seq, head) strides of q, k, v, o, do, dq,
// dk, dv in that order. lse is [b, h, s] f32 (natural log); delta is a
// [b, h, s] f32 scratch buffer. window <= 0 means no window. Returns
// cudaGetLastError() after the launches.
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
  const cudaStream_t stm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    a.scale = 1.f / sqrtf((float)dh);
    a.scale_log2 = a.scale * LOG2E;
    err = dispatch_dh<false>(dh, a, b, stm);
  } else if (dtype == 1) {
    // scale and scale * log2(e) as the JAX kernel forms them: in double,
    // then one rounding each
    a.scale = (float)(1.0 / sqrt((double)dh));
    a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)dh));
    err = aligned16(a, b) ? dispatch_dh<true>(dh, a, b, stm) : cudaErrorInvalidValue;
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
