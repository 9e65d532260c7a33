// Flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// f32 on the CUDA cores.
//
// Replaces two TPU kernels of the JAX package with one entry point:
//   distributed_training_with_pipeline_parallelism_tpu/ops/pallas_attention.py
//     _flash_fwd_kernel         (K2: [b*h, s, dh] layout; causal, window,
//                                ragged true_len, dead-block skipping)
//     _flash_fwd_kernel_packed  (K4: head-packed [b, s, h*dh], causal,
//                                full length)
// Both read the same [b, s, h, dh] tensor in different layouts. These
// kernels read q, k and v through the (batch, seq, head) element strides
// they are given, with a contiguous head_dim, so the packed route and the
// transposed route are both served without a host-side transpose.
// Outputs: o in the input dtype, and lse in the natural log ([b, h, s] f32).
//
// Bound on an H100 SXM: 4*b*h*dh*pairs FLOPs (pairs = s*(s+1)/2 causal, s*s
// full) against 989 TFLOP/s of bf16 tensor cores; bytes are q, k, v read
// once and o written once (4*b*s*h*dh*itemsize) plus the f32 lse. At the
// training shape ([6, 1024, 12, 64] causal bf16) the bytes (~37.9 MB,
// ~11.3 us at 3.35 TB/s) bound it above the FLOPs (~9.7 GFLOP, ~9.8 us);
// at the GPT-2 prefill ([4, 512, 12, 64]) ~3.8 us of bytes against ~1.6 us
// of FLOPs. Either way a kernel that keeps the tensor cores fed and reads
// each k/v tile once per 64 q rows sits near both.
//
// bf16 design (flash_fwd_tc): one CTA of 4 warps per (64-row q tile, head,
// batch); each warp owns 16 q rows. The q tile and a two-stage ring of
// 64-key K/V tiles (32 at head_dim 256) are copied into shared memory by
// cp.async, 16 bytes a thread, as bf16 rows padded by 8 elements (the
// layout tc_bf16.cuh describes: free of bank conflicts for ldmatrix); the
// next tile's copy is in flight while this tile's products run, and a key
// row at or past s is zero-filled by the copy itself. q is scaled by
// scale*log2(e) in f32 and rounded to bf16 once (pallas_attention.py:132),
// and held as mma A fragments in registers (read again from shared memory
// at head_dim 256, to leave registers to the accumulator). Per tile,
// S = q.k^T runs on mma.sync m16n8k16 (bf16 in, f32 out); the online
// softmax runs on the accumulator fragments in the exp2 domain, row max
// and row sum over the quad of lanes that share a row; p is rounded to bf16
// straight into A fragments (pallas_attention.py:185) and O += p.v runs on
// mma with v read by ldmatrix.trans. The row sum l adds the f32 p, as the
// TPU kernel does. Causal tiles above the diagonal and tiles before the
// window's start are never visited; only tiles that straddle the diagonal,
// the window's edge or the ragged tail pay the mask, and there a masked
// score's probability is forced to 0 - the dead-row guard the window needs:
// a row whose first visited tile lies wholly outside its window keeps l = 0
// and acc = 0 instead of summing exp2(NEG_INF - NEG_INF) = 1
// (pallas_attention.py:151-158). Under causal the q tiles launch heaviest
// first (the grid's slowest axis walks the tiles in reverse), so the
// triangle's long rows do not trail in the last wave.
//
// f32 design (flash_fwd_kernel, the first version of this file, kept as it
// was): the CUDA cores in f32 FMA, tiles staged as f32 with a (dh + 1)
// padded stride, each thread a 4x8 block of the score tile, probabilities
// through shared memory. It is the exact gate of the port (tf32 would not
// hold its 1e-5 bounds) and no timed path runs in f32. The entry point
// dispatches on the dtype; neither path falls back to the other.
//
// Resources of the bf16 kernel (ptxas, sm_90a, nvcc 12.9; chip_smoke.py
// prints them at every build and fails on a spill): 128 / 240 / 253
// registers at head_dim 64 / 128 / 256, no spills; shared memory 46,080 /
// 87,040 / 101,376 bytes a CTA (dynamic, above 48 KB by
// cudaFuncSetAttribute). At head_dim 64 that is four CTAs (16 warps) on
// an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include "tc_bf16.cuh"

namespace {

constexpr int BQ = 64;    // q rows per CTA
constexpr int BK = 64;    // keys per staged tile
constexpr int NT = 128;   // threads per CTA
constexpr int RM = 4;     // score rows per thread   (BQ / 16 row groups)
constexpr int CN = 8;     // score columns per thread (BK / 8 column lanes)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the f32 kernels are templates of their element type, instantiated for
// float only (bf16 takes the tensor-core kernels)
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

using tc::Strides;

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using tc::bf16;

template <int DH>
struct TcFwd {
  static constexpr int BQ = 64;                   // q rows per CTA, 16 a warp
  static constexpr int NT = 128;                  // 4 warps
  static constexpr int BK = DH >= 256 ? 32 : 64;  // keys per staged tile
  static constexpr bool QREG = DH <= 128;         // q fragments in registers
  static constexpr int LD = DH + tc::PAD;         // shared row stride
  // q, then two stages of (k, v)
  static constexpr size_t smem = sizeof(bf16) * (size_t)(BQ + 4 * BK) * LD;
};

template <int DH>
__global__ void __launch_bounds__(128)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ lse, int s, int h, Strides qs, Strides ks,
             Strides vs, Strides os, int causal, int window,
             float scale_log2) {
  using C = TcFwd<DH>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT, LD = C::LD;
  constexpr int KD = DH / 16;  // 16-deep steps over head_dim
  constexpr int NS = BK / 8;   // 8-wide score tiles of a warp
  constexpr int NO = DH / 8;   // 8-wide output tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* skv = sq + BQ * LD;  // stage i: k at skv + 2i BK LD, v BK LD after

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (s + BQ - 1) / BQ;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * BQ, hh = blockIdx.x, bb = blockIdx.y;
  const bf16* qb = q + bb * qs.b + hh * qs.h;
  const bf16* kb = k + bb * ks.b + hh * ks.h;
  const bf16* vb = v + bb * vs.b + hh * vs.h;

  const int n_kv = (s + BK - 1) / BK;
  // causal: the last row of this tile sees keys up to q0 + BQ - 1
  const int kv_end = causal ? min(n_kv, (q0 + BQ - 1) / BK + 1) : n_kv;
  // window: the first row's oldest visible key is q0 - (window - 1)
  const int kv_start = window > 0 ? max(0, q0 - (window - 1)) / BK : 0;

  tc::load_rows<BQ, DH, NT>(sq, qb, qs.s, q0, s);
  tc::cp_async_commit();
  tc::load_rows<BK, DH, NT>(skv, kb, ks.s, kv_start * BK, s);
  tc::load_rows<BK, DH, NT>(skv + BK * LD, vb, vs.s, kv_start * BK, s);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();  // q has landed; the first k/v tile may not have
  __syncthreads();
  tc::scale_rows<BQ, DH, NT>(sq, sq, scale_log2);
  __syncthreads();

  const bf16* sqw = sq + warp * 16 * LD;  // this warp's 16 q rows
  uint32_t qf[C::QREG ? KD : 1][4];
  if constexpr (C::QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      tc::ldsm_x4(qf[kd], sqw + tc::a_off(lane, LD) + kd * 16);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this thread's rows are row0 (fragment entries 0, 1) and row0 + 8 (2, 3)
  const int row0 = q0 + warp * 16 + g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = kv_start; kt < kv_end; ++kt) {
    const int st = (kt - kv_start) & 1;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile kt is visible; stage st ^ 1 has no readers
    if (kt + 1 < kv_end) {
      bf16* nx = skv + (st ^ 1) * 2 * BK * LD;
      tc::load_rows<BK, DH, NT>(nx, kb, ks.s, (kt + 1) * BK, s);
      tc::load_rows<BK, DH, NT>(nx + BK * LD, vb, vs.s, (kt + 1) * BK, s);
      tc::cp_async_commit();
    }
    const bf16* sk = skv + st * 2 * BK * LD;
    const bf16* sv = sk + BK * LD;
    const int k0 = kt * BK;

    float sc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if constexpr (C::QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kd][i];
      } else {
        tc::ldsm_x4(a, sqw + tc::a_off(lane, LD) + kd * 16);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        tc::ldsm_x4(b, sk + np * 16 * LD + tc::b_off(lane, LD) + kd * 16);
        tc::mma(sc[2 * np], a, b[0], b[1]);
        tc::mma(sc[2 * np + 1], a, b[2], b[3]);
      }
    }

    // only tiles that straddle the diagonal, the window's edge or the
    // ragged tail are masked
    const bool masked = k0 + BK > s || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && q0 + BQ - 1 - k0 >= window);
    if (masked) {
      // element (j, e) has col = c0 + 8 j + (e & 1) and row - col =
      // d + 8 (e >> 1) - 8 j - (e & 1): three integers per thread, not a
      // row and a column per element (which cost the registers that keep
      // four CTAs on an SM at head_dim 64)
      const int c0 = k0 + 2 * t, d = row0 - c0, lim = s - c0;
      const int lo = causal ? 0 : -(1 << 30), hi = window > 0 ? window : 1 << 30;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int dd = d + 8 * (e >> 1) - 8 * j - (e & 1);
          if (8 * j + (e & 1) >= lim || dd < lo || dd >= hi) sc[j][e] = NEG_INF;
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // while m is NEG_INF every earlier p was forced to 0, so l and acc
      // are 0 and the rescale is harmless
      const float alpha = tc::ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = tc::ex2(sc[j][e] - m[e >> 1]);
        if (masked && sc[j][e] <= 0.5f * NEG_INF) p = 0.f;
        sc[j][e] = p;
        l[e >> 1] += p;  // this thread's columns; the quad sums at the end
      }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      tc::c_to_a(a, sc[2 * kk], sc[2 * kk + 1]);  // p, rounded to bf16
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t b[4];
        tc::ldsm_x4_t(b, sv + kk * 16 * LD + tc::bt_off(lane, LD) + dp * 16);
        tc::mma(acc[2 * dp], a, b[0], b[1]);
        tc::mma(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  bf16* obase = o + bb * os.b + hh * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= s) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
    bf16* orow = obase + row * os.s + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          tc::pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0) lse[((long long)bb * h + hh) * s + row] = (m[r] + log2f(lc)) * LN2;
  }
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, int b, int s, int h, Strides qs, Strides ks,
                      Strides vs, Strides os, int causal, int window,
                      cudaStream_t stream) {
  using C = TcFwd<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return err;
  // scale * log2(e) as the JAX kernel forms it: in double, then one rounding
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)DH));
  const dim3 grid(h, b, (s + C::BQ - 1) / C::BQ);
  flash_fwd_tc<DH><<<grid, C::NT, C::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), s, h, qs, ks, vs, os, causal, window,
      scale_log2);
  return cudaGetLastError();
}

template <bool TC>
cudaError_t dispatch_dh(int dh, const void* q, const void* k, const void* v,
                        void* o, void* lse, int b, int s, int h, Strides qs,
                        Strides ks, Strides vs, Strides os, int causal,
                        int window, cudaStream_t stream) {
#define FLASH_FWD_LAUNCH(DH)                                                    \
  (TC ? launch_tc<DH>(q, k, v, o, lse, b, s, h, qs, ks, vs, os, causal, window, \
                      stream)                                                   \
      : launch<float, DH>(q, k, v, o, lse, b, s, h, qs, ks, vs, os, causal,     \
                          window, stream))
  switch (dh) {
    case 64:
      return FLASH_FWD_LAUNCH(64);
    case 128:
      return FLASH_FWD_LAUNCH(128);
    case 256:
      return FLASH_FWD_LAUNCH(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_FWD_LAUNCH
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores; 16-byte
// aligned pointers and strides a multiple of 8 elements). Strides are in
// elements. window <= 0 means no window. Returns cudaGetLastError() after
// the launch.
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
  if (dtype == 0) {
    err = dispatch_dh<false>(dh, q, k, v, o, lse, b, s, h, qs, ks, vs, os, causal,
                             window, st);
  } else if (dtype == 1) {
    const void* ptrs[4] = {q, k, v, o};
    const Strides strides[4] = {qs, ks, vs, os};
    err = tc::aligned16(ptrs, strides, 4, b, s, h)
              ? dispatch_dh<true>(dh, q, k, v, o, lse, b, s, h, qs, ks, vs, os,
                                  causal, window, st)
              : cudaErrorInvalidValue;
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
