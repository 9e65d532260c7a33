// bf16 tensor-core building blocks shared by flash_fwd.cu and flash_bwd.cu
// (sm_80+ instructions, built for sm_90a): 16-byte cp.async with zero fill,
// ldmatrix (plain and transposed), mma.sync m16n8k16 bf16 -> f32, and the
// tile loader for rows of a strided [s, dh] view.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each register two bf16 with the lower column in the low
// half:
//   A 16x16: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//            a2 (row g, cols 8+2t..), a3 (row g+8, cols 8+2t..)
//   B 16x8:  b0 (k 2t..2t+1, col g), b1 (k 8+2t.., col g)
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16 in
// pairs, are the A fragment of one 16-deep step: a probability tile
// computed by one product feeds the next with no trip through shared
// memory.
//
// Shared-memory tiles hold bf16 rows of dh + PAD elements: the pad of 8
// (16 bytes) puts the 8 rows an ldmatrix phase reads in 8 distinct groups
// of 4 banks, so neither ldmatrix nor the 16-byte cp.async stores conflict.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int PAD = 8;  // bf16 elements of padding per shared-memory row

struct Strides {  // element strides of a [b, s, h, dh] view; dh is contiguous
  long long b, s, h;
};

// cp.async copies 16 bytes: every base pointer 16-byte aligned and the
// stride of every dimension longer than 1 a multiple of 8 elements
// (ops/flash_attention.py checks this first and names the offender)
inline bool aligned16(const void* const* ptrs, const Strides* st, int n, int b,
                      int s, int h) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    if ((b > 1 && st[i].b % 8) || (s > 1 && st[i].s % 8) || (h > 1 && st[i].h % 8))
      return false;
  }
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with src_bytes = 0 nothing is read and the
// 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8, and receives in r[m] the pair (row lane / 4, cols 2 (lane % 4) ..)
// of matrix m
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, each matrix transposed: r[m] holds (rows 2 (lane % 4) and
// 2 (lane % 4) + 1, col lane / 4) of matrix m
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b (16x16 by 16x8), bf16 operands, f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of one 16-deep step from the C fragments of the two
// 8-column tiles c0 (columns 0..7) and c1 (columns 8..15)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, MUFU
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Lane offsets into a padded tile of row stride LD for the three ldmatrix
// uses (r0, c0 the tile's first row and column):
//   A operand, rows r0..r0+15, cols c0..c0+15 (row-major A):
__device__ __forceinline__ int a_off(int lane, int LD) {
  return (lane & 15) * LD + (lane >> 4) * 8;
}
//   B operand from rows n0..n0+15 that are the output columns (two 8-wide
//   n tiles), cols c0..c0+15 the depth: r[0], r[1] feed n tile 0 and
//   r[2], r[3] n tile 1
__device__ __forceinline__ int b_off(int lane, int LD) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
}
//   B operand from rows k0..k0+15 that are the depth, cols n0..n0+15 the
//   output columns (ldsm_x4_t): r[0], r[1] feed n tile 0, r[2], r[3] n tile 1
__device__ __forceinline__ int bt_off(int lane, int LD) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
}

// Start the copy of rows r0 .. r0 + NR - 1 of a [s, DH] view (row stride
// ss elements, contiguous DH) into dst[NR][DH + PAD] by cp.async; rows at
// or past s are zero-filled by the copy itself. The caller commits.
template <int NR, int DH, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int r0, int s) {
  constexpr int CPR = DH / 8;  // 16-byte chunks per row
  constexpr int LD = DH + PAD;
  static_assert((NR * CPR) % NT == 0, "tile chunks must split over threads");
#pragma unroll
  for (int i = 0; i < NR * CPR / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / CPR, c = idx % CPR, row = r0 + r;
    const bool in = row < s;
    cp_async16(dst + r * LD + c * 8, src + (in ? row : 0) * ss + c * 8,
               in ? 16 : 0);
  }
}

// dst[r][c] = bf16(src[r][c] * scale), rows of a padded [NR][DH + PAD]
// tile, 8 elements at a time (src may equal dst)
template <int NR, int DH, int NT>
__device__ __forceinline__ void scale_rows(bf16* dst, const bf16* src,
                                           float scale) {
  constexpr int CPR = DH / 8;
  constexpr int LD = DH + PAD;
  static_assert((NR * CPR) % NT == 0, "tile chunks must split over threads");
#pragma unroll
  for (int i = 0; i < NR * CPR / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int off = (idx / CPR) * LD + (idx % CPR) * 8;
    uint4 v = *reinterpret_cast<const uint4*>(src + off);
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      w[j] = pack(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(dst + off) = v;
  }
}

}  // namespace tc
