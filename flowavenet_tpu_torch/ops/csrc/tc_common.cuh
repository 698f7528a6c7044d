// Tensor-core primitives shared by the pair kernels (pair_flow_common.cuh,
// the reverse pairs) and the training pairs (pair_flow_train.cu): warp-wide
// mma.sync m16n8k16 bf16 -> fp32, ldmatrix loads of its A and B fragments
// from shared memory, and reads of B packed in fragment order by the
// wrapper (ops/pair_flow.py:pack_tc_weights).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// Packed B (ops/pair_flow.py:pack_tc_weights): a [K][N] weight stored as
// [K/KS][N/8][32 lanes][8 bytes], KS = 16 (bf16) or 32 (int8) k per step,
// K zero-padded to a multiple of KS.  Lane l holds the mma B fragment of
// (k-step, n-tile) in the PTX ISA's layout: n = l/4 and, for bf16
// (m16n8k16), k = 2(l%4) + {0, 1}, 2(l%4) + 8 + {0, 1}; for int8
// (m16n8k32), k = 4(l%4) + {0..3}, 4(l%4) + 16 + {0..3}.  B points at this
// lane's first fragment, so a warp reads 256 contiguous bytes.
__device__ __forceinline__ uint2 tc_b(const uint2* B, int ntl, int ks,
                                      int t) {
  return __ldg(B + ((size_t)ks * ntl + t) * 32);
}

__device__ __forceinline__ uint32_t ld_g32(const void* p) {
  return __ldg(static_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  With rows m0 + (l & 15) and a column offset
// of (l >> 4) 16-byte halves this is the m16n8k16 bf16 (or m16n8k32 int8)
// A fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// The same with each 8x8 matrix transposed: lane t receives column t / 4
// of the rows 2(t % 4) and 2(t % 4) + 1 of matrix j in register j.  On a
// row-major buffer X[row][ch] whose rows are the product's reduction
// index, matrix rows (rows k0..k0+7, 8 channels from c0) give the A
// fragment of X^T (m = channel) and the B fragment of X (n = channel).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4],
                                              const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

// c += A B on the tensor cores; accumulator element i of lane l is (row
// l/4 + 8*(i/2), column 2*(l%4) + i%2) of the 16x8 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Row and column of accumulator element i of this lane in a 16x8 tile
// (frag_col: of n-tile t).
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * t + 2 * (threadIdx.x & 3) + (i & 1);
}

}  // namespace tc
