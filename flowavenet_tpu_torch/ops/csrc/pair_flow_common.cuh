// Shared body of the fused reverse flow PAIR kernels for Hopper (sm_90a),
// included by pair_flow.cu (direct 3-tap filter|gate convs: the ports of
// _pair_kernel, _pair_kernel_i8, _pair_kernel_i8rs, _pair_kernel_hoisted
// and _pair_kernel_hoisted_i8 of flowavenet_tpu/ops/pallas_flow.py) and by
// pair_flow_wino.cu (Winograd F(2,3) / F(4,3) filter|gate convs: the ports
// of _pair_kernel_wino and _pair_kernel_wino_hoisted).  resblock.cu reuses
// its CUDA-core product mm2.  One launch applies
//
//     u <- u * exp(log_s(v; odd)) + t(v; odd)       coupling (odd flow)
//     v <- v * sA - bA ; u <- u * sB - bB           ActNorm reverse (odd)
//     v <- v * exp(log_s(u; even)) + t(u; even)     coupling (even flow)
//     u <- u * sC - bC ; v <- v * sD - bD           ActNorm reverse (even)
//
// where each (log_s, t) is a full WaveNet coupling net: k=3 front conv ->
// relu -> gated layers at dilations 1 and 3 with conditioning 1x1s ->
// res/skip -> relu -> 1x1 -> relu -> zero conv.  Weight norm, exp(3*scale),
// the ActNorm exp(-3*logs), int8 weight quantization and the Winograd
// G-transform are folded outside the kernel (ops/pair_flow.py).
//
// What bounds it on this card: arithmetic.  Per output row a pair costs
// ~4.2 MFLOP + 4096*Cc + 5120*R_in against (8*R_in + 4*Cc) bytes of u, v,
// u', v' and c in bf16, i.e. >1000 FLOP per byte, far right of the H100's
// ~295 FLOP/byte ridge, so the bound is the tensor cores' rate (989
// TFLOP/s bf16, 1979 TOP/s int8).  The design therefore keeps every
// intermediate in shared memory: one CTA owns (batch row, time tile of TT
// rows) plus a halo per side, reads u, v and its c rows once, and writes
// u', v' once.  Each filter column is computed together with its gate
// column so the [L, 2R] fp32 pre-activation is never stored.  Weights stay
// in global memory and are served from L2.
//
// Two products.  The CUDA-core product (mm2 / mm2_i8: fp32 FMAs, __dp4a)
// gives each thread one output column and RM rows, and reaches at most the
// CUDA cores' ~67 TFLOP/s.  The tensor-core product (TC = true) runs every
// 1x1 and filter|gate product on mma.sync: m16n8k16 bf16 -> fp32 and
// m16n8k32 s8 -> s32.  A warp owns a 16-row m-tile and two n-tiles of the
// filter together with the same two of the gate (or res with skip-0; one
// of each in the F(4,3) and hoisted F(2,3) layers), so one lane holds f
// and g of the same (row, column) and gates in registers.  A comes from
// shared memory through ldmatrix, one row address per lane (a tap's shift
// and the ragged-edge clamp are just row addresses); the window buffers get a
// padded row stride (ldh, ldq) so that the 8 rows of an ldmatrix fall in
// distinct banks.  The conditioning A fragments are read per lane from
// global memory (a c row is re-read once per column-group warp, 16 times
// per layer at R = 256, instead of once per column thread); shared memory
// holds no c staging because the window buffers already take up to 210 KB
// of the 227 KB.  B is packed by the wrapper (ops/pair_flow.py:
// pack_tc_weights) into fragment order: lane l of (k-step, n-tile) reads
// its 8 bytes with one coalesced load, served from L2.  Warp items run
// m-tile fastest, so the warps that share a column group load the same B
// fragments at about the same time, through L1.  What bounds the
// tensor-core kernels then is the L2 weight traffic (each CTA re-reads a
// pair's weights once per m-tile) and, in the Winograd pair, the input
// transforms, which run on CUDA cores once per warp A fragment.  That
// bound is not the whole story for pair_flow_i8 on the main path: timed at
// the lj22k blocks with one part of its work removed at a time, its B
// loads take ~17 % of the kernel, the int8 conditioning product ~12 %, the
// gate's tanh/exp ~5 %, and its four activation quantizations 18 % before
// quantize_rows_bf2 (below) roughly halved them; sharing each B fragment
// across two or three m-tiles of a warp item did not pay, since the
// accumulators it adds leave too few of the 128 registers a thread of a
// 512-thread CTA has for the loads in flight that hide L2 latency.  The front
// conv (K = 3*R_in) and the zero conv (N = 2*R_in) cost 2560*R_in
// operations per net and row against ~2.1 M for the rest of the net: under
// 1 % at R_in <= 4, so they stay on CUDA cores in the dense instances, but
// 2-14 % at the hoisted pairs' R_in = 16-128, where on the CUDA cores'
// 1/15 of the rate they would outlast the tensor-core rest of the net.
// The hoisted tensor-core instances therefore run them on the tensor cores
// too when R_in is a multiple of 16 (Params::ftc): the front conv as three
// taps of K = R_in over the u/v windows (row stride R_in + 8, row_ld_h, so
// that an ldmatrix's 8 rows fall in distinct banks) into N = R, the zero
// conv as K = R over G into N = 2*R_in with an fp32 result.
//
// TC is set on exactly nine reverse-pair instances, all with bf16 storage:
// the direct pair (pair_flow.cu variant 0, pair_flow), the int8 pair
// (variant 1, pair_flow_i8 on the main path), the int8 res/skip pair
// (variant 2, pair_flow_i8rs: its res|skip-0 and skip-1 products take the
// int8 gate codes, stored at the Q stride, through ldmatrix into m16n8k32;
// the final 1x1 stays bf16), the hoisted pairs (variants 3 and 4,
// pair_flow_hoisted and pair_flow_hoisted_i8: the direct bf16 and int8
// bodies without the conditioning product; each lane adds the precomputed
// pre-activations of the elements it holds, read as bf16x2 words before
// the taps' products), and the F(2,3) and F(4,3) Winograd pairs with dense
// or hoisted conditioning (pair_flow_wino.cu P = 6 and 12, pair_flow_wino,
// pair_flow_wino4 and their _hoisted twins, which add the pre-activations
// of each output of a group as the direct hoisted pairs do); the training
// pairs (pair_flow_train.cu) run the direct bf16 body forward.  Every fp32
// instance runs the CUDA-core product.  int8 sums are exact either way; a bf16
// product is exact in fp32, so the tensor cores change only the fp32
// summation order.  The tensor-core instances take R a multiple of 32 and
// Cc of 16, every instance R dividing NT and R, Cc multiples of 4; the
// wrapper pads other widths with zero channels (ops/pair_flow.py:
// kernel_widths, pad_pair_widths).
//
// Variants (template parameters of pair_reverse_kernel):
//   I8    filter|gate convs on int8 codes of h0/h1 (per-window max-abs
//         scales over exactly the rows each buffer covers) and int8 weights
//         with per-out-channel scales;
//   COND  conditioning 1x1 in the storage type (COND_DENSE), on int8 codes
//         pre-quantized per batch row (COND_I8), or read from precomputed
//         pre-activations [B, T, 2 layers * 2R] (COND_HOIST: the cond
//         matmul ran outside, as one big matmul per block);
//   RS    res/skip 1x1s on int8 gate codes at the fixed scale 1/127
//         (|tanh * sigmoid| < 1, so no max-abs pass) with per-out-channel
//         weight scales; the final 1x1 stays in the storage type;
//   P     0: direct 3-tap convs, 10-row halo (the pair's receptive field);
//         6 / 12: Winograd F(2,3) / F(4,3).  A Winograd group's outputs
//         share transformed taps, so group membership must follow absolute
//         position, as JAX's phase planes do: F(2,3) d=1 groups (2j, 2j+1),
//         d=3 (6j+r, 6j+r+3); F(4,3) d=1 groups 4j..4j+3, d=3 (12j+r, +3,
//         +6, +9), r < 3.  Tiles and windows start at multiples of P and
//         every stage runs over group-aligned regions: a net whose output
//         region is [o0, o1) (P-aligned) runs layer 1 over [o0, o1), layer
//         0 over [o0-4, o1+4), h0 over [o0-5, o1+5) and reads x over
//         [o0-6, o1+6), so the pair's halo is 2P (JAX takes 6P, a plane
//         row per stage; the outputs are the same).
//
// Numerics mirror the Pallas kernels and the plain versions: fp32
// accumulation and gates; h0, h1, the gate outputs, the relu'd skip sum and
// the final 1x1 output are rounded to the storage type; the Winograd input
// transforms are computed in the storage type (each operation rounded),
// products accumulate in fp32 and the output transforms run in fp32; the
// zero conv comes out in fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_common.cuh"

namespace pf {

// the tensor-core primitives (tc_common.cuh), shared with the training pairs
using tc::frag_col;
using tc::frag_row;
using tc::ld_g32;
using tc::ldsm_x4;
using tc::mma_bf16;
using tc::pack_bf16x2;
using tc::tc_b;

constexpr int NT = 512;      // threads per CTA
constexpr int RM = 8;        // rows per register tile
constexpr float SQRT_HALF = 0.7071067811865476f;

enum { COND_DENSE = 0, COND_I8 = 1, COND_HOIST = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// Geometry of a variant: halo per side, the two nets' output regions
// [O1, L-O1) and [O2, L-O2), and how far h0 / layer 0 reach past a net's
// output region.
template <int P> struct Geo {
  static constexpr int HALO = P ? 2 * P : 10;
  static constexpr int O1 = P ? P : 5;
  static constexpr int O2 = P ? 2 * P : 10;
  static constexpr int EH0 = P ? 5 : 4;
  static constexpr int EG0 = P ? 4 : 3;
};

struct Flow {              // one flow's folded operands
  const void* front_w;     // [3][Rin][R]
  const float* front_b;    // [R]
  const void* kfg;         // [2][K][R][2R] (K = 3 direct, 4 F(2,3), 6 F(4,3));
                           // int8: int32 words [2][3][R/4][2R]
  const void* cond_w;      // [2][Cc][2R], int8: int32 words [2][Cc/4][2R]
  const float* cond_b;     // [2][2R]
  const void* res_w;       // [R][R], RS: int32 words [R/4][R]
  const float* res_b;      // [R]
  const void* skip_w;      // [2][R][R], RS: int32 words [2][R/4][R]
  const float* skip_b;     // [2][R]
  const void* fin_w;       // [R][R]
  const float* fin_b;      // [R]
  const void* zw;          // [R][2Rin]
  const float* zb;         // [2Rin]
  const float* kfg_s;      // [2][2R]  per-out-channel weight scales (I8)
  const float* cond_s;     // [2][2R]  (COND_I8)
  const float* res_s;      // [R]      (RS)
  const float* skip_s;     // [2][R]   (RS)
};

struct Params {
  const void* u;           // [B][T][Rin]
  const void* v;
  const void* ca;          // [B][T][Cc]: storage type, int8, or hoisted
  const void* cb;          //   pre-activations (Cc = 2 layers * 2R)
  void* u_out;
  void* v_out;
  Flow flow[2];            // 0 = even, 1 = odd
  const float* an_s;       // [2 flow][2 half][Rin]
  const float* an_b;
  const float* crs;        // [B][2] per-row c scales (COND_I8), else null
  int B, T, Rin, R, Cc, TT, n_t;
  int ftc;                 // front and zero convs on the tensor cores (the
                           // hoisted TC instances, R_in % 16 == 0; front_w
                           // and zw then come packed)
};

struct Smem {
  float* S;     // [rows][R] fp32 skip-0 accumulator
  float* net;   // [rows][2Rin] zero-conv output
  float* VA;    // [L][Rin] v after the odd ActNorm (fp32)
  float* red;   // [32] reduction scratch
  void* H;      // [L][ldh] h0 -> h1 -> relu'd skip sum
  void* G;      // [L][ldh] gate outputs (RS: int8 codes) -> final 1x1 output
  void* U;      // [L][ldx] window of u (ldx: R_in, or R_in + 8 in the
  void* V;      // [L][ldx] window of v   hoisted TC instances)
  void* UM;     // [L][ldx] u after the odd coupling and ActNorm
  int8_t* Q;    // [L][ldq] int8 codes of h0 / h1 (I8)
  int ldh;      // row stride of H and G in elements: R, or R + 8 (TC)
  int ldq;      // row stride of Q in bytes: R, or R + 16 (TC)
};

// The widths an instance takes: R divides NT (a CUDA-core product gives
// each thread one column) and R, Cc are multiples of 4 (int8 words); the
// tensor-core instances also need R a multiple of 32 (a warp item spans 16
// filter columns with their 16 gate columns, or 32 columns of one 1x1; an
// int8 k-step is 32 deep) and Cc of 16 (a bf16 k-step).
inline bool geometry_ok(int R, int Cc, bool tc) {
  if (R <= 0 || Cc <= 0 || NT % R || R % 4 || Cc % 4) return false;
  return !tc || (R % 32 == 0 && Cc % 16 == 0);
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Row strides of the window buffers: the tensor-core product pads a row by
// 16 bytes, so the 8 row addresses of one ldmatrix hit distinct banks.
__host__ __device__ inline int row_ld_h(int R, bool tc) {
  return tc ? R + 8 : R;
}
__host__ __device__ inline int row_ld_q(int R, bool tc) {
  return tc ? R + 16 : R;
}

// Whether an instance keeps its u/v windows at the padded row stride
// row_ld_h(Rin, true): the direct hoisted tensor-core instances, whose
// front conv may read them through ldmatrix (Params::ftc).  The hoisted
// Winograd instances (P != 0) keep the unpadded stride: their R_in (1-4 at
// lj22k blocks 0-2) is no multiple of 16, so their front and zero convs
// stay on CUDA cores.
__host__ __device__ constexpr bool pad_windows(bool tc, int cond, int P) {
  return tc && cond == COND_HOIST && P == 0;
}

// Byte offsets of the Smem regions for a window of L rows whose first net
// covers ``rows`` output rows; the last entry is the total size.  padx:
// the u/v windows' rows padded as H's (row_ld_h(Rin, true)), for the front
// conv's ldmatrix in the hoisted tensor-core instances.
__host__ __device__ inline void smem_layout(int es, bool i8, bool tc, int R,
                                            int Rin, int L, int rows,
                                            size_t off[11],
                                            bool padx = false) {
  const size_t ldh = row_ld_h(R, tc), ldq = row_ld_q(R, tc);
  const size_t ldx = row_ld_h(Rin, padx);
  size_t o = 0;
  off[0] = o; o = align16(o + sizeof(float) * rows * R);
  off[1] = o; o = align16(o + sizeof(float) * rows * 2 * Rin);
  off[2] = o; o = align16(o + sizeof(float) * L * Rin);
  off[3] = o; o = align16(o + sizeof(float) * 32);
  off[4] = o; o = align16(o + (size_t)es * L * ldh);
  off[5] = o; o = align16(o + (size_t)es * L * ldh);
  off[6] = o; o = align16(o + (size_t)es * L * ldx);
  off[7] = o; o = align16(o + (size_t)es * L * ldx);
  off[8] = o; o = align16(o + (size_t)es * L * ldx);
  off[9] = o; o = align16(o + (i8 ? (size_t)L * ldq : 0));
  off[10] = o;
}

template <int P>
__host__ __device__ inline size_t smem_bytes(int es, bool i8, bool tc, int R,
                                             int Rin, int TT,
                                             bool padx = false) {
  const int L = TT + 2 * Geo<P>::HALO;
  size_t off[11];
  smem_layout(es, i8, tc, R, Rin, L, L - 2 * Geo<P>::O1, off, padx);
  return off[10];
}

// acc0[i] += sum_k sum_c A[(rows[i] + k*dil) * lda + c] * W0[k*cin*ldw + c*ldw]
// (and acc1 with W1): two output columns share every A load.  A is a
// shared-memory buffer (every thread of a warp reads the same element, a
// broadcast); W0/W1 point at the thread's column of a global weight.
template <typename TA, typename TW>
__device__ __forceinline__ void mm2(float (&a0)[RM], float (&a1)[RM],
                                    const TA* A, int lda,
                                    const int (&rows)[RM], int ntaps,
                                    int dil, int cin, const TW* W0,
                                    const TW* W1, int ldw) {
  for (int k = 0; k < ntaps; ++k) {
    const TW* w0k = W0 + (size_t)k * cin * ldw;
    const TW* w1k = W1 + (size_t)k * cin * ldw;
#pragma unroll 2
    for (int c = 0; c < cin; ++c) {
      const float w0 = to_f(w0k[(size_t)c * ldw]);
      const float w1 = to_f(w1k[(size_t)c * ldw]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = to_f(A[(size_t)(rows[i] + k * dil) * lda + c]);
        a0[i] = fmaf(a, w0, a0[i]);
        a1[i] = fmaf(a, w1, a1[i]);
      }
    }
  }
}

template <typename TA, typename TW>
__device__ __forceinline__ void mm1(float (&a0)[RM], const TA* A, int lda,
                                    const int (&rows)[RM], int cin,
                                    const TW* W0, int ldw) {
#pragma unroll 2
  for (int c = 0; c < cin; ++c) {
    const float w0 = to_f(W0[(size_t)c * ldw]);
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a0[i] = fmaf(to_f(A[(size_t)rows[i] * lda + c]), w0, a0[i]);
  }
}

// int8 twin of mm2 over 4-channel words: A rows are int8 with row stride
// lda bytes (a multiple of 4); W0/W1 are the thread's column of int32 words
// packed as [k][cin/4][ldw] (4 consecutive input channels per word).
__device__ __forceinline__ void mm2_i8(int (&a0)[RM], int (&a1)[RM],
                                       const int8_t* A, int lda,
                                       const int (&rows)[RM], int ntaps,
                                       int dil, int cin4, const int* W0,
                                       const int* W1, int ldw) {
  for (int k = 0; k < ntaps; ++k) {
    const int* w0k = W0 + (size_t)k * cin4 * ldw;
    const int* w1k = W1 + (size_t)k * cin4 * ldw;
#pragma unroll 2
    for (int c = 0; c < cin4; ++c) {
      const int w0 = w0k[(size_t)c * ldw];
      const int w1 = w1k[(size_t)c * ldw];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int a = *reinterpret_cast<const int*>(
            A + (size_t)(rows[i] + k * dil) * lda + 4 * c);
        a0[i] = __dp4a(a, w0, a0[i]);
        a1[i] = __dp4a(a, w1, a1[i]);
      }
    }
  }
}

__device__ __forceinline__ void mm1_i8(int (&a0)[RM], const int8_t* A,
                                       int lda, const int (&rows)[RM],
                                       int cin4, const int* W0, int ldw) {
#pragma unroll 2
  for (int c = 0; c < cin4; ++c) {
    const int w0 = W0[(size_t)c * ldw];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a0[i] = __dp4a(*reinterpret_cast<const int*>(
                         A + (size_t)rows[i] * lda + 4 * c), w0, a0[i]);
  }
}

// Block-wide max-abs int8 quantization of H rows [r0, r1) (row stride
// ldh) into Q (same rows, row stride ldq); returns the fp32 scale
// (max(amax, 1e-30) / 127, as _quant_act).
template <typename T>
__device__ float quantize_rows(const T* H, int8_t* Q, int r0, int r1, int R,
                               int ldh, int ldq, float* red) {
  float m = 0.f;
  for (int i = threadIdx.x; i < (r1 - r0) * R; i += NT)
    m = fmaxf(m, fabsf(to_f(H[(size_t)(r0 + i / R) * ldh + i % R])));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float x = threadIdx.x < NT / 32 ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
    if (threadIdx.x == 0) red[0] = x;
  }
  __syncthreads();
  const float scale = fmaxf(red[0], 1e-30f) * (1.0f / 127.0f);
  for (int i = threadIdx.x; i < (r1 - r0) * R; i += NT) {
    const int j = r0 + i / R, c = i % R;
    const float q = rintf(to_f(H[(size_t)j * ldh + c]) / scale);
    Q[(size_t)j * ldq + c] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
  }
  __syncthreads();
  return scale;
}

// Rows [r_begin, r_end) in chunks of RM, assigned round-robin to the
// NT / R thread groups; each thread owns one column n.  Rows past r_end
// are clamped for reading and never stored.
#define FOR_ROW_CHUNKS(r_begin, r_end)                                      \
  for (int r_ = (r_begin) + grp * RM; r_ < (r_end); r_ += ngrp * RM)

// Adds the conditioning term of ``layer`` to the filter / gate
// pre-activations of the rows whose global positions are crow[].
template <typename T, int COND>
__device__ __forceinline__ void add_cond(const Params& p, const Flow& f,
                                         int layer, int n,
                                         const void* cglob, int b,
                                         const int (&crow)[RM],
                                         float c_scale, float (&ff)[RM],
                                         float (&gg)[RM]) {
  const int R = p.R, R2 = 2 * R, Cc = p.Cc;
  if constexpr (COND == COND_I8) {
    int fi[RM], gi[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) fi[i] = gi[i] = 0;
    const int* Wc = static_cast<const int*>(f.cond_w) + (size_t)layer *
                    (Cc / 4) * R2;
    const int8_t* C = static_cast<const int8_t*>(cglob) + (size_t)b * p.T *
                      Cc;
    mm2_i8(fi, gi, C, Cc, crow, 1, 0, Cc / 4, Wc + n, Wc + R + n, R2);
    const float cf = c_scale * f.cond_s[layer * R2 + n];
    const float cg = c_scale * f.cond_s[layer * R2 + R + n];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      ff[i] += (float)fi[i] * cf;
      gg[i] += (float)gi[i] * cg;
    }
  } else if constexpr (COND == COND_HOIST) {
    const T* C = static_cast<const T*>(cglob) + (size_t)b * p.T * Cc +
                 layer * R2;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      ff[i] += to_f(C[(size_t)crow[i] * Cc + n]);
      gg[i] += to_f(C[(size_t)crow[i] * Cc + R + n]);
    }
  } else {
    float cf[RM], cg[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) cf[i] = cg[i] = 0.f;
    const T* Wc = static_cast<const T*>(f.cond_w) + (size_t)layer * Cc * R2;
    const T* C = static_cast<const T*>(cglob) + (size_t)b * p.T * Cc;
    mm2(cf, cg, C, Cc, crow, 1, 0, Cc, Wc + n, Wc + R + n, R2);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      ff[i] += cf[i];
      gg[i] += cg[i];
    }
  }
}

// tanh(f) * sigmoid(g) of the biased pre-activations, in fp32.
__device__ __forceinline__ float gated(float fv, float gv) {
  return tanhf(fv) * (1.f / (1.f + expf(-gv)));
}

// Bias, gate and store of RM rows: the gate output rounded to the storage
// type, or (RS) its int8 code at the fixed scale 1/127 (_gated_q8).
template <typename T, bool RS>
__device__ __forceinline__ void gate_store(const Flow& f, const Smem& s,
                                           int R, int layer, int n,
                                           const float (&ff)[RM],
                                           const float (&gg)[RM],
                                           const int (&rows)[RM],
                                           const bool (&keep)[RM]) {
  const float bf = f.cond_b[layer * 2 * R + n];
  const float bg = f.cond_b[layer * 2 * R + R + n];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (!keep[i]) continue;
    const float fv = ff[i] + bf, gv = gg[i] + bg;
    const float g = gated(fv, gv);
    if constexpr (RS)
      static_cast<int8_t*>(s.G)[(size_t)rows[i] * s.ldh + n] =
          (int8_t)rintf(g * 127.f);
    else
      static_cast<T*>(s.G)[(size_t)rows[i] * s.ldh + n] = from_f<T>(g);
  }
}

// Direct filter|gate layer over rows [rb, re) at dilation dil -> G.
template <typename T, bool I8, int COND, bool RS>
__device__ void direct_layer(const Params& p, const Flow& f, const Smem& s,
                             int layer, int rb, int re, int dil,
                             float a_scale, const void* cglob, int b,
                             int win0, float c_scale) {
  const int R = p.R, R2 = 2 * R;
  const int ngrp = NT / R, grp = threadIdx.x / R, n = threadIdx.x % R;
  FOR_ROW_CHUNKS(rb, re) {
    int rows[RM], taps[RM], crow[RM];
    bool keep[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = min(r_ + i, re - 1);
      rows[i] = r;
      taps[i] = r - dil;
      keep[i] = r_ + i < re;
      // c rows outside [0, T) only feed rows that are masked or never
      // stored, so clamping them into the sequence leaves every output
      // exact
      crow[i] = min(max(win0 + r, 0), p.T - 1);
    }
    float ff[RM], gg[RM];
    if constexpr (I8) {
      int fi[RM], gi[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) fi[i] = gi[i] = 0;
      const int* W = static_cast<const int*>(f.kfg) + (size_t)layer * 3 *
                     (R / 4) * R2;
      mm2_i8(fi, gi, s.Q, s.ldq, taps, 3, dil, R / 4, W + n, W + R + n, R2);
      const float sf = a_scale * f.kfg_s[layer * R2 + n];
      const float sg = a_scale * f.kfg_s[layer * R2 + R + n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        ff[i] = (float)fi[i] * sf;
        gg[i] = (float)gi[i] * sg;
      }
    } else {
#pragma unroll
      for (int i = 0; i < RM; ++i) ff[i] = gg[i] = 0.f;
      const T* W = static_cast<const T*>(f.kfg) + (size_t)layer * 3 * R * R2;
      mm2(ff, gg, static_cast<const T*>(s.H), s.ldh, taps, 3, dil, R, W + n,
          W + R + n, R2);
    }
    add_cond<T, COND>(p, f, layer, n, cglob, b, crow, c_scale, ff, gg);
    gate_store<T, RS>(f, s, R, layer, n, ff, gg, rows, keep);
  }
}

// Winograd input transform B^T d in the storage type: every operation is
// rounded, as the Pallas kernel computes it on storage-type planes.
template <typename T>
__device__ __forceinline__ void wino_in(const float (&d)[4], float (&t)[4]) {
  t[0] = rnd<T>(d[0] - d[2]);
  t[1] = rnd<T>(d[1] + d[2]);
  t[2] = rnd<T>(d[2] - d[1]);
  t[3] = rnd<T>(d[1] - d[3]);
}

template <typename T>
__device__ __forceinline__ void wino_in(const float (&d)[6], float (&t)[6]) {
  t[0] = rnd<T>(rnd<T>(rnd<T>(4.f * d[0]) - rnd<T>(5.f * d[2])) + d[4]);
  t[1] = rnd<T>(rnd<T>(rnd<T>(-4.f * rnd<T>(d[1] + d[2])) + d[3]) + d[4]);
  t[2] = rnd<T>(rnd<T>(rnd<T>(4.f * rnd<T>(d[1] - d[2])) - d[3]) + d[4]);
  t[3] = rnd<T>(rnd<T>(rnd<T>(rnd<T>(-2.f * d[1]) - d[2]) +
                       rnd<T>(2.f * d[3])) + d[4]);
  t[4] = rnd<T>(rnd<T>(rnd<T>(rnd<T>(2.f * d[1]) - d[2]) -
                       rnd<T>(2.f * d[3])) + d[4]);
  t[5] = rnd<T>(rnd<T>(rnd<T>(4.f * d[1]) - rnd<T>(5.f * d[3])) + d[5]);
}

// Winograd output transform A^T m in fp32: output e of the group.
__device__ __forceinline__ float wino_out(const float (&m)[4], int e) {
  return e == 0 ? (m[0] + m[1]) + m[2] : (m[1] - m[2]) - m[3];
}

__device__ __forceinline__ float wino_out(const float (&m)[6], int e) {
  switch (e) {
    case 0: return (((m[0] + m[1]) + m[2]) + m[3]) + m[4];
    case 1: return (m[1] - m[2]) + 2.f * (m[3] - m[4]);
    case 2: return (m[1] + m[2]) + 4.f * (m[3] + m[4]);
    default: return ((m[1] - m[2]) + 8.f * (m[3] - m[4])) + m[5];
  }
}

// Winograd filter|gate layer over window rows [rb, re) at dilation dil ->
// G.  rb is aligned to the group period (M for d=1, P for d=3) relative to
// the window start, which is itself a multiple of P.  Each thread owns
// column n of the filter and of the gate; a chunk is GR groups = RM rows.
template <typename T, int COND, int P>
__device__ void wino_layer(const Params& p, const Flow& f, const Smem& s,
                           int layer, int rb, int re, int dil,
                           const void* cglob, int b, int win0,
                           float c_scale) {
  constexpr int K = P == 6 ? 4 : 6;      // transformed taps per group
  constexpr int M = P == 6 ? 2 : 4;      // outputs per group
  constexpr int GR = RM / M;             // groups per chunk
  const int R = p.R, R2 = 2 * R;
  const int ngrp = NT / R, grp = threadIdx.x / R, n = threadIdx.x % R;
  const T* H = static_cast<const T*>(s.H);
  const T* U = static_cast<const T*>(f.kfg) + (size_t)layer * K * R * R2;
  const int ng = (re - rb) / M;
  for (int g_ = grp * GR; g_ < ng; g_ += ngrp * GR) {
    int base[GR];
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      const int gi = min(g_ + i, ng - 1);
      base[i] = dil == 1 ? rb + M * gi : rb + P * (gi / 3) + gi % 3;
    }
    float mf[GR][K], mg[GR][K];
#pragma unroll
    for (int i = 0; i < GR; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) mf[i][k] = mg[i][k] = 0.f;
#pragma unroll 1
    for (int c = 0; c < R; ++c) {
      float uf[K], ug[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uf[k] = to_f(U[((size_t)k * R + c) * R2 + n]);
        ug[k] = to_f(U[((size_t)k * R + c) * R2 + R + n]);
      }
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        float d[K], t[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
          d[k] = to_f(H[(size_t)(base[i] + (k - 1) * dil) * s.ldh + c]);
        wino_in<T>(d, t);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          mf[i][k] = fmaf(t[k], uf[k], mf[i][k]);
          mg[i][k] = fmaf(t[k], ug[k], mg[i][k]);
        }
      }
    }
    float ff[RM], gg[RM];
    int rows[RM], crow[RM];
    bool keep[RM];
#pragma unroll
    for (int i = 0; i < GR; ++i)
#pragma unroll
      for (int e = 0; e < M; ++e) {
        const int idx = i * M + e, pos = base[i] + e * dil;
        ff[idx] = wino_out(mf[i], e);
        gg[idx] = wino_out(mg[i], e);
        rows[idx] = pos;
        keep[idx] = g_ + i < ng;
        crow[idx] = min(max(win0 + pos, 0), p.T - 1);
      }
    add_cond<T, COND>(p, f, layer, n, cglob, b, crow, c_scale, ff, gg);
    gate_store<T, false>(f, s, R, layer, n, ff, gg, rows, keep);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core product (the TC instances)
// ---------------------------------------------------------------------------

constexpr int TJ = 2;   // n-tiles of 8 columns in each half of a warp item

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Warp items over rows [rb, re) of the bf16 or int8 buffer A (row stride
// lda elements): item = (16-row m-tile, column group g), m-tile fastest.
// The warp accumulates A[rows, :K] @ B0[:, tiles tstep*g + {0, 1}] and the
// same with B1 (both packed and offset to this lane, ntl tiles per k-step;
// bf16 m16n8k16 into fp32, or int8 m16n8k32 into exact int32 sums), then
// calls epi(row, n, v0, v1) for each of its rows below re, where n is the
// column of v0 in B0's tiles and v1 is B1's value at the same position.
template <typename TA, typename Epi>
__device__ __forceinline__ void tc_rows(const TA* A, int lda, int rb, int re,
                                        int K, const uint2* B0,
                                        const uint2* B1, int ntl,
                                        int ngroups, int tstep, Epi epi) {
  constexpr bool S8 = sizeof(TA) == 1;
  constexpr int KS = S8 ? 32 : 16;       // k per step: 32 bytes of A
  using Acc = typename std::conditional<S8, int, float>::type;
  const int lane = threadIdx.x & 31, n_mt = (re - rb + 15) >> 4;
  for (int it = threadIdx.x >> 5; it < n_mt * ngroups; it += NT / 32) {
    const int m0 = rb + 16 * (it % n_mt), t0 = tstep * (it / n_mt);
    const TA* a = A + (size_t)min(m0 + (lane & 15), re - 1) * lda +
                  (lane >> 4) * (KS / 2);
    Acc c0[TJ][4] = {}, c1[TJ][4] = {};
#pragma unroll 4
    for (int ks = 0; ks < K / KS; ++ks) {
      uint32_t af[4];
      ldsm_x4(af, a + ks * KS);
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        if constexpr (S8) {
          mma_s8(c0[j], af, tc_b(B0, ntl, ks, t0 + j));
          mma_s8(c1[j], af, tc_b(B1, ntl, ks, t0 + j));
        } else {
          mma_bf16(c0[j], af, tc_b(B0, ntl, ks, t0 + j));
          mma_bf16(c1[j], af, tc_b(B1, ntl, ks, t0 + j));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + frag_row(i);
        if (row < re) epi(row, frag_col(t0 + j, i), c0[j][i], c1[j][i]);
      }
  }
}

// The hoisted conditioning of a warp item on the tensor cores (COND_HOIST):
// for each of its TW n-tiles j, the bf16x2 words of the precomputed filter
// pre-activations at columns n, n + 1 (frag_col of accumulator elements
// 0, 1 and of 2, 3) in this lane's rows lo and hi, then the gate's: h[j] =
// {filter lo, filter hi, gate lo, gate hi}.  c_lo / c_hi point at the
// layer's pre-activations (c + row*Cc + layer*2R) of the rows, already
// clamped into [0, T).  Issued before the taps' products, whose mma.syncs
// hide the loads' latency.
template <int TW>
__device__ __forceinline__ void hoist_words(uint32_t (&h)[TW][4],
                                            const __nv_bfloat16* c_lo,
                                            const __nv_bfloat16* c_hi, int R,
                                            int t0) {
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    const int n = frag_col(t0 + j, 0);
    h[j][0] = ld_g32(c_lo + n);
    h[j][1] = ld_g32(c_hi + n);
    h[j][2] = ld_g32(c_lo + R + n);
    h[j][3] = ld_g32(c_hi + R + n);
  }
}

// Accumulator element i's pre-activation from its n-tile's hoist_words:
// the row (lo, hi) is i >> 1, the column (n: the word's low half, n + 1:
// its high half) i & 1; bf16 -> fp32 is exact.
__device__ __forceinline__ float hoist_elem(const uint32_t (&h)[4], int i,
                                            bool gate) {
  const uint32_t w = h[2 * gate + (i >> 1)];
  return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
}

// Direct int8 filter|gate layer on the tensor cores over rows [rb, re) at
// dilation dil -> G: the TC twin of direct_layer<T, true, COND, RS>.  The
// int8 codes of h (Q, through ldmatrix) against the packed int8 kfg, and
// (COND_I8) this layer's int8 c rows (per-lane global loads, rows clamped
// into [0, T) as in direct_layer) against the packed cond_w, whose K is
// padded to 32 with zero rows; both sums are exact in int32, then scaled,
// biased and gated in the order of direct_layer, add_cond and gate_store.
// COND_HOIST adds the precomputed pre-activations (hoist_words: bf16 c rows
// of width Cc = 2 layers * 2R) after the scaled fg sum instead.  RS stores
// the gate output as its int8 code at the fixed scale 1/127, as gate_store
// does, with G's rows at the Q stride (ldq bytes) so that the res/skip
// products read them through ldmatrix.
template <typename T, bool RS, int COND = COND_I8>
__device__ void direct_layer_tc(const Params& p, const Flow& f,
                                const Smem& s, int layer, int rb, int re,
                                int dil, float a_scale, const void* cglob,
                                int b, int win0, float c_scale) {
  static_assert(COND == COND_I8 || COND == COND_HOIST,
                "int8 tensor-core layers take int8 or hoisted conditioning");
  const int R = p.R, R2 = 2 * R, Cc = p.Cc, lane = threadIdx.x & 31;
  const int nks = R / 32, ntl = R2 / 8, kc = (Cc + 31) / 32;
  const int n_mt = (re - rb + 15) >> 4, ngroups = R / (8 * TJ);
  const uint2* W = static_cast<const uint2*>(f.kfg) +
                   (size_t)layer * 3 * nks * ntl * 32 + lane;
  const uint2* Wc = static_cast<const uint2*>(f.cond_w) +
                    (size_t)layer * kc * ntl * 32 + lane;
  const int8_t* C = static_cast<const int8_t*>(cglob) + (size_t)b * p.T * Cc;
  const float* ks_w = f.kfg_s + layer * R2;
  const float* cs_w = f.cond_s + layer * R2;
  const float* bias = f.cond_b + layer * R2;
  for (int it = threadIdx.x >> 5; it < n_mt * ngroups; it += NT / 32) {
    const int m0 = rb + 16 * (it % n_mt), t0 = TJ * (it / n_mt);
    uint32_t hc[TJ][4];
    if constexpr (COND == COND_HOIST) {
      const __nv_bfloat16* Ch = static_cast<const __nv_bfloat16*>(cglob) +
                                (size_t)b * p.T * Cc + layer * R2;
      const int r_lo = min(m0 + frag_row(0), re - 1);
      const int r_hi = min(m0 + frag_row(2), re - 1);
      hoist_words<TJ>(hc, Ch + (size_t)min(max(win0 + r_lo, 0), p.T - 1) * Cc,
                      Ch + (size_t)min(max(win0 + r_hi, 0), p.T - 1) * Cc, R,
                      t0);
    }
    int fi[TJ][4] = {}, gi[TJ][4] = {};
    const int8_t* a = s.Q + (size_t)(min(m0 + (lane & 15), re - 1) - dil) *
                      s.ldq + (lane >> 4) * 16;
    for (int k = 0; k < 3; ++k) {
      const int8_t* ak = a + (size_t)k * dil * s.ldq;
      const uint2* wk = W + (size_t)k * nks * ntl * 32;
#pragma unroll 4
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, ak + ks * 32);
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          mma_s8(fi[j], af, tc_b(wk, ntl, ks, t0 + j));
          mma_s8(gi[j], af, tc_b(wk, ntl, ks, R / 8 + t0 + j));
        }
      }
    }
    int fc[TJ][4] = {}, gc[TJ][4] = {};
    if constexpr (COND == COND_I8) {
      const int r_lo = min(m0 + frag_row(0), re - 1);
      const int r_hi = min(m0 + frag_row(2), re - 1);
      const int8_t* c_lo = C + (size_t)min(max(win0 + r_lo, 0), p.T - 1) *
                           Cc + 4 * (lane & 3);
      const int8_t* c_hi = C + (size_t)min(max(win0 + r_hi, 0), p.T - 1) *
                           Cc + 4 * (lane & 3);
#pragma unroll 2
      for (int ks = 0; ks < kc; ++ks) {
        const int k0 = 32 * ks;
        // Cc % 32 == 16: the upper half of the last k-step is padding
        const bool tail = k0 + 16 >= Cc;
        uint32_t af[4];
        af[0] = ld_g32(c_lo + k0);
        af[1] = ld_g32(c_hi + k0);
        af[2] = tail ? 0u : ld_g32(c_lo + k0 + 16);
        af[3] = tail ? 0u : ld_g32(c_hi + k0 + 16);
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          mma_s8(fc[j], af, tc_b(Wc, ntl, ks, t0 + j));
          mma_s8(gc[j], af, tc_b(Wc, ntl, ks, R / 8 + t0 + j));
        }
      }
    }
    T* G = static_cast<T*>(s.G);
#pragma unroll
    for (int j = 0; j < TJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + frag_row(i), n = frag_col(t0 + j, i);
        if (row >= re) continue;
        float ff = (float)fi[j][i] * (a_scale * ks_w[n]);
        float gg = (float)gi[j][i] * (a_scale * ks_w[R + n]);
        if constexpr (COND == COND_HOIST) {
          ff += hoist_elem(hc[j], i, false);
          gg += hoist_elem(hc[j], i, true);
        } else {
          ff += (float)fc[j][i] * (c_scale * cs_w[n]);
          gg += (float)gc[j][i] * (c_scale * cs_w[R + n]);
        }
        const float g = gated(ff + bias[n], gg + bias[R + n]);
        if constexpr (RS)
          static_cast<int8_t*>(s.G)[(size_t)row * s.ldq + n] =
              (int8_t)rintf(g * 127.f);
        else
          G[(size_t)row * s.ldh + n] = from_f<T>(g);
      }
  }
}

// ---------------------------------------------------------------------------
// pair_flow_i8's activation quantization
// ---------------------------------------------------------------------------
//
// quantize_rows walks the rows flat, so in each of its two passes every
// element costs an integer division and a remainder by R, which is not
// known at compile time; at the lj22k blocks that made the four
// quantizations of a pair 18 % of pair_flow_i8's time on the card.
// quantize_rows_bf2 does the same with no division: R / 2 divides NT, so
// each thread keeps the two adjacent columns c, c + 1 of every (NT / (R /
// 2))-th row and reads them as one bf16x2 word.  The max-abs is exact in
// any order and each code is the same expression of its element, so Q and
// the scale are quantize_rows' bits.  Only pair_flow_i8 (pair_flow.cu
// variant 1: bf16, int8 filter|gate convs and conditioning, bf16
// res/skip) takes it; the other int8 instances keep quantize_rows.
__device__ inline float quantize_rows_bf2(const __nv_bfloat16* H, int8_t* Q,
                                          int r0, int r1, int R, int ldh,
                                          int ldq, float* red) {
  const int words = R / 2, c = 2 * (threadIdx.x % words);
  const int j0 = r0 + threadIdx.x / words, step = NT / words;
  // row j's columns c, c + 1, bf16 -> fp32 (exact)
  auto load = [&](int j) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        H + (size_t)j * ldh + c));
  };
  float m = 0.f;
  for (int j = j0; j < r1; j += step) {
    const float2 x = load(j);
    m = fmaxf(m, fmaxf(fabsf(x.x), fabsf(x.y)));
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float x = threadIdx.x < NT / 32 ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
    if (threadIdx.x == 0) red[0] = x;
  }
  __syncthreads();
  const float scale = fmaxf(red[0], 1e-30f) * (1.0f / 127.0f);
  for (int j = j0; j < r1; j += step) {
    const float2 x = load(j);
    const int8_t q0 = (int8_t)fminf(fmaxf(rintf(x.x / scale), -127.f), 127.f);
    const int8_t q1 = (int8_t)fminf(fmaxf(rintf(x.y / scale), -127.f), 127.f);
    *reinterpret_cast<uint16_t*>(Q + (size_t)j * ldq + c) =
        (uint16_t)((uint8_t)q0 | (uint8_t)q1 << 8);
  }
  __syncthreads();
  return scale;
}

// The bf16 conditioning 1x1 of one warp item on the tensor cores: this
// lane's c rows at global positions p_lo / p_hi (A fragment rows lo and
// hi, already clamped into [0, T)) against the packed cond_w Wc, TW
// n-tiles from t0 of the filter and the same TW of the gate (gate_t0 on).
// The A fragments are per-lane 4-byte global loads (a c row is re-read
// once per column-group warp of the layer); Cc is a multiple of 16.
template <int TW>
__device__ __forceinline__ void cond_tc(float (&cf)[TW][4],
                                        float (&cg)[TW][4],
                                        const __nv_bfloat16* C, int Cc,
                                        int p_lo, int p_hi, const uint2* Wc,
                                        int ntl, int t0, int gate_t0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* c_lo = C + (size_t)p_lo * Cc + 2 * (lane & 3);
  const __nv_bfloat16* c_hi = C + (size_t)p_hi * Cc + 2 * (lane & 3);
#pragma unroll 2
  for (int ks = 0; ks < Cc / 16; ++ks) {
    uint32_t af[4];
    af[0] = ld_g32(c_lo + 16 * ks);
    af[1] = ld_g32(c_hi + 16 * ks);
    af[2] = ld_g32(c_lo + 16 * ks + 8);
    af[3] = ld_g32(c_hi + 16 * ks + 8);
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      mma_bf16(cf[j], af, tc_b(Wc, ntl, ks, t0 + j));
      mma_bf16(cg[j], af, tc_b(Wc, ntl, ks, gate_t0 + t0 + j));
    }
  }
}

// Activation hooks of coupling_net: the reverse pairs keep nothing
// (NoSave, every call empty); the training backward's recompute passes a
// hook that copies each stage's rows to its workspace.  rows(what, buf,
// rb, re) runs right after the barrier that ends a stage, on rows [rb, re)
// of the bf16 window buffer buf (what: ACT_H0 ... ACT_O2); fg(layer, row,
// n, f, g) gets the biased filter and gate pre-activations of (row, n).
enum { ACT_H0 = 0, ACT_G0, ACT_H1, ACT_G1, ACT_O1, ACT_O2, N_ACT };
struct NoSave {
  __device__ void rows(int, const void*, int, int) const {}
  __device__ void fg(int, int, int, float, float) const {}
};

// Direct bf16 filter|gate layer on the tensor cores over rows [rb, re) at
// dilation dil -> G: the TC twin of direct_layer<bf16, false, COND,
// false>.  The three taps are three bf16 products over R/16 k-steps with A
// from H through ldmatrix (tap k of row r is row r + (k-1)*dil; rows past
// re are clamped to re - 1 and never stored) against the packed kfg, then
// (COND_DENSE) the conditioning 1x1 (cond_tc, c rows clamped into [0, T)
// as in direct_layer) into its own accumulators, or (COND_HOIST) the
// precomputed pre-activations (hoist_words), added after the fg sum,
// biased and gated in the order of direct_layer, add_cond and gate_store.
template <int COND = COND_DENSE, class Save = NoSave>
__device__ inline void direct_layer_tc_bf(const Params& p, const Flow& f,
                                          const Smem& s, int layer, int rb,
                                          int re, int dil, const void* cglob,
                                          int b, int win0,
                                          const Save& save = Save{}) {
  static_assert(COND == COND_DENSE || COND == COND_HOIST,
                "bf16 tensor-core layers take dense or hoisted conditioning");
  using bf = __nv_bfloat16;
  const int R = p.R, R2 = 2 * R, lane = threadIdx.x & 31;
  const int nks = R / 16, ntl = R2 / 8;
  const int n_mt = (re - rb + 15) >> 4, ngroups = R / (8 * TJ);
  const uint2* W = static_cast<const uint2*>(f.kfg) +
                   (size_t)layer * 3 * nks * ntl * 32 + lane;
  const uint2* Wc = static_cast<const uint2*>(f.cond_w) +
                    (size_t)layer * (p.Cc / 16) * ntl * 32 + lane;
  const bf* C = static_cast<const bf*>(cglob) + (size_t)b * p.T * p.Cc;
  const float* bias = f.cond_b + layer * R2;
  for (int it = threadIdx.x >> 5; it < n_mt * ngroups; it += NT / 32) {
    const int m0 = rb + 16 * (it % n_mt), t0 = TJ * (it / n_mt);
    uint32_t hc[TJ][4];
    if constexpr (COND == COND_HOIST) {
      const bf* Ch = C + layer * R2;
      const int r_lo = min(m0 + frag_row(0), re - 1);
      const int r_hi = min(m0 + frag_row(2), re - 1);
      hoist_words<TJ>(hc,
                      Ch + (size_t)min(max(win0 + r_lo, 0), p.T - 1) * p.Cc,
                      Ch + (size_t)min(max(win0 + r_hi, 0), p.T - 1) * p.Cc,
                      R, t0);
    }
    float fa[TJ][4] = {}, ga[TJ][4] = {};
    const bf* a = static_cast<const bf*>(s.H) +
                  (size_t)(min(m0 + (lane & 15), re - 1) - dil) * s.ldh +
                  (lane >> 4) * 8;
    for (int k = 0; k < 3; ++k) {
      const bf* ak = a + (size_t)k * dil * s.ldh;
      const uint2* wk = W + (size_t)k * nks * ntl * 32;
#pragma unroll 4
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, ak + ks * 16);
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          mma_bf16(fa[j], af, tc_b(wk, ntl, ks, t0 + j));
          mma_bf16(ga[j], af, tc_b(wk, ntl, ks, R / 8 + t0 + j));
        }
      }
    }
    float cf[TJ][4] = {}, cg[TJ][4] = {};
    if constexpr (COND == COND_DENSE) {
      const int r_lo = min(m0 + frag_row(0), re - 1);
      const int r_hi = min(m0 + frag_row(2), re - 1);
      cond_tc<TJ>(cf, cg, C, p.Cc, min(max(win0 + r_lo, 0), p.T - 1),
                  min(max(win0 + r_hi, 0), p.T - 1), Wc, ntl, t0, R / 8);
    }
    bf* G = static_cast<bf*>(s.G);
#pragma unroll
    for (int j = 0; j < TJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + frag_row(i), n = frag_col(t0 + j, i);
        if (row >= re) continue;
        if constexpr (COND == COND_HOIST) {
          cf[j][i] = hoist_elem(hc[j], i, false);
          cg[j][i] = hoist_elem(hc[j], i, true);
        }
        const float fv = fa[j][i] + cf[j][i], gv = ga[j][i] + cg[j][i];
        const float fb = fv + bias[n], gb = gv + bias[R + n];
        save.fg(layer, row, n, fb, gb);
        G[(size_t)row * s.ldh + n] = from_f<bf>(gated(fb, gb));
      }
  }
}

// bf16x2 arithmetic with one rounding per operation (fma.rn.bf16x2 as
// a*1 + b, b*(-1) + a and a*k + (-0)).  Rounding the exact result once to
// bf16 gives the same bits as rounding it to fp32 and then to bf16 (fp32
// keeps more than 2*8 + 2 significand bits, so the double rounding is
// innocuous), i.e. the same as rnd<bf16> of the fp32 operation in wino_in
// and in the plain version.
__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
constexpr uint32_t BF2_ONE = 0x3F803F80u, BF2_MINUS_ONE = 0xBF80BF80u,
                   BF2_MINUS_ZERO = 0x80008000u, BF2_TWO = 0x40004000u,
                   BF2_MINUS_TWO = 0xC000C000u, BF2_FOUR = 0x40804080u,
                   BF2_MINUS_FOUR = 0xC080C080u, BF2_FIVE = 0x40A040A0u;
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  return bf2_fma(a, BF2_ONE, b);
}
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  return bf2_fma(b, BF2_MINUS_ONE, a);
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t k) {
  return bf2_fma(a, k, BF2_MINUS_ZERO);
}

// wino_in<bf16> of the 4 or 6 taps on two channels at once: the same
// operations in the same order, each rounded once.
__device__ __forceinline__ void wino_in_bf2(const uint32_t (&d)[4],
                                            uint32_t (&t)[4]) {
  t[0] = bf2_sub(d[0], d[2]);
  t[1] = bf2_add(d[1], d[2]);
  t[2] = bf2_sub(d[2], d[1]);
  t[3] = bf2_sub(d[1], d[3]);
}

__device__ __forceinline__ void wino_in_bf2(const uint32_t (&d)[6],
                                            uint32_t (&t)[6]) {
  t[0] = bf2_add(bf2_sub(bf2_mul(d[0], BF2_FOUR), bf2_mul(d[2], BF2_FIVE)),
                 d[4]);
  t[1] = bf2_add(bf2_add(bf2_mul(bf2_add(d[1], d[2]), BF2_MINUS_FOUR), d[3]),
                 d[4]);
  t[2] = bf2_add(bf2_sub(bf2_mul(bf2_sub(d[1], d[2]), BF2_FOUR), d[3]), d[4]);
  t[3] = bf2_add(bf2_add(bf2_sub(bf2_mul(d[1], BF2_MINUS_TWO), d[2]),
                         bf2_mul(d[3], BF2_TWO)), d[4]);
  t[4] = bf2_add(bf2_sub(bf2_sub(bf2_mul(d[1], BF2_TWO), d[2]),
                         bf2_mul(d[3], BF2_TWO)), d[4]);
  t[5] = bf2_add(bf2_sub(bf2_mul(d[1], BF2_FOUR), bf2_mul(d[3], BF2_FIVE)),
                 d[5]);
}

// The A fragments of the K Winograd planes for one k-step: register r of
// the m16n8k16 fragment is group row lo / hi (r & 1), channels 2(lane%4)
// + {0, 1} + 8(r >> 1); h_lo / h_hi point at that lane's first tap (row
// base - dil, channel 2(lane%4) of the k-step) and step is dil rows.
// BF2: the transform in bf16x2 (wino_in_bf2: the same bits as wino_in<bf16>
// in a fraction of the instructions and registers), as F(4,3)'s 6-tap
// transform needs and the hoisted F(2,3) pair takes; otherwise (the dense
// F(2,3) pair) in fp32 with each operation rounded (wino_in<bf16>).
template <int P, bool BF2 = P == 12>
__device__ __forceinline__ void wino_frags(uint32_t (&af)[P == 6 ? 4 : 6][4],
                                           const __nv_bfloat16* h_lo,
                                           const __nv_bfloat16* h_hi,
                                           size_t step) {
  static_assert(P == 6 || BF2, "F(4,3) transforms in bf16x2");
  using bf = __nv_bfloat16;
  constexpr int K = P == 6 ? 4 : 6;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bf* h = (r & 1 ? h_hi : h_lo) + 8 * (r >> 1);
    if constexpr (!BF2) {
      float dx[4], dy[4], tx[4], ty[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(h + k * step));
        dx[k] = d.x;
        dy[k] = d.y;
      }
      wino_in<bf>(dx, tx);
      wino_in<bf>(dy, ty);
#pragma unroll
      for (int k = 0; k < 4; ++k) af[k][r] = pack_bf16x2(tx[k], ty[k]);
    } else {
      uint32_t d[K], t[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        d[k] = *reinterpret_cast<const uint32_t*>(h + k * step);
      wino_in_bf2(d, t);
#pragma unroll
      for (int k = 0; k < K; ++k) af[k][r] = t[k];
    }
  }
}

// Winograd filter|gate layer on the tensor cores over window rows [rb, re)
// at dilation dil -> G: the TC twin of wino_layer<bf16, COND, P>, F(2,3)
// (P = 6) or F(4,3) (P = 12).  The m dimension is the layer's groups
// (F(2,3) d=1 rows 2j, 2j+1, d=3 6j+r, 6j+r+3; F(4,3) d=1 4j..4j+3, d=3
// 12j+r, +3, +6, +9).  Each lane loads the K taps of its 8 A elements (2
// groups x 4 channels) from H and builds the K plane fragments
// (wino_frags), so a transform is computed once per warp fragment; K
// accumulator sets take the products with the packed G-transformed
// weights, and wino_out runs in fp32 on the lane's own accumulators.  The
// conditioning of output e of a group (c rows base + e*dil, clamped into
// [0, T)) is added after wino_out and before the bias, as add_cond does:
// COND_DENSE runs the conditioning 1x1 as one bf16 product per e;
// COND_HOIST adds the precomputed pre-activations of the lane's elements,
// the TW x 4 bf16x2 words of hoist_words, loaded per e once the plane
// accumulators are dead (loaded before the taps' products instead, the
// M x TW x 4 words spill at F(4,3)).  A warp item spans TW n-tiles of the
// filter and the same of the gate: TJ = 2 for the dense F(2,3); 1 for
// F(4,3), whose 6 planes x f, g x 4 fp32 accumulators per n-tile would not
// fit the 128 registers a thread of 512 has at TW = 2, and for the hoisted
// F(2,3), which spills at TW = 2 and, at TW = 1, takes its input transform
// in bf16x2 (half the transforms per output at twice the A fragments).
template <int P, int COND = COND_DENSE>
__device__ void wino_layer_tc(const Params& p, const Flow& f, const Smem& s,
                              int layer, int rb, int re, int dil,
                              const void* cglob, int b, int win0) {
  static_assert(COND == COND_DENSE || COND == COND_HOIST,
                "bf16 tensor-core layers take dense or hoisted conditioning");
  using bf = __nv_bfloat16;
  constexpr int K = P == 6 ? 4 : 6;      // planes (transformed taps)
  constexpr int M = P == 6 ? 2 : 4;      // outputs per group
  constexpr int TW = P == 6 && COND == COND_DENSE ? TJ : 1;  // n-tiles/item
  const int R = p.R, R2 = 2 * R, lane = threadIdx.x & 31;
  const int nks = R / 16, ntl = R2 / 8;
  const int ng = (re - rb) / M, n_mt = (ng + 15) >> 4;
  const int ngroups = R / (8 * TW);
  const size_t plane = (size_t)nks * ntl * 32;
  const bf* H = static_cast<const bf*>(s.H);
  const uint2* U = static_cast<const uint2*>(f.kfg) + layer * K * plane +
                   lane;
  const uint2* Wc = static_cast<const uint2*>(f.cond_w) +
                    (size_t)layer * (p.Cc / 16) * ntl * 32 + lane;
  const bf* C = static_cast<const bf*>(cglob) + (size_t)b * p.T * p.Cc;
  const float* bias = f.cond_b + layer * R2;
  auto base = [&](int g) {
    return dil == 1 ? rb + M * g : rb + P * (g / 3) + g % 3;
  };
  for (int it = threadIdx.x >> 5; it < n_mt * ngroups; it += NT / 32) {
    const int g0 = 16 * (it % n_mt), t0 = TW * (it / n_mt);
    const int b_lo = base(min(g0 + frag_row(0), ng - 1));
    const int b_hi = base(min(g0 + frag_row(2), ng - 1));
    const bf* h_lo = H + (size_t)(b_lo - dil) * s.ldh + 2 * (lane & 3);
    const bf* h_hi = H + (size_t)(b_hi - dil) * s.ldh + 2 * (lane & 3);
    float mf[K][TW][4] = {}, mg[K][TW][4] = {};
#pragma unroll 1
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t af[K][4];      // [plane][register]
      wino_frags<P, P == 12 || COND == COND_HOIST>(
          af, h_lo + 16 * ks, h_hi + 16 * ks, (size_t)dil * s.ldh);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < TW; ++j) {
          mma_bf16(mf[k][j], af[k], tc_b(U + k * plane, ntl, ks, t0 + j));
          mma_bf16(mg[k][j], af[k],
                   tc_b(U + k * plane, ntl, ks, R / 8 + t0 + j));
        }
    }
    // the output transform first, so the plane accumulators die before
    // the conditioning products
    float ff[M][TW][4], gg[M][TW][4];
#pragma unroll
    for (int j = 0; j < TW; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mfi[K], mgi[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          mfi[k] = mf[k][j][i];
          mgi[k] = mg[k][j][i];
        }
#pragma unroll
        for (int e = 0; e < M; ++e) {
          ff[e][j][i] = wino_out(mfi, e);
          gg[e][j][i] = wino_out(mgi, e);
        }
      }
    bf* G = static_cast<bf*>(s.G);
#pragma unroll
    for (int e = 0; e < M; ++e) {
      float cf[TW][4] = {}, cg[TW][4] = {};
      uint32_t hc[TW][4];
      if constexpr (COND == COND_DENSE) {
        cond_tc<TW>(cf, cg, C, p.Cc,
                    min(max(win0 + b_lo + e * dil, 0), p.T - 1),
                    min(max(win0 + b_hi + e * dil, 0), p.T - 1), Wc, ntl, t0,
                    R / 8);
      } else {
        const bf* Ch = C + layer * R2;
        hoist_words<TW>(
            hc, Ch + (size_t)min(max(win0 + b_lo + e * dil, 0), p.T - 1) * p.Cc,
            Ch + (size_t)min(max(win0 + b_hi + e * dil, 0), p.T - 1) * p.Cc,
            R, t0);
      }
#pragma unroll
      for (int j = 0; j < TW; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int g = g0 + frag_row(i), n = frag_col(t0 + j, i);
          if (g >= ng) continue;
          if constexpr (COND == COND_HOIST) {
            cf[j][i] = hoist_elem(hc[j], i, false);
            cg[j][i] = hoist_elem(hc[j], i, true);
          }
          const float fv = ff[e][j][i] + cf[j][i];
          const float gv = gg[e][j][i] + cg[j][i];
          G[(size_t)(base(g) + e * dil) * s.ldh + n] =
              from_f<bf>(gated(fv + bias[n], gv + bias[R + n]));
        }
    }
  }
}

// The front conv of a hoisted tensor-core net (Params::ftc) over rows [rb,
// re): acc = sum over taps k of X[row - 1 + k] @ W[k], three bf16 products
// of K = Rin (a multiple of 16) with A from the window X through ldmatrix
// (row stride ldx = Rin + 8; rows past re are clamped to re - 1 and never
// stored) against front_w packed per tap (W: [3][Rin/16][N/8] fragments,
// this lane's first; ntl = N/8 = R/8).  A warp item is a 16-row m-tile x 4
// n-tiles, m-tile fastest; epi(row, n, acc) for each of its rows below re.
template <typename Epi>
__device__ __forceinline__ void front_tc(const __nv_bfloat16* X, int ldx,
                                         int rb, int re, int Rin,
                                         const uint2* W, int ntl, Epi epi) {
  constexpr int TN = 2 * TJ;             // n-tiles per warp item
  const int lane = threadIdx.x & 31, n_mt = (re - rb + 15) >> 4;
  const int nks = Rin / 16;
  const size_t tap = (size_t)nks * ntl * 32;
  for (int it = threadIdx.x >> 5; it < n_mt * (ntl / TN); it += NT / 32) {
    const int m0 = rb + 16 * (it % n_mt), t0 = TN * (it / n_mt);
    const __nv_bfloat16* a = X + (size_t)(min(m0 + (lane & 15), re - 1) - 1) *
                                     ldx + (lane >> 4) * 8;
    float c[TN][4] = {};
    for (int k = 0; k < 3; ++k)
      for (int ks = 0; ks < nks; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, a + (size_t)k * ldx + ks * 16);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          mma_bf16(c[j], af, tc_b(W + k * tap, ntl, ks, t0 + j));
      }
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + frag_row(i);
        if (row < re) epi(row, frag_col(t0 + j, i), c[j][i]);
      }
  }
}

// One WaveNet coupling net over window rows [o0, o1): input X (shared,
// rows [o0-EH0-1, o1+EH0+1) valid), conditioning rows from global.  Leaves
// the zero-conv output (log_s || t) for rows [o0, o1) in s.net.  TC: the
// filter|gate layers, res/skip and the final 1x1 run on the tensor cores
// (T is bf16; I8 with COND_I8 and P = 0, with or without RS, COND_DENSE
// or COND_HOIST with P = 0, 6 or 12, or COND_HOIST with I8 and P = 0);
// with COND_HOIST, P = 0 and p.ftc the front and zero convs too (X's rows
// then at the stride row_ld_h(Rin, true)).
template <typename T, bool I8, int COND, bool RS, int P, bool TC,
          class Save = NoSave>
__device__ void coupling_net(const Params& p, const Flow& f, const Smem& s,
                             const T* X, int o0, int o1, const void* cglob,
                             float c_scale, int b, int win0,
                             const Save& save = Save{}) {
  constexpr int EH0 = Geo<P>::EH0, EG0 = Geo<P>::EG0;
  static_assert(!TC || (sizeof(T) == 2 &&
                        ((I8 && COND == COND_I8 && P == 0) ||
                         (!I8 && !RS && COND != COND_I8) ||
                         (!RS && COND == COND_HOIST && P == 0))),
                "the tensor-core product covers the bf16 direct, i8, i8rs, "
                "hoisted, hoisted i8, F(2,3) and F(4,3) pairs, the last two "
                "with dense or hoisted conditioning");
  // the direct hoisted tensor-core instances: u/v windows at a padded row
  // stride, front and zero convs on the tensor cores where p.ftc says so
  constexpr bool HT = pad_windows(TC, COND, P);
  // pair_flow_i8 quantizes its activations with quantize_rows_bf2
  constexpr bool QBF2 = TC && I8 && COND == COND_I8 && !RS && P == 0;
  const int R = p.R, Rin = p.Rin, ld = s.ldh, ldx = row_ld_h(Rin, HT);
  const int ngrp = NT / R, grp = threadIdx.x / R, n = threadIdx.x % R;
  T* H = static_cast<T*>(s.H);
  T* G = static_cast<T*>(s.G);
  auto valid = [&](int j) {
    const int pos = win0 + j;
    return pos >= 0 && pos < p.T;
  };
  // The epilogues, shared by both products: h1 in place over H and skip-0
  // -> S from row j's res and skip-0 sums; relu(skip0 + skip1) -> H; the
  // final 1x1 -> G.  Every element is owned by one thread.
  auto res_epi = [&](int j, int c, float ra, float sa) {
    const float h0 = to_f(H[(size_t)j * ld + c]);
    // the Pallas kernels add the res bias at different points
    const float h1 = P ? rnd<T>(((h0 + ra) + f.res_b[c]) * SQRT_HALF)
                       : rnd<T>((h0 + (ra + f.res_b[c])) * SQRT_HALF);
    H[(size_t)j * ld + c] = from_f<T>(valid(j) ? h1 : 0.f);
    if (j >= o0 && j < o1) s.S[(size_t)(j - o0) * R + c] = sa + f.skip_b[c];
  };
  auto skip_epi = [&](int j, int c, float acc) {
    const float s0 = s.S[(size_t)(j - o0) * R + c];
    const float bias = f.skip_b[R + c];
    const float sk = P ? (s0 + acc) + bias : s0 + (acc + bias);
    H[(size_t)j * ld + c] = from_f<T>(rnd<T>(fmaxf(sk, 0.f)));
  };
  auto fin_epi = [&](int j, int c, float acc) {
    G[(size_t)j * ld + c] = from_f<T>(rnd<T>(fmaxf(acc + f.fin_b[c], 0.f)));
  };

  // h0 = relu(front(X) + b) over [o0-EH0, o1+EH0), rounded, masked
  if (HT && p.ftc) {
    const uint2* W = static_cast<const uint2*>(f.front_w) + (threadIdx.x & 31);
    front_tc(reinterpret_cast<const __nv_bfloat16*>(X), ldx, o0 - EH0,
             o1 + EH0, Rin, W, R / 8, [&](int j, int c, float acc) {
               H[(size_t)j * ld + c] = from_f<T>(
                   valid(j) ? rnd<T>(fmaxf(acc + f.front_b[c], 0.f)) : 0.f);
             });
  } else {
    const int rb = o0 - EH0, re = o1 + EH0;
    const T* W = static_cast<const T*>(f.front_w);
    FOR_ROW_CHUNKS(rb, re) {
      int rows[RM];
      float acc[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        rows[i] = min(r_ + i, re - 1) - 1;
        acc[i] = 0.f;
      }
      for (int k = 0; k < 3; ++k) {
        int rk[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) rk[i] = rows[i] + k;
        mm1(acc, X, ldx, rk, Rin, W + (size_t)k * Rin * R + n, R);
      }
      const float bias = f.front_b[n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int j = r_ + i;
        if (j < re)
          H[(size_t)j * ld + n] = from_f<T>(
              valid(j) ? rnd<T>(fmaxf(acc[i] + bias, 0.f)) : 0.f);
      }
    }
  }
  __syncthreads();
  save.rows(ACT_H0, H, o0 - EH0, o1 + EH0);
  float a_scale = 0.f;
  if constexpr (QBF2)
    a_scale = quantize_rows_bf2(reinterpret_cast<const __nv_bfloat16*>(H),
                                s.Q, o0 - EH0, o1 + EH0, R, ld, s.ldq, s.red);
  else if constexpr (I8)
    a_scale = quantize_rows(H, s.Q, o0 - EH0, o1 + EH0, R, ld, s.ldq, s.red);

  // layer 0 (d=1) over [o0-EG0, o1+EG0): gated -> G
  if constexpr (TC && I8)
    direct_layer_tc<T, RS, COND>(p, f, s, 0, o0 - EG0, o1 + EG0, 1, a_scale,
                                 cglob, b, win0, c_scale);
  else if constexpr (TC && P)
    wino_layer_tc<P, COND>(p, f, s, 0, o0 - EG0, o1 + EG0, 1, cglob, b, win0);
  else if constexpr (TC)
    direct_layer_tc_bf<COND>(p, f, s, 0, o0 - EG0, o1 + EG0, 1, cglob, b,
                             win0, save);
  else if constexpr (P)
    wino_layer<T, COND, P>(p, f, s, 0, o0 - EG0, o1 + EG0, 1, cglob, b,
                           win0, c_scale);
  else
    direct_layer<T, I8, COND, RS>(p, f, s, 0, o0 - EG0, o1 + EG0, 1,
                                  a_scale, cglob, b, win0, c_scale);
  __syncthreads();
  save.rows(ACT_G0, G, o0 - EG0, o1 + EG0);

  // res and skip-0 share the gate outputs: h1 = (h0 + res)*sqrt(.5) in
  // place over H (each thread owns its element), skip-0 -> S
  if constexpr (TC && RS) {
    // int8 gate codes (rows at the Q stride) against the int8 res_w and
    // skip-0 weights, exact int32 sums scaled as the CUDA-core branch does
    const int lane = threadIdx.x & 31;
    tc_rows(static_cast<const int8_t*>(s.G), s.ldq, o0 - EG0, o1 + EG0, R,
            static_cast<const uint2*>(f.res_w) + lane,
            static_cast<const uint2*>(f.skip_w) + lane, R / 8, R / (8 * TJ),
            TJ, [&](int j, int c, int ri, int si) {
              res_epi(j, c, (float)ri * (f.res_s[c] * (1.f / 127.f)),
                      (float)si * (f.skip_s[c] * (1.f / 127.f)));
            });
  } else if constexpr (TC) {
    const int nt = R / 8;
    const int lane = threadIdx.x & 31;
    tc_rows(reinterpret_cast<const __nv_bfloat16*>(G), ld, o0 - EG0,
            o1 + EG0, R, static_cast<const uint2*>(f.res_w) + lane,
            static_cast<const uint2*>(f.skip_w) + lane, nt, R / (8 * TJ), TJ,
            res_epi);
  } else {
    const int rb = o0 - EG0, re = o1 + EG0;
    FOR_ROW_CHUNKS(rb, re) {
      int rows[RM];
      float ra[RM], sa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) rows[i] = min(r_ + i, re - 1);
      if constexpr (RS) {
        int ri[RM], si[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) ri[i] = si[i] = 0;
        mm2_i8(ri, si, static_cast<const int8_t*>(s.G), ld, rows, 1, 0,
               R / 4, static_cast<const int*>(f.res_w) + n,
               static_cast<const int*>(f.skip_w) + n, R);
        const float rsc = f.res_s[n] * (1.f / 127.f);
        const float ssc = f.skip_s[n] * (1.f / 127.f);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          ra[i] = (float)ri[i] * rsc;
          sa[i] = (float)si[i] * ssc;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i) ra[i] = sa[i] = 0.f;
        mm2(ra, sa, G, ld, rows, 1, 0, R, static_cast<const T*>(f.res_w) + n,
            static_cast<const T*>(f.skip_w) + n, R);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (r_ + i < re) res_epi(r_ + i, n, ra[i], sa[i]);
    }
  }
  __syncthreads();
  save.rows(ACT_H1, H, o0 - EG0, o1 + EG0);
  if constexpr (QBF2)
    a_scale = quantize_rows_bf2(reinterpret_cast<const __nv_bfloat16*>(H),
                                s.Q, o0 - EG0, o1 + EG0, R, ld, s.ldq, s.red);
  else if constexpr (I8)
    a_scale = quantize_rows(H, s.Q, o0 - EG0, o1 + EG0, R, ld, s.ldq, s.red);

  // layer 1 (d=3) over [o0, o1): gated -> G
  if constexpr (TC && I8)
    direct_layer_tc<T, RS, COND>(p, f, s, 1, o0, o1, 3, a_scale, cglob, b,
                                 win0, c_scale);
  else if constexpr (TC && P)
    wino_layer_tc<P, COND>(p, f, s, 1, o0, o1, 3, cglob, b, win0);
  else if constexpr (TC)
    direct_layer_tc_bf<COND>(p, f, s, 1, o0, o1, 3, cglob, b, win0, save);
  else if constexpr (P)
    wino_layer<T, COND, P>(p, f, s, 1, o0, o1, 3, cglob, b, win0, c_scale);
  else
    direct_layer<T, I8, COND, RS>(p, f, s, 1, o0, o1, 3, a_scale, cglob, b,
                                  win0, c_scale);
  __syncthreads();
  save.rows(ACT_G1, G, o0, o1);

  // skip-1, relu(skip0 + skip1) rounded -> H
  if constexpr (TC && RS) {
    // as the bf16 branch below, on the int8 gate codes and the int8 skip-1
    // weight (R/32 k-steps of 32 per packed matrix)
    const int lane = threadIdx.x & 31;
    const uint2* W1 = static_cast<const uint2*>(f.skip_w) +
                      (size_t)(R / 32) * (R / 8) * 32 + lane;
    const float* ss = f.skip_s + R;
    tc_rows(static_cast<const int8_t*>(s.G), s.ldq, o0, o1, R, W1,
            W1 + TJ * 32, R / 8, R / (16 * TJ), 2 * TJ,
            [&](int j, int c, int v0, int v1) {
              skip_epi(j, c, (float)v0 * (ss[c] * (1.f / 127.f)));
              skip_epi(j, c + 8 * TJ,
                       (float)v1 * (ss[c + 8 * TJ] * (1.f / 127.f)));
            });
  } else if constexpr (TC) {
    // a warp item takes 4 n-tiles of one matrix: tiles t, t+1 as "B0" and
    // t+2, t+3 as "B1" (16 columns on)
    const int lane = threadIdx.x & 31;
    const uint2* W1 = static_cast<const uint2*>(f.skip_w) +
                      (size_t)(R / 16) * (R / 8) * 32 + lane;
    tc_rows(reinterpret_cast<const __nv_bfloat16*>(G), ld, o0, o1, R, W1,
            W1 + TJ * 32, R / 8, R / (16 * TJ), 2 * TJ,
            [&](int j, int c, float v0, float v1) {
              skip_epi(j, c, v0);
              skip_epi(j, c + 8 * TJ, v1);
            });
  } else {
    FOR_ROW_CHUNKS(o0, o1) {
      int rows[RM];
      float acc[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        rows[i] = min(r_ + i, o1 - 1);
        acc[i] = 0.f;
      }
      if constexpr (RS) {
        int ai[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) ai[i] = 0;
        mm1_i8(ai, static_cast<const int8_t*>(s.G), ld, rows, R / 4,
               static_cast<const int*>(f.skip_w) + (size_t)(R / 4) * R + n,
               R);
        const float sc = f.skip_s[R + n] * (1.f / 127.f);
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i] = (float)ai[i] * sc;
      } else {
        mm1(acc, G, ld, rows, R,
            static_cast<const T*>(f.skip_w) + (size_t)R * R + n, R);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (r_ + i < o1) skip_epi(r_ + i, n, acc[i]);
    }
  }
  __syncthreads();
  save.rows(ACT_O1, H, o0, o1);

  // final 1x1: relu(out @ fin_w + b) rounded -> G
  if constexpr (TC) {
    const uint2* Wf = static_cast<const uint2*>(f.fin_w) +
                      (threadIdx.x & 31);
    tc_rows(reinterpret_cast<const __nv_bfloat16*>(H), ld, o0, o1, R, Wf,
            Wf + TJ * 32, R / 8, R / (16 * TJ), 2 * TJ,
            [&](int j, int c, float v0, float v1) {
              fin_epi(j, c, v0);
              fin_epi(j, c + 8 * TJ, v1);
            });
  } else {
    const T* Wf = static_cast<const T*>(f.fin_w);
    FOR_ROW_CHUNKS(o0, o1) {
      int rows[RM];
      float acc[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        rows[i] = min(r_ + i, o1 - 1);
        acc[i] = 0.f;
      }
      mm1(acc, H, ld, rows, R, Wf + n, R);
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (r_ + i < o1) fin_epi(r_ + i, n, acc[i]);
    }
  }
  __syncthreads();
  save.rows(ACT_O2, G, o0, o1);

  // zero conv (fp32 out): net[j - o0][ch] for ch < 2Rin
  if (HT && p.ftc) {
    // K = R over G into N = 2Rin: a warp item takes 4 n-tiles, tiles t, t+1
    // as "B0" and t+2, t+3 as "B1" (16 columns on), as the final 1x1
    const int R2in = 2 * Rin;
    const uint2* Wz = static_cast<const uint2*>(f.zw) + (threadIdx.x & 31);
    tc_rows(reinterpret_cast<const __nv_bfloat16*>(G), ld, o0, o1, R, Wz,
            Wz + TJ * 32, R2in / 8, R2in / (16 * TJ), 2 * TJ,
            [&](int j, int c, float v0, float v1) {
              float* net = s.net + (size_t)(j - o0) * R2in;
              net[c] = v0 + f.zb[c];
              net[c + 8 * TJ] = v1 + f.zb[c + 8 * TJ];
            });
  } else {
    const int R2in = 2 * Rin, rows = o1 - o0;
    const T* Wz = static_cast<const T*>(f.zw);
    for (int idx = threadIdx.x; idx < rows * R2in; idx += NT) {
      const int j = o0 + idx / R2in, ch = idx % R2in;
      float acc = 0.f;
      for (int c = 0; c < R; ++c)
        acc = fmaf(to_f(G[(size_t)j * ld + c]), to_f(Wz[c * R2in + ch]),
                   acc);
      s.net[idx] = acc + f.zb[ch];
    }
  }
  __syncthreads();
}

template <typename T, bool I8, int COND, bool RS, int P, bool TC>
__global__ void __launch_bounds__(NT) pair_reverse_kernel(Params p) {
  using Gm = Geo<P>;
  constexpr bool HT = pad_windows(TC, COND, P);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TT = p.TT, L = TT + 2 * Gm::HALO, Rin = p.Rin;
  const int ldx = row_ld_h(Rin, HT);
  size_t off[11];
  smem_layout(sizeof(T), I8, TC, p.R, Rin, L, L - 2 * Gm::O1, off, HT);
  Smem s;
  s.ldh = row_ld_h(p.R, TC);
  s.ldq = row_ld_q(p.R, TC);
  s.S = reinterpret_cast<float*>(smem_raw + off[0]);
  s.net = reinterpret_cast<float*>(smem_raw + off[1]);
  s.VA = reinterpret_cast<float*>(smem_raw + off[2]);
  s.red = reinterpret_cast<float*>(smem_raw + off[3]);
  s.H = smem_raw + off[4];
  s.G = smem_raw + off[5];
  s.U = smem_raw + off[6];
  s.V = smem_raw + off[7];
  s.UM = smem_raw + off[8];
  s.Q = reinterpret_cast<int8_t*>(smem_raw + off[9]);
  T* U = static_cast<T*>(s.U);
  T* V = static_cast<T*>(s.V);
  T* UM = static_cast<T*>(s.UM);

  // one CTA = one (batch row, tile): tiles never span two rows, so the
  // per-row c scale and every per-buffer int8 scale stay row-local
  const int b = blockIdx.x / p.n_t, tile = blockIdx.x % p.n_t;
  const int win0 = tile * TT - Gm::HALO;  // global position of window row 0
  auto valid = [&](int j) {
    const int pos = win0 + j;
    return pos >= 0 && pos < p.T;
  };

  // u, v windows; rows outside [0, T) read as zeros
  const T* ug = static_cast<const T*>(p.u) + (size_t)b * p.T * Rin;
  const T* vg = static_cast<const T*>(p.v) + (size_t)b * p.T * Rin;
  for (int idx = threadIdx.x; idx < L * Rin; idx += NT) {
    const int j = idx / Rin;
    const size_t g = (size_t)(win0 + j) * Rin + idx % Rin;
    const int x = HT ? j * ldx + idx % Rin : idx;
    U[x] = valid(j) ? ug[g] : from_f<T>(0.f);
    V[x] = valid(j) ? vg[g] : from_f<T>(0.f);
  }
  __syncthreads();

  const float cs_a = COND == COND_I8 ? p.crs[2 * b] : 0.f;
  const float cs_b = COND == COND_I8 ? p.crs[2 * b + 1] : 0.f;

  // odd flow: u' = u*exp(log_s(v)) + t(v) over rows [O1, L-O1), then the
  // odd ActNorm (v half 0, u half 1); u' rounded and re-masked
  coupling_net<T, I8, COND, RS, P, TC>(p, p.flow[1], s, V, Gm::O1,
                                       L - Gm::O1, p.cb, cs_b, b, win0);
  {
    const float* as = p.an_s + 2 * Rin;   // flow 1
    const float* ab = p.an_b + 2 * Rin;
    for (int idx = threadIdx.x; idx < (L - 2 * Gm::O1) * Rin; idx += NT) {
      const int j = Gm::O1 + idx / Rin, ch = idx % Rin;
      const float* net = s.net + (size_t)(j - Gm::O1) * 2 * Rin;
      float um = to_f(U[j * ldx + ch]) * expf(net[ch]) + net[Rin + ch];
      s.VA[j * Rin + ch] = to_f(V[j * ldx + ch]) * as[ch] - ab[ch];
      um = rnd<T>(um * as[Rin + ch] - ab[Rin + ch]);
      UM[j * ldx + ch] = from_f<T>(valid(j) ? um : 0.f);
    }
  }
  __syncthreads();

  // even flow: v' = v*exp(log_s(u')) + t(u') over rows [O2, L-O2) (the
  // tile), then the even ActNorm (u half 0, v half 1); store rows in [0, T)
  coupling_net<T, I8, COND, RS, P, TC>(p, p.flow[0], s, UM, Gm::O2,
                                       L - Gm::O2, p.ca, cs_a, b, win0);
  {
    T* uo = static_cast<T*>(p.u_out) + (size_t)b * p.T * Rin;
    T* vo = static_cast<T*>(p.v_out) + (size_t)b * p.T * Rin;
    for (int idx = threadIdx.x; idx < TT * Rin; idx += NT) {
      const int j = Gm::O2 + idx / Rin, ch = idx % Rin;
      if (!valid(j)) continue;
      const float* net = s.net + (size_t)(j - Gm::O2) * 2 * Rin;
      const float vn = s.VA[j * Rin + ch] * expf(net[ch]) + net[Rin + ch];
      const float uf = to_f(UM[j * ldx + ch]) * p.an_s[ch] - p.an_b[ch];
      const float vf = vn * p.an_s[Rin + ch] - p.an_b[Rin + ch];
      const size_t g = (size_t)(win0 + j) * Rin + ch;
      uo[g] = from_f<T>(uf);
      vo[g] = from_f<T>(vf);
    }
  }
}

// One instance of the kernel: its launch, and its registers, local (spill)
// bytes per thread and the dynamic shared memory it may use as
// cudaFuncGetAttributes reports them (launch sets the last to the bytes it
// launches with; 48 KB before any launch).
template <typename T, bool I8, int COND, bool RS, int P, bool TC = false>
struct Instance {
  static int launch(Params p, cudaStream_t stream) {
    const int smem = (int)smem_bytes<P>(sizeof(T), I8, TC, p.R, p.Rin, p.TT,
                                        pad_windows(TC, COND, P));
    cudaError_t e = cudaFuncSetAttribute(
        pair_reverse_kernel<T, I8, COND, RS, P, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    pair_reverse_kernel<T, I8, COND, RS, P, TC>
        <<<p.B * p.n_t, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  static int attrs(int* out) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(
        &a, pair_reverse_kernel<T, I8, COND, RS, P, TC>);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = a.maxDynamicSharedSizeBytes;
    return 0;
  }
};

// Fills p from ptrs = u, v, c_a, c_b, u_out, v_out, then 19 operand slots
// (front_w, front_b, kfg, cond_w, cond_b, res_w, res_b, skip_w, skip_b,
// fin_w, fin_b, zw, zb, an_s, an_b, kfg_scale, cond_scale, res_scale,
// skip_scale; null where the variant has none), then c_row_scales; each
// operand stacks the two flows on its leading axis.  dims: B, T, Rin, R,
// Cc, TT.  K: filter|gate taps per layer; es: storage bytes; i8 / rs:
// int8 fg convs and cond / res-skip weights (1 byte per element); tc: the
// weights come packed for the tensor cores (same sizes, except that an
// int8 cond_w has its K padded to a multiple of 32; front_w and zw, packed
// where p.ftc is set by the caller, keep theirs).
inline Params make_params(const void* const* ptrs, const int* dims, int K,
                          size_t es, bool i8, bool rs, bool tc = false) {
  Params p;
  p.B = dims[0]; p.T = dims[1]; p.Rin = dims[2]; p.R = dims[3];
  p.Cc = dims[4]; p.TT = dims[5];
  p.n_t = (p.T + p.TT - 1) / p.TT;
  p.ftc = 0;
  p.u = ptrs[0]; p.v = ptrs[1]; p.ca = ptrs[2]; p.cb = ptrs[3];
  p.u_out = const_cast<void*>(ptrs[4]);
  p.v_out = const_cast<void*>(ptrs[5]);
  const size_t R = p.R, Rin = p.Rin, Cc = p.Cc, R2 = 2 * R;
  const size_t wes = i8 ? 1 : es, rses = rs ? 1 : es;
  const char* base[19];
  for (int i = 0; i < 19; ++i) base[i] = static_cast<const char*>(ptrs[6 + i]);
  auto fptr = [&](int i, size_t off) {
    return base[i] ? reinterpret_cast<const float*>(base[i]) + off : nullptr;
  };
  auto vptr = [&](int i, size_t off) -> const void* {
    return base[i] ? base[i] + off : nullptr;
  };
  for (int fl = 0; fl < 2; ++fl) {
    Flow& f = p.flow[fl];
    f.front_w = vptr(0, fl * 3 * Rin * R * es);
    f.front_b = fptr(1, fl * R);
    f.kfg = vptr(2, fl * 2 * K * R * R2 * wes);
    f.cond_w = vptr(3, fl * 2 * (tc && i8 ? (Cc + 31) / 32 * 32 : Cc) * R2 *
                           wes);
    f.cond_b = fptr(4, fl * 2 * R2);
    f.res_w = vptr(5, fl * R * R * rses);
    f.res_b = fptr(6, fl * R);
    f.skip_w = vptr(7, fl * 2 * R * R * rses);
    f.skip_b = fptr(8, fl * 2 * R);
    f.fin_w = vptr(9, fl * R * R * es);
    f.fin_b = fptr(10, fl * R);
    f.zw = vptr(11, fl * R * 2 * Rin * es);
    f.zb = fptr(12, fl * 2 * Rin);
    f.kfg_s = fptr(15, fl * 2 * R2);
    f.cond_s = fptr(16, fl * 2 * R2);
    f.res_s = fptr(17, fl * R);
    f.skip_s = fptr(18, fl * 2 * R);
  }
  p.an_s = reinterpret_cast<const float*>(base[13]);
  p.an_b = reinterpret_cast<const float*>(base[14]);
  p.crs = static_cast<const float*>(ptrs[25]);
  return p;
}

}  // namespace pf
