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
// ~295 FLOP/byte ridge.  The design therefore keeps every intermediate in
// shared memory: one CTA owns (batch row, time tile of TT rows) plus a halo
// per side, reads u, v and its c rows once, and writes u', v' once.  Each
// filter column is computed together with its gate column so the [L, 2R]
// fp32 pre-activation is never stored.  Weights stay in global memory and
// are served from L2.  This version runs on CUDA-core FMAs (and __dp4a for
// int8), not on the tensor cores: wgmma/TMA pipelining is later work.
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

namespace pf {

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
};

struct Smem {
  float* S;     // [rows][R] fp32 skip-0 accumulator
  float* net;   // [rows][2Rin] zero-conv output
  float* VA;    // [L][Rin] v after the odd ActNorm (fp32)
  float* red;   // [32] reduction scratch
  void* H;      // [L][R] h0 -> h1 -> relu'd skip sum
  void* G;      // [L][R] gate outputs (RS: int8 codes) -> final 1x1 output
  void* U;      // [L][Rin] window of u
  void* V;      // [L][Rin] window of v
  void* UM;     // [L][Rin] u after the odd coupling and ActNorm
  int8_t* Q;    // [L][R] int8 codes of h0 / h1 (I8)
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Byte offsets of the Smem regions for a window of L rows whose first net
// covers ``rows`` output rows; the last entry is the total size.
__host__ __device__ inline void smem_layout(int es, bool i8, int R, int Rin,
                                            int L, int rows, size_t off[11]) {
  size_t o = 0;
  off[0] = o; o = align16(o + sizeof(float) * rows * R);
  off[1] = o; o = align16(o + sizeof(float) * rows * 2 * Rin);
  off[2] = o; o = align16(o + sizeof(float) * L * Rin);
  off[3] = o; o = align16(o + sizeof(float) * 32);
  off[4] = o; o = align16(o + (size_t)es * L * R);
  off[5] = o; o = align16(o + (size_t)es * L * R);
  off[6] = o; o = align16(o + (size_t)es * L * Rin);
  off[7] = o; o = align16(o + (size_t)es * L * Rin);
  off[8] = o; o = align16(o + (size_t)es * L * Rin);
  off[9] = o; o = align16(o + (i8 ? (size_t)L * R : 0));
  off[10] = o;
}

template <int P>
__host__ __device__ inline size_t smem_bytes(int es, bool i8, int R, int Rin,
                                             int TT) {
  const int L = TT + 2 * Geo<P>::HALO;
  size_t off[11];
  smem_layout(es, i8, R, Rin, L, L - 2 * Geo<P>::O1, off);
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

// Block-wide max-abs int8 quantization of H rows [r0, r1) into Q (same
// rows); returns the fp32 scale (max(amax, 1e-30) / 127, as _quant_act).
template <typename T>
__device__ float quantize_rows(const T* H, int8_t* Q, int r0, int r1, int R,
                               float* red) {
  float m = 0.f;
  for (int i = r0 * R + threadIdx.x; i < r1 * R; i += NT)
    m = fmaxf(m, fabsf(to_f(H[i])));
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
  for (int i = r0 * R + threadIdx.x; i < r1 * R; i += NT) {
    const float q = rintf(to_f(H[i]) / scale);
    Q[i] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
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
    const float g = tanhf(fv) * (1.f / (1.f + expf(-gv)));
    if constexpr (RS)
      static_cast<int8_t*>(s.G)[(size_t)rows[i] * R + n] =
          (int8_t)rintf(g * 127.f);
    else
      static_cast<T*>(s.G)[(size_t)rows[i] * R + n] = from_f<T>(g);
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
      mm2_i8(fi, gi, s.Q, R, taps, 3, dil, R / 4, W + n, W + R + n, R2);
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
      mm2(ff, gg, static_cast<const T*>(s.H), R, taps, 3, dil, R, W + n,
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
          d[k] = to_f(H[(size_t)(base[i] + (k - 1) * dil) * R + c]);
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

// One WaveNet coupling net over window rows [o0, o1): input X (shared,
// rows [o0-EH0-1, o1+EH0+1) valid), conditioning rows from global.  Leaves
// the zero-conv output (log_s || t) for rows [o0, o1) in s.net.
template <typename T, bool I8, int COND, bool RS, int P>
__device__ void coupling_net(const Params& p, const Flow& f, const Smem& s,
                             const T* X, int o0, int o1, const void* cglob,
                             float c_scale, int b, int win0) {
  constexpr int EH0 = Geo<P>::EH0, EG0 = Geo<P>::EG0;
  const int R = p.R, Rin = p.Rin;
  const int ngrp = NT / R, grp = threadIdx.x / R, n = threadIdx.x % R;
  T* H = static_cast<T*>(s.H);
  T* G = static_cast<T*>(s.G);
  auto valid = [&](int j) {
    const int pos = win0 + j;
    return pos >= 0 && pos < p.T;
  };

  // h0 = relu(front(X) + b) over [o0-EH0, o1+EH0), rounded, masked
  {
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
        mm1(acc, X, Rin, rk, Rin, W + (size_t)k * Rin * R + n, R);
      }
      const float bias = f.front_b[n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int j = r_ + i;
        if (j < re)
          H[(size_t)j * R + n] = from_f<T>(
              valid(j) ? rnd<T>(fmaxf(acc[i] + bias, 0.f)) : 0.f);
      }
    }
  }
  __syncthreads();
  float a_scale = 0.f;
  if constexpr (I8)
    a_scale = quantize_rows(H, s.Q, o0 - EH0, o1 + EH0, R, s.red);

  // layer 0 (d=1) over [o0-EG0, o1+EG0): gated -> G
  if constexpr (P)
    wino_layer<T, COND, P>(p, f, s, 0, o0 - EG0, o1 + EG0, 1, cglob, b,
                           win0, c_scale);
  else
    direct_layer<T, I8, COND, RS>(p, f, s, 0, o0 - EG0, o1 + EG0, 1,
                                  a_scale, cglob, b, win0, c_scale);
  __syncthreads();

  // res and skip-0 share the gate outputs: h1 = (h0 + res)*sqrt(.5) in
  // place over H (each thread owns its element), skip-0 -> S
  {
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
        mm2_i8(ri, si, static_cast<const int8_t*>(s.G), R, rows, 1, 0, R / 4,
               static_cast<const int*>(f.res_w) + n,
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
        mm2(ra, sa, G, R, rows, 1, 0, R, static_cast<const T*>(f.res_w) + n,
            static_cast<const T*>(f.skip_w) + n, R);
      }
      const float rbias = f.res_b[n], sbias = f.skip_b[n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int j = r_ + i;
        if (j >= re) continue;
        const float h0 = to_f(H[(size_t)j * R + n]);
        // the Pallas kernels add the res bias at different points
        const float h1 = P ? rnd<T>(((h0 + ra[i]) + rbias) * SQRT_HALF)
                           : rnd<T>((h0 + (ra[i] + rbias)) * SQRT_HALF);
        H[(size_t)j * R + n] = from_f<T>(valid(j) ? h1 : 0.f);
        if (j >= o0 && j < o1) s.S[(size_t)(j - o0) * R + n] = sa[i] + sbias;
      }
    }
  }
  __syncthreads();
  if constexpr (I8)
    a_scale = quantize_rows(H, s.Q, o0 - EG0, o1 + EG0, R, s.red);

  // layer 1 (d=3) over [o0, o1): gated -> G
  if constexpr (P)
    wino_layer<T, COND, P>(p, f, s, 1, o0, o1, 3, cglob, b, win0, c_scale);
  else
    direct_layer<T, I8, COND, RS>(p, f, s, 1, o0, o1, 3, a_scale, cglob, b,
                                  win0, c_scale);
  __syncthreads();

  // skip-1, relu(skip0 + skip1) rounded -> H
  {
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
        mm1_i8(ai, static_cast<const int8_t*>(s.G), R, rows, R / 4,
               static_cast<const int*>(f.skip_w) + (size_t)(R / 4) * R + n,
               R);
        const float sc = f.skip_s[R + n] * (1.f / 127.f);
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i] = (float)ai[i] * sc;
      } else {
        mm1(acc, G, R, rows, R,
            static_cast<const T*>(f.skip_w) + (size_t)R * R + n, R);
      }
      const float bias = f.skip_b[R + n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int j = r_ + i;
        if (j >= o1) continue;
        const float s0 = s.S[(size_t)(j - o0) * R + n];
        const float sk = P ? (s0 + acc[i]) + bias : s0 + (acc[i] + bias);
        H[(size_t)j * R + n] = from_f<T>(rnd<T>(fmaxf(sk, 0.f)));
      }
    }
  }
  __syncthreads();

  // final 1x1: relu(out @ fin_w + b) rounded -> G
  {
    const T* Wf = static_cast<const T*>(f.fin_w);
    FOR_ROW_CHUNKS(o0, o1) {
      int rows[RM];
      float acc[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        rows[i] = min(r_ + i, o1 - 1);
        acc[i] = 0.f;
      }
      mm1(acc, H, R, rows, R, Wf + n, R);
      const float bias = f.fin_b[n];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        if (r_ + i < o1)
          G[(size_t)(r_ + i) * R + n] =
              from_f<T>(rnd<T>(fmaxf(acc[i] + bias, 0.f)));
    }
  }
  __syncthreads();

  // zero conv (fp32 out): net[j - o0][ch] for ch < 2Rin
  {
    const int R2in = 2 * Rin, rows = o1 - o0;
    const T* Wz = static_cast<const T*>(f.zw);
    for (int idx = threadIdx.x; idx < rows * R2in; idx += NT) {
      const int j = o0 + idx / R2in, ch = idx % R2in;
      float acc = 0.f;
      for (int c = 0; c < R; ++c)
        acc = fmaf(to_f(G[(size_t)j * R + c]), to_f(Wz[c * R2in + ch]), acc);
      s.net[idx] = acc + f.zb[ch];
    }
  }
  __syncthreads();
}

template <typename T, bool I8, int COND, bool RS, int P>
__global__ void __launch_bounds__(NT) pair_reverse_kernel(Params p) {
  using Gm = Geo<P>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TT = p.TT, L = TT + 2 * Gm::HALO, Rin = p.Rin;
  size_t off[11];
  smem_layout(sizeof(T), I8, p.R, Rin, L, L - 2 * Gm::O1, off);
  Smem s;
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
    U[idx] = valid(j) ? ug[g] : from_f<T>(0.f);
    V[idx] = valid(j) ? vg[g] : from_f<T>(0.f);
  }
  __syncthreads();

  const float cs_a = COND == COND_I8 ? p.crs[2 * b] : 0.f;
  const float cs_b = COND == COND_I8 ? p.crs[2 * b + 1] : 0.f;

  // odd flow: u' = u*exp(log_s(v)) + t(v) over rows [O1, L-O1), then the
  // odd ActNorm (v half 0, u half 1); u' rounded and re-masked
  coupling_net<T, I8, COND, RS, P>(p, p.flow[1], s, V, Gm::O1, L - Gm::O1,
                                   p.cb, cs_b, b, win0);
  {
    const float* as = p.an_s + 2 * Rin;   // flow 1
    const float* ab = p.an_b + 2 * Rin;
    for (int idx = threadIdx.x; idx < (L - 2 * Gm::O1) * Rin; idx += NT) {
      const int j = Gm::O1 + idx / Rin, ch = idx % Rin;
      const float* net = s.net + (size_t)(j - Gm::O1) * 2 * Rin;
      float um = to_f(U[j * Rin + ch]) * expf(net[ch]) + net[Rin + ch];
      s.VA[j * Rin + ch] = to_f(V[j * Rin + ch]) * as[ch] - ab[ch];
      um = rnd<T>(um * as[Rin + ch] - ab[Rin + ch]);
      UM[j * Rin + ch] = from_f<T>(valid(j) ? um : 0.f);
    }
  }
  __syncthreads();

  // even flow: v' = v*exp(log_s(u')) + t(u') over rows [O2, L-O2) (the
  // tile), then the even ActNorm (u half 0, v half 1); store rows in [0, T)
  coupling_net<T, I8, COND, RS, P>(p, p.flow[0], s, UM, Gm::O2, L - Gm::O2,
                                   p.ca, cs_a, b, win0);
  {
    T* uo = static_cast<T*>(p.u_out) + (size_t)b * p.T * Rin;
    T* vo = static_cast<T*>(p.v_out) + (size_t)b * p.T * Rin;
    for (int idx = threadIdx.x; idx < TT * Rin; idx += NT) {
      const int j = Gm::O2 + idx / Rin, ch = idx % Rin;
      if (!valid(j)) continue;
      const float* net = s.net + (size_t)(j - Gm::O2) * 2 * Rin;
      const float vn = s.VA[j * Rin + ch] * expf(net[ch]) + net[Rin + ch];
      const float uf = to_f(UM[j * Rin + ch]) * p.an_s[ch] - p.an_b[ch];
      const float vf = vn * p.an_s[Rin + ch] - p.an_b[Rin + ch];
      const size_t g = (size_t)(win0 + j) * Rin + ch;
      uo[g] = from_f<T>(uf);
      vo[g] = from_f<T>(vf);
    }
  }
}

template <typename T, bool I8, int COND, bool RS, int P>
int launch(Params p, cudaStream_t stream) {
  const int smem = (int)smem_bytes<P>(sizeof(T), I8, p.R, p.Rin, p.TT);
  cudaError_t e = cudaFuncSetAttribute(
      pair_reverse_kernel<T, I8, COND, RS, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  pair_reverse_kernel<T, I8, COND, RS, P>
      <<<p.B * p.n_t, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Fills p from ptrs = u, v, c_a, c_b, u_out, v_out, then 19 operand slots
// (front_w, front_b, kfg, cond_w, cond_b, res_w, res_b, skip_w, skip_b,
// fin_w, fin_b, zw, zb, an_s, an_b, kfg_scale, cond_scale, res_scale,
// skip_scale; null where the variant has none), then c_row_scales; each
// operand stacks the two flows on its leading axis.  dims: B, T, Rin, R,
// Cc, TT.  K: filter|gate taps per layer; es: storage bytes; i8 / rs:
// int8 fg convs and cond / res-skip weights (1 byte per element).
inline Params make_params(const void* const* ptrs, const int* dims, int K,
                          size_t es, bool i8, bool rs) {
  Params p;
  p.B = dims[0]; p.T = dims[1]; p.Rin = dims[2]; p.R = dims[3];
  p.Cc = dims[4]; p.TT = dims[5];
  p.n_t = (p.T + p.TT - 1) / p.TT;
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
    f.cond_w = vptr(3, fl * 2 * Cc * R2 * wes);
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
