// Fused reverse flow PAIR for Hopper (sm_90a): the CUDA port of the Pallas
// TPU kernels flowavenet_tpu/ops/pallas_flow.py:_pair_kernel (storage-dtype
// convs) and :_pair_kernel_i8 (filter|gate convs and conditioning 1x1s on
// int8 operands with int32 accumulation).  One launch applies
//
//     u <- u * exp(log_s(v; odd)) + t(v; odd)       coupling (odd flow)
//     v <- v * sA - bA ; u <- u * sB - bB           ActNorm reverse (odd)
//     v <- v * exp(log_s(u; even)) + t(u; even)     coupling (even flow)
//     u <- u * sC - bC ; v <- v * sD - bD           ActNorm reverse (even)
//
// where each (log_s, t) is a full WaveNet coupling net: k=3 front conv ->
// relu -> gated layers at dilations 1 and 3 with conditioning 1x1s ->
// res/skip -> relu -> 1x1 -> relu -> zero conv.  Weight norm, exp(3*scale)
// and the ActNorm exp(-3*logs) are folded outside the kernel
// (ops/pair_flow.py pair_reverse_operands[_int8]).
//
// What bounds it on this card: arithmetic.  Per output row a pair costs
// ~4.2 MFLOP + 4096*Cc + 5120*R_in against (8*R_in + 4*Cc) bytes of u, v,
// u', v' and c in bf16, i.e. >1000 FLOP per byte, far right of the H100's
// ~295 FLOP/byte ridge.
// The design therefore keeps every intermediate in shared memory: one CTA
// owns (batch row, time tile of TT rows) plus a 10-row halo per side (the
// pair's receptive field), reads u, v and its c rows once, and writes u', v'
// once.  Each filter column is computed together with its gate column so
// the [L, 2R] fp32 pre-activation is never stored.  Weights (~2.6 MB per
// flow at block 4 in int8) stay in global memory and are served from L2.
// This first version runs on CUDA-core FMAs (and __dp4a for int8), not on
// the tensor cores: wgmma/TMA pipelining is later work.
//
// Numerics mirror the Pallas kernel: fp32 accumulation and gates; h0, h1,
// the gate outputs, the relu'd skip sum and the final 1x1 output are
// rounded to the storage type; the zero conv comes out in fp32; int8
// activation scales are per-buffer max-abs over exactly the rows the buffer
// covers (h0 over [-4, out+4), h1 over [-3, out+3) of the net's region),
// and the conditioning arrives pre-quantized per batch row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALO = 10;     // rows per side: receptive field of one pair
constexpr int NT = 512;      // threads per CTA
constexpr int RM = 8;        // rows per register tile
constexpr float SQRT_HALF = 0.7071067811865476f;

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

struct Flow {              // one flow's folded operands
  const void* front_w;     // [3][Rin][R]
  const float* front_b;    // [R]
  const void* kfg;         // [2][3][R][2R], int8: int32 words [2][3][R/4][2R]
  const void* cond_w;      // [2][Cc][2R],   int8: int32 words [2][Cc/4][2R]
  const float* cond_b;     // [2][2R]
  const void* res_w;       // [R][R]
  const float* res_b;      // [R]
  const void* skip_w;      // [2][R][R]
  const float* skip_b;     // [2][R]
  const void* fin_w;       // [R][R]
  const float* fin_b;      // [R]
  const void* zw;          // [R][2Rin]
  const float* zb;         // [2Rin]
  const float* kfg_s;      // [2][2R]  per-out-channel weight scales (int8)
  const float* cond_s;     // [2][2R]
};

struct Params {
  const void* u;           // [B][T][Rin]
  const void* v;
  const void* ca;          // [B][T][Cc] storage type, or int8
  const void* cb;
  void* u_out;
  void* v_out;
  Flow flow[2];            // 0 = even, 1 = odd
  const float* an_s;       // [2 flow][2 half][Rin]
  const float* an_b;
  const float* crs;        // [B][2] per-row c scales (int8), else null
  int B, T, Rin, R, Cc, TT, n_t;
};

struct Smem {
  float* S;     // [(TT+10)][R] fp32 skip-0 accumulator
  float* net;   // [(TT+10)][2Rin] zero-conv output
  float* VA;    // [L][Rin] v after the odd ActNorm (fp32)
  float* red;   // [32] reduction scratch
  void* H;      // [L][R] h0 -> h1 -> relu'd skip sum
  void* G;      // [L][R] gate outputs -> final 1x1 output
  void* U;      // [L][Rin] window of u
  void* V;      // [L][Rin] window of v
  void* UM;     // [L][Rin] u after the odd coupling and ActNorm
  int8_t* Q;    // [L][R] int8 codes of h0 / h1
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Byte offsets of the Smem regions; the last entry is the total size.
__host__ __device__ inline void smem_layout(int es, bool i8, int R, int Rin,
                                            int TT, size_t off[11]) {
  const size_t L = TT + 2 * HALO;
  size_t o = 0;
  off[0] = o; o = align16(o + sizeof(float) * (TT + 10) * R);
  off[1] = o; o = align16(o + sizeof(float) * (TT + 10) * 2 * Rin);
  off[2] = o; o = align16(o + sizeof(float) * L * Rin);
  off[3] = o; o = align16(o + sizeof(float) * 32);
  off[4] = o; o = align16(o + es * L * R);
  off[5] = o; o = align16(o + es * L * R);
  off[6] = o; o = align16(o + es * L * Rin);
  off[7] = o; o = align16(o + es * L * Rin);
  off[8] = o; o = align16(o + es * L * Rin);
  off[9] = o; o = align16(o + (i8 ? L * R : 0));
  off[10] = o;
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
        const float a = to_f(A[(rows[i] + k * dil) * lda + c]);
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
      a0[i] = fmaf(to_f(A[rows[i] * lda + c]), w0, a0[i]);
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

// Filter|gate pre-activations over rows of the chunk at dilation dil:
// conv over the storage (or int8) buffer plus conditioning plus bias, in
// the JAX order ((conv + cond) + bias), then the gate.
template <typename T, bool I8>
__device__ __forceinline__ void gated_chunk(
    const Params& p, const Flow& f, const Smem& s, int layer, int r0,
    int r_end, int dil, int n, float a_scale, const void* cglob, int b,
    int win0, float c_scale, float (&out)[RM]) {
  const int R = p.R, R2 = 2 * R, Cc = p.Cc;
  int rows[RM], crow[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = min(r0 + i, r_end - 1);
    rows[i] = r - dil;
    // c rows outside [0, T) only feed rows that are masked or never
    // stored, so clamping them into the sequence leaves every output exact
    crow[i] = min(max(win0 + r, 0), p.T - 1);
  }
  float ff[RM], gg[RM];
  if constexpr (I8) {
    int fi[RM], gi[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) fi[i] = gi[i] = 0;
    const int* W = static_cast<const int*>(f.kfg) + (size_t)layer * 3 *
                   (R / 4) * R2;
    mm2_i8(fi, gi, s.Q, R, rows, 3, dil, R / 4, W + n, W + R + n, R2);
    const float sf = a_scale * f.kfg_s[layer * R2 + n];
    const float sg = a_scale * f.kfg_s[layer * R2 + R + n];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      ff[i] = (float)fi[i] * sf;
      gg[i] = (float)gi[i] * sg;
      fi[i] = gi[i] = 0;
    }
    // conditioning: int8 rows of c (pre-quantized per batch row)
    const int* Wc = static_cast<const int*>(f.cond_w) + (size_t)layer *
                    (Cc / 4) * R2;
    const int8_t* C = static_cast<const int8_t*>(cglob) + (size_t)b * p.T *
                      Cc;
#pragma unroll 2
    for (int c = 0; c < Cc / 4; ++c) {
      const int w0 = Wc[(size_t)c * R2 + n];
      const int w1 = Wc[(size_t)c * R2 + R + n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int a = *reinterpret_cast<const int*>(
            C + (size_t)crow[i] * Cc + 4 * c);
        fi[i] = __dp4a(a, w0, fi[i]);
        gi[i] = __dp4a(a, w1, gi[i]);
      }
    }
    const float cf = c_scale * f.cond_s[layer * R2 + n];
    const float cg = c_scale * f.cond_s[layer * R2 + R + n];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      ff[i] += (float)fi[i] * cf;
      gg[i] += (float)gi[i] * cg;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i) ff[i] = gg[i] = 0.f;
    const T* W = static_cast<const T*>(f.kfg) + (size_t)layer * 3 * R * R2;
    mm2(ff, gg, static_cast<const T*>(s.H), R, rows, 3, dil, R, W + n,
        W + R + n, R2);
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
  const float bf = f.cond_b[layer * R2 + n];
  const float bg = f.cond_b[layer * R2 + R + n];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float fv = ff[i] + bf, gv = gg[i] + bg;
    out[i] = rnd<T>(tanhf(fv) * (1.f / (1.f + expf(-gv))));
  }
}

// One WaveNet coupling net over window rows [o0, o1): input X (shared,
// rows [o0-5, o1+5) valid), conditioning rows from global.  Leaves the
// zero-conv output (log_s || t) for rows [o0, o1) in s.net.
template <typename T, bool I8>
__device__ void coupling_net(const Params& p, const Flow& f, const Smem& s,
                             const T* X, int o0, int o1, const void* cglob,
                             float c_scale, int b, int win0) {
  const int R = p.R, Rin = p.Rin;
  const int ngrp = NT / R, grp = threadIdx.x / R, n = threadIdx.x % R;
  T* H = static_cast<T*>(s.H);
  T* G = static_cast<T*>(s.G);
  auto valid = [&](int j) {
    const int pos = win0 + j;
    return pos >= 0 && pos < p.T;
  };

  // h0 = relu(front(X) + b) over [o0-4, o1+4), rounded, masked
  {
    const int rb = o0 - 4, re = o1 + 4;
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
          H[j * R + n] = from_f<T>(
              valid(j) ? rnd<T>(fmaxf(acc[i] + bias, 0.f)) : 0.f);
      }
    }
  }
  __syncthreads();
  float a_scale = 0.f;
  if constexpr (I8) a_scale = quantize_rows(H, s.Q, o0 - 4, o1 + 4, R, s.red);

  // layer 0 (d=1) over [o0-3, o1+3): gated -> G
  FOR_ROW_CHUNKS(o0 - 3, o1 + 3) {
    float g[RM];
    gated_chunk<T, I8>(p, f, s, 0, r_, o1 + 3, 1, n, a_scale, cglob, b,
                       win0, c_scale, g);
#pragma unroll
    for (int i = 0; i < RM; ++i)
      if (r_ + i < o1 + 3) G[(r_ + i) * R + n] = from_f<T>(g[i]);
  }
  __syncthreads();

  // res and skip-0 share the gate outputs: h1 = (h0 + res)*sqrt(.5) in
  // place over H (each thread owns its element), skip-0 -> S
  {
    const T* Wr = static_cast<const T*>(f.res_w);
    const T* Ws = static_cast<const T*>(f.skip_w);
    const int rb = o0 - 3, re = o1 + 3;
    FOR_ROW_CHUNKS(rb, re) {
      int rows[RM];
      float ra[RM], sa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        rows[i] = min(r_ + i, re - 1);
        ra[i] = sa[i] = 0.f;
      }
      mm2(ra, sa, G, R, rows, 1, 0, R, Wr + n, Ws + n, R);
      const float rbias = f.res_b[n], sbias = f.skip_b[n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int j = r_ + i;
        if (j >= re) continue;
        const float h1 = rnd<T>((to_f(H[j * R + n]) + (ra[i] + rbias)) *
                                SQRT_HALF);
        H[j * R + n] = from_f<T>(valid(j) ? h1 : 0.f);
        if (j >= o0 && j < o1) s.S[(j - o0) * R + n] = sa[i] + sbias;
      }
    }
  }
  __syncthreads();
  if constexpr (I8) a_scale = quantize_rows(H, s.Q, o0 - 3, o1 + 3, R, s.red);

  // layer 1 (d=3) over [o0, o1): gated -> G
  FOR_ROW_CHUNKS(o0, o1) {
    float g[RM];
    gated_chunk<T, I8>(p, f, s, 1, r_, o1, 3, n, a_scale, cglob, b, win0,
                       c_scale, g);
#pragma unroll
    for (int i = 0; i < RM; ++i)
      if (r_ + i < o1) G[(r_ + i) * R + n] = from_f<T>(g[i]);
  }
  __syncthreads();

  // skip-1, relu(skip0 + skip1) rounded -> H
  {
    const T* Ws = static_cast<const T*>(f.skip_w) + (size_t)R * R;
    FOR_ROW_CHUNKS(o0, o1) {
      int rows[RM];
      float acc[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        rows[i] = min(r_ + i, o1 - 1);
        acc[i] = 0.f;
      }
      mm1(acc, G, R, rows, R, Ws + n, R);
      const float bias = f.skip_b[R + n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int j = r_ + i;
        if (j < o1)
          H[j * R + n] = from_f<T>(
              rnd<T>(fmaxf(s.S[(j - o0) * R + n] + (acc[i] + bias), 0.f)));
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
          G[(r_ + i) * R + n] = from_f<T>(rnd<T>(fmaxf(acc[i] + bias, 0.f)));
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
        acc = fmaf(to_f(G[j * R + c]), to_f(Wz[c * R2in + ch]), acc);
      s.net[idx] = acc + f.zb[ch];
    }
  }
  __syncthreads();
}

template <typename T, bool I8>
__global__ void __launch_bounds__(NT) pair_reverse_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TT = p.TT, L = TT + 2 * HALO, Rin = p.Rin;
  size_t off[11];
  smem_layout(sizeof(T), I8, p.R, Rin, TT, off);
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
  const int win0 = tile * TT - HALO;   // global position of window row 0
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

  const float cs_a = I8 ? p.crs[2 * b] : 0.f;
  const float cs_b = I8 ? p.crs[2 * b + 1] : 0.f;

  // odd flow: u' = u*exp(log_s(v)) + t(v) over rows [5, L-5), then the
  // odd ActNorm (v half 0, u half 1); u' rounded and re-masked
  coupling_net<T, I8>(p, p.flow[1], s, V, 5, L - 5, p.cb, cs_b, b, win0);
  {
    const float* as = p.an_s + 2 * Rin;   // flow 1
    const float* ab = p.an_b + 2 * Rin;
    for (int idx = threadIdx.x; idx < (L - 10) * Rin; idx += NT) {
      const int j = 5 + idx / Rin, ch = idx % Rin;
      const float* net = s.net + (j - 5) * 2 * Rin;
      float um = to_f(U[j * Rin + ch]) * expf(net[ch]) + net[Rin + ch];
      s.VA[j * Rin + ch] = to_f(V[j * Rin + ch]) * as[ch] - ab[ch];
      um = rnd<T>(um * as[Rin + ch] - ab[Rin + ch]);
      UM[j * Rin + ch] = from_f<T>(valid(j) ? um : 0.f);
    }
  }
  __syncthreads();

  // even flow: v' = v*exp(log_s(u')) + t(u') over rows [10, L-10), then
  // the even ActNorm (u half 0, v half 1); store rows inside [0, T)
  coupling_net<T, I8>(p, p.flow[0], s, UM, 10, L - 10, p.ca, cs_a, b, win0);
  {
    T* uo = static_cast<T*>(p.u_out) + (size_t)b * p.T * Rin;
    T* vo = static_cast<T*>(p.v_out) + (size_t)b * p.T * Rin;
    for (int idx = threadIdx.x; idx < TT * Rin; idx += NT) {
      const int j = HALO + idx / Rin, ch = idx % Rin;
      if (!valid(j)) continue;
      const float* net = s.net + (j - 10) * 2 * Rin;
      const float vn = s.VA[j * Rin + ch] * expf(net[ch]) + net[Rin + ch];
      const float uf = to_f(UM[j * Rin + ch]) * p.an_s[ch] - p.an_b[ch];
      const float vf = vn * p.an_s[Rin + ch] - p.an_b[Rin + ch];
      const size_t g = (size_t)(win0 + j) * Rin + ch;
      uo[g] = from_f<T>(uf);
      vo[g] = from_f<T>(vf);
    }
  }
}

template <typename T, bool I8>
int launch(Params p, cudaStream_t stream) {
  size_t off[11];
  smem_layout(sizeof(T), I8, p.R, p.Rin, p.TT, off);
  const int smem = (int)off[10];
  cudaError_t e = cudaFuncSetAttribute(
      pair_reverse_kernel<T, I8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  pair_reverse_kernel<T, I8><<<p.B * p.n_t, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs (bytes).  dtype: 0 fp32, 1 bf16.
int pair_reverse_smem_bytes(int dtype, int int8, int R, int Rin, int TT) {
  size_t off[11];
  smem_layout(dtype == 0 ? 4 : 2, int8 != 0, R, Rin, TT, off);
  return (int)off[10];
}

int pair_reverse_threads() { return NT; }

// ptrs: u, v, c_a, c_b, u_out, v_out, then the 17 operands of
// pair_reverse_operands_int8 (the first 15 without int8): front_w, front_b,
// kfg, cond_w, cond_b, res_w, res_b, skip_w, skip_b, fin_w, fin_b, zw, zb,
// an_s, an_b, kfg_scale, cond_scale; then c_row_scales.  Each operand
// stacks the two flows on its leading axis.  dims: B, T, Rin, R, Cc, TT.
// Returns the cudaError_t of the launch (0 = success).
int pair_reverse_launch(int dtype, int int8, const void* const* ptrs,
                        const int* dims, void* stream) {
  Params p;
  p.B = dims[0]; p.T = dims[1]; p.Rin = dims[2]; p.R = dims[3];
  p.Cc = dims[4]; p.TT = dims[5];
  p.n_t = (p.T + p.TT - 1) / p.TT;
  p.u = ptrs[0]; p.v = ptrs[1]; p.ca = ptrs[2]; p.cb = ptrs[3];
  p.u_out = const_cast<void*>(ptrs[4]);
  p.v_out = const_cast<void*>(ptrs[5]);
  const size_t es = dtype == 0 ? 4 : 2;
  const size_t R = p.R, Rin = p.Rin, Cc = p.Cc, R2 = 2 * R;
  // per-flow strides in bytes; int8 weights are 1 byte per element
  const size_t wes = int8 ? 1 : es;
  const char* base[17];
  for (int i = 0; i < 17; ++i)
    base[i] = static_cast<const char*>(ptrs[6 + i]);
  for (int fl = 0; fl < 2; ++fl) {
    Flow& f = p.flow[fl];
    f.front_w = base[0] + fl * 3 * Rin * R * es;
    f.front_b = reinterpret_cast<const float*>(base[1]) + fl * R;
    f.kfg = base[2] + fl * 2 * 3 * R * R2 * wes;
    f.cond_w = base[3] + fl * 2 * Cc * R2 * wes;
    f.cond_b = reinterpret_cast<const float*>(base[4]) + fl * 2 * R2;
    f.res_w = base[5] + fl * R * R * es;
    f.res_b = reinterpret_cast<const float*>(base[6]) + fl * R;
    f.skip_w = base[7] + fl * 2 * R * R * es;
    f.skip_b = reinterpret_cast<const float*>(base[8]) + fl * 2 * R;
    f.fin_w = base[9] + fl * R * R * es;
    f.fin_b = reinterpret_cast<const float*>(base[10]) + fl * R;
    f.zw = base[11] + fl * R * 2 * Rin * es;
    f.zb = reinterpret_cast<const float*>(base[12]) + fl * 2 * Rin;
    f.kfg_s = int8 ? reinterpret_cast<const float*>(base[15]) + fl * 2 * R2
                   : nullptr;
    f.cond_s = int8 ? reinterpret_cast<const float*>(base[16]) + fl * 2 * R2
                    : nullptr;
  }
  p.an_s = reinterpret_cast<const float*>(base[13]);
  p.an_b = reinterpret_cast<const float*>(base[14]);
  p.crs = static_cast<const float*>(ptrs[23]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int8 ? launch<float, true>(p, st) : launch<float, false>(p, st);
  return int8 ? launch<__nv_bfloat16, true>(p, st)
              : launch<__nv_bfloat16, false>(p, st);
}

}  // extern "C"
