// Fused gated ResBlock for Hopper (sm_90a): the CUDA ports of the Pallas
// TPU kernels in flowavenet_tpu/ops/pallas_resblock.py
//   _resblock_kernel     (resblock, v2 = 0): takes the conditioning
//                        pre-activations cond_fg [B, T, 2R] (c's 1x1, the
//                        g term and both biases, summed outside);
//   _resblock_kernel_v2  (resblock_v2, v2 = 1): takes the raw half
//                        conditioning c [B, T, Cc] and its weights
//                        w_cond [Cc, 2R] and computes c @ w_cond here.
// One launch computes, for every row t of h [B, T, R],
//
//     fg       = cond(t) + sum_k hpad[t + k*d] @ w_conv[k]     (fp32)
//     gated    = tanh(fg[:R]) * sigmoid(fg[R:])   rounded to the storage type
//     h_new(t) = (h(t) + gated @ w_res + b_res) * sqrt(1/2)
//     skip(t)  = gated @ w_skip + b_skip
//
// where hpad is h with d zero rows on each side (non-causal) or 2d on the
// left (causal), so the three taps read rows t-d, t, t+d or t-2d, t-d, t.
// Weights are in the storage type (fp32 or bf16), biases fp32.
//
// What bounds it on this card: arithmetic.  Per row it does 2R(6R + R + S)
// operations (plus 4*Cc*R for v2) against ~6R bytes of h, cond, h_new and
// skip in bf16 (v2 reads 2*Cc bytes of c instead of 4R of cond), i.e.
// hundreds of operations per byte, right of the ~295 FLOP/byte ridge.  So
// the design keeps the tile's intermediates on chip: one CTA owns (batch
// row, time tile of TT rows); it stages the tile's h window (TT + 2d rows,
// zero outside [0, T)) in shared memory, accumulates each row's filter and
// gate pre-activations of one channel in the same thread (pf::mm2, the
// pair kernels' CUDA-core product), writes the gate outputs to shared
// memory once, and runs both 1x1s from there, so h is read once and fg
// never leaves the SM.  v2 stages c through shared memory in chunks of CK
// channels per CH rows (Cc reaches 2560 at lj22k block 5), all threads
// stepping through the chunks together.  Weights stay in global memory,
// served from L2.  CUDA-core FMAs, not the tensor cores: wgmma is later
// work.

#include "pair_flow_common.cuh"

namespace {

using pf::NT;
using pf::RM;

struct RbParams {
  const void* h;        // [B][T][R]
  const void* cond;     // v1: cond_fg [B][T][2R]; v2: c [B][T][Cc]
  const void* w_conv;   // [3][R][2R]
  const void* w_cond;   // v2: [Cc][2R]
  const float* b_all;   // v2: [2R]
  const void* w_res;    // [R][R]
  const float* b_res;   // [R]
  const void* w_skip;   // [R][R] (S == R)
  const float* b_skip;  // [R]
  void* h_new;          // [B][T][R]
  void* skip;           // [B][T][R]
  int B, T, R, Cc, TT, n_t, dil, lead, CK;
};

// Rows one pass of the CTA covers: NT / R thread groups of RM rows.
inline int rows_per_pass(int R) { return (NT / R) * RM; }

// v2's c chunk: CK channels of rows_per_pass rows in at most 32 KB.
inline int c_chunk(int es, int R, int Cc) {
  int ck = (32768 / (rows_per_pass(R) * es)) & ~3;
  if (ck < 4) ck = 4;
  return ck < Cc ? ck : Cc;
}

// Shared memory: the h window [TT + 2d][R], the gate outputs [TT][R] and
// (v2) the c chunk [CH][CK], in the storage type.
inline size_t smem_bytes(int es, bool v2, int R, int Cc, int TT, int dil) {
  size_t o = pf::align16((size_t)es * (TT + 2 * dil) * R);
  o += pf::align16((size_t)es * TT * R);
  if (v2) o += pf::align16((size_t)es * rows_per_pass(R) * c_chunk(es, R, Cc));
  return o;
}

template <typename T, bool V2>
__global__ void __launch_bounds__(NT) resblock_kernel(RbParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = p.R, R2 = 2 * R, TT = p.TT, d = p.dil;
  const int W = TT + 2 * d;                    // window rows
  const int ngrp = NT / R, grp = threadIdx.x / R, n = threadIdx.x % R;
  const int CH = ngrp * RM;
  T* H = reinterpret_cast<T*>(smem_raw);
  T* G = reinterpret_cast<T*>(smem_raw + pf::align16(sizeof(T) * W * R));
  T* Cs = reinterpret_cast<T*>(smem_raw + pf::align16(sizeof(T) * W * R) +
                               pf::align16(sizeof(T) * TT * R));
  const int b = blockIdx.x / p.n_t, tile = blockIdx.x % p.n_t;
  const int t0 = tile * TT;                    // global row of output row 0
  const int w0 = t0 - p.lead;                  // global row of window row 0

  // the h window; rows outside [0, T) are the zero padding
  const T* hg = static_cast<const T*>(p.h) + (size_t)b * p.T * R;
  for (int idx = threadIdx.x; idx < W * R; idx += NT) {
    const int pos = w0 + idx / R;
    H[idx] = (pos >= 0 && pos < p.T) ? hg[(size_t)pos * R + idx % R]
                                     : pf::from_f<T>(0.f);
  }
  __syncthreads();

  // filter|gate pre-activations and the gate, CH rows per pass: this
  // thread's RM rows, filter column n and gate column n.  Rows past the
  // tile or the sequence are clamped for reading and never stored.
  const T* Wk = static_cast<const T*>(p.w_conv);
  for (int r0 = 0; r0 < TT; r0 += CH) {
    int rows[RM], grow[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      rows[i] = min(r0 + grp * RM + i, TT - 1);
      grow[i] = min(t0 + rows[i], p.T - 1);
    }
    float ff[RM], gg[RM];
    if constexpr (V2) {
#pragma unroll
      for (int i = 0; i < RM; ++i) ff[i] = gg[i] = 0.f;
      const T* cg = static_cast<const T*>(p.cond) + (size_t)b * p.T * p.Cc;
      const T* Wc = static_cast<const T*>(p.w_cond);
      int lrows[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) lrows[i] = grp * RM + i;
      for (int c0 = 0; c0 < p.Cc; c0 += p.CK) {
        const int ck = min(p.CK, p.Cc - c0);
        __syncthreads();                       // the last chunk is consumed
        for (int idx = threadIdx.x; idx < CH * ck; idx += NT) {
          const int i = idx / ck;
          const int gr = min(t0 + min(r0 + i, TT - 1), p.T - 1);
          Cs[idx] = cg[(size_t)gr * p.Cc + c0 + idx % ck];
        }
        __syncthreads();
        pf::mm2(ff, gg, Cs, ck, lrows, 1, 0, ck, Wc + (size_t)c0 * R2 + n,
                Wc + (size_t)c0 * R2 + R + n, R2);
      }
      const float bf = p.b_all[n], bg = p.b_all[R + n];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        ff[i] += bf;
        gg[i] += bg;
      }
    } else {
      const T* cf = static_cast<const T*>(p.cond) + (size_t)b * p.T * R2;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        ff[i] = pf::to_f(cf[(size_t)grow[i] * R2 + n]);
        gg[i] = pf::to_f(cf[(size_t)grow[i] * R2 + R + n]);
      }
    }
    // taps k = 0, 1, 2 of output row r are window rows r, r + d, r + 2d
    pf::mm2(ff, gg, H, R, rows, 3, d, R, Wk + n, Wk + R + n, R2);
#pragma unroll
    for (int i = 0; i < RM; ++i)
      if (r0 + grp * RM + i < TT)
        G[(size_t)rows[i] * R + n] = pf::from_f<T>(
            tanhf(ff[i]) * (1.f / (1.f + expf(-gg[i]))));
  }
  __syncthreads();

  // res and skip share the gate outputs; h_new = (h + res) * sqrt(1/2)
  T* hn = static_cast<T*>(p.h_new) + (size_t)b * p.T * R;
  T* sk = static_cast<T*>(p.skip) + (size_t)b * p.T * R;
  const float br = p.b_res[n], bs = p.b_skip[n];
  for (int r0 = 0; r0 < TT; r0 += CH) {
    int rows[RM];
    float ra[RM], sa[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      rows[i] = min(r0 + grp * RM + i, TT - 1);
      ra[i] = sa[i] = 0.f;
    }
    pf::mm2(ra, sa, G, R, rows, 1, 0, R, static_cast<const T*>(p.w_res) + n,
            static_cast<const T*>(p.w_skip) + n, R);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = r0 + grp * RM + i, t = t0 + r;
      if (r >= TT || t >= p.T) continue;
      const float h = pf::to_f(H[(size_t)(r + p.lead) * R + n]);
      hn[(size_t)t * R + n] = pf::from_f<T>((h + (ra[i] + br)) *
                                            pf::SQRT_HALF);
      sk[(size_t)t * R + n] = pf::from_f<T>(sa[i] + bs);
    }
  }
}

template <typename T, bool V2>
int launch(const RbParams& p, cudaStream_t stream) {
  const int smem = (int)smem_bytes(sizeof(T), V2, p.R, p.Cc, p.TT, p.dil);
  cudaError_t e = cudaFuncSetAttribute(
      resblock_kernel<T, V2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  resblock_kernel<T, V2><<<p.B * p.n_t, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int resblock_threads() { return NT; }

// Dynamic shared memory one CTA needs (bytes).  dtype: 0 fp32, 1 bf16.
int resblock_smem_bytes(int dtype, int v2, int R, int Cc, int TT, int dil) {
  return (int)smem_bytes(dtype == 0 ? 4 : 2, v2 != 0, R, Cc, TT, dil);
}

// ptrs: h, cond (v1 cond_fg / v2 c), w_conv, w_cond, b_all, w_res, b_res,
// w_skip, b_skip, h_new, skip (w_cond and b_all null for v1); dims: B, T,
// R, Cc (v2), TT, dilation, lead (d, or 2d when causal).  Returns the
// cudaError_t of the launch (0 = success).
int resblock_launch(int dtype, int v2, const void* const* ptrs,
                    const int* dims, void* stream) {
  RbParams p;
  p.h = ptrs[0];
  p.cond = ptrs[1];
  p.w_conv = ptrs[2];
  p.w_cond = ptrs[3];
  p.b_all = static_cast<const float*>(ptrs[4]);
  p.w_res = ptrs[5];
  p.b_res = static_cast<const float*>(ptrs[6]);
  p.w_skip = ptrs[7];
  p.b_skip = static_cast<const float*>(ptrs[8]);
  p.h_new = const_cast<void*>(ptrs[9]);
  p.skip = const_cast<void*>(ptrs[10]);
  p.B = dims[0]; p.T = dims[1]; p.R = dims[2]; p.Cc = dims[3];
  p.TT = dims[4]; p.dil = dims[5]; p.lead = dims[6];
  if (p.R <= 0 || NT % p.R || p.TT <= 0 || p.T <= 0 || p.dil <= 0 ||
      (v2 && p.Cc <= 0))
    return (int)cudaErrorInvalidValue;
  p.n_t = (p.T + p.TT - 1) / p.TT;
  p.CK = v2 ? c_chunk(dtype == 0 ? 4 : 2, p.R, p.Cc) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return v2 ? launch<float, true>(p, st) : launch<float, false>(p, st);
  return v2 ? launch<__nv_bfloat16, true>(p, st)
            : launch<__nv_bfloat16, false>(p, st);
}

}  // extern "C"
