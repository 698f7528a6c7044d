// Fused gated ResBlock for Hopper (sm_90a): the CUDA ports of the Pallas
// TPU kernels in flowavenet_tpu/ops/pallas_resblock.py
//   _resblock_kernel     (:58, resblock, v2 = 0): takes the conditioning
//                        pre-activations cond_fg [B, T, 2R] (c's 1x1, the
//                        g term and both biases, summed outside);
//   _resblock_kernel_v2  (:278, resblock_v2, v2 = 1): takes the raw half
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
// What bounds it on this card: operations.  Per row it does 2R(6R + R + S)
// operations (plus 4*Cc*R for v2) against ~6R bytes of h, cond, h_new and
// skip in bf16 (v2 reads 2*Cc bytes of c instead of 4R of cond), i.e.
// hundreds of operations per byte, right of the ~295 FLOP/byte ridge, so
// the bound is the tensor cores' rate.  The design keeps the tile's
// intermediates on chip: one CTA of 512 threads owns (batch row, time tile
// of TT rows); it stages the tile's h window (TT + 2d rows from t0 - lead,
// lead = d, or 2d when causal; zero outside [0, T)) in shared memory,
// writes the gate outputs to shared memory once and runs both 1x1s from
// there, so h is read once and fg never leaves the SM.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16 into fp32), on the pair
// kernels' layer (pair_flow_common.cuh), since a ResBlock is one layer of
// the pair's coupling net: direct_layer_tc_bf over window rows [d, d +
// TT) at dilation d, whose taps r - d, r, r + d of centre row r are the
// window rows o, o + d, o + 2d of output row o = r - d in both the causal
// and the non-causal window (only the window's first row differs), with
// win0 = t0 - d so that the conditioning reads row t0 + o: v2 with the
// dense conditioning 1x1 (COND_DENSE, cond_tc: c rows read per lane from
// global memory against the packed w_cond, bias b_all); v1 with cond_fg as
// the hoisted pre-activations (COND_HOIST, Cc = 2R, layer 0, zero bias:
// cond_fg holds the biases), read in bf16 as the plain version rounds it.
// The h window and the gate rows G sit at the padded row stride R + 8 so
// that the 8 rows of an ldmatrix fall in distinct banks.  res and skip are
// one tc_rows over G (B0 = w_res, B1 = w_skip, packed in fragment order by
// the wrapper); its epilogue adds b_res and h (read back from the window)
// and b_skip in fp32 and stores rows below T.  The wrapper takes the tile
// for the fewest waves over the SMs, as for the hoisted pairs
// (ops/pair_flow.py:hoisted_t_tile).
// fp32 stays on CUDA cores (the parity path): each thread accumulates one
// column's filter and gate pre-activations of RM rows (pf::mm2), and v2
// stages c through shared memory in chunks of CK channels per CH rows (Cc
// reaches 2560 at lj22k block 5), all threads stepping through the chunks
// together; weights stay in global memory, served from L2.
//
// Widths: the tensor-core instances take R a multiple of 32 and (v2) Cc of
// 16, the CUDA-core ones R dividing the 512 threads; the wrapper pads
// other widths with zero channels (ops/resblock.py:resblock_widths) and the
// launcher refuses them unpadded.

#include "pair_flow_common.cuh"

namespace {

using pf::NT;
using pf::RM;

struct RbParams {
  const void* h;        // [B][T][R]
  const void* cond;     // v1: cond_fg [B][T][2R]; v2: c [B][T][Cc]
  const void* w_conv;   // [3][R][2R]  (bf16: packed in fragment order)
  const void* w_cond;   // v2: [Cc][2R]
  const float* b_all;   // v2: [2R]; the bf16 v1: [2R] zeros
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

// Shared memory of the CUDA-core instances: the h window [TT + 2d][R], the
// gate outputs [TT][R] and (v2) the c chunk [CH][CK], in the storage type.
inline size_t smem_bytes(int es, bool v2, int R, int Cc, int TT, int dil) {
  size_t o = pf::align16((size_t)es * (TT + 2 * dil) * R);
  o += pf::align16((size_t)es * TT * R);
  if (v2) o += pf::align16((size_t)es * rows_per_pass(R) * c_chunk(es, R, Cc));
  return o;
}

// Shared memory of the tensor-core instances: the h window [TT + 2d] and
// the gate outputs [TT] at the row stride R + 8, in bf16.
inline size_t smem_bytes_tc(int R, int TT, int dil) {
  const size_t ld = pf::row_ld_h(R, true);
  return pf::align16(2 * (TT + 2 * dil) * ld) + pf::align16(2 * TT * ld);
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

// The bf16 instances on the tensor cores (see the head of this file).  At
// one CTA per SM (minBlocks 1) ptxas may take up to 128 registers: without
// it, it held v1 to 64 and spilled 24 bytes (H100 80GB HBM3, 700 W;
// tools/resblock_ab.py: v1 0.054 -> 0.046 ms, v2 4.08 -> 3.47 ms of kernel
// time per phase-2c sweep with it).
template <bool V2>
__global__ void __launch_bounds__(NT, 1) resblock_tc_kernel(RbParams p) {
  using bf = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = p.R, TT = p.TT, d = p.dil;
  const int ld = pf::row_ld_h(R, true), W = TT + 2 * d;
  bf* H = reinterpret_cast<bf*>(smem_raw);
  bf* G = reinterpret_cast<bf*>(smem_raw + pf::align16(2 * (size_t)W * ld));
  const int b = blockIdx.x / p.n_t, tile = blockIdx.x % p.n_t;
  const int t0 = tile * TT;                    // global row of output row 0
  const int w0 = t0 - p.lead;                  // global row of window row 0
  const int rows = min(TT, p.T - t0);          // output rows below T

  // the h window, 16 bytes per load; rows outside [0, T) are the zero
  // padding
  const bf* hg = static_cast<const bf*>(p.h) + (size_t)b * p.T * R;
  for (int idx = threadIdx.x; idx < W * (R / 8); idx += NT) {
    const int j = idx / (R / 8), c = 8 * (idx % (R / 8)), pos = w0 + j;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (pos >= 0 && pos < p.T)
      v = __ldg(reinterpret_cast<const uint4*>(hg + (size_t)pos * R + c));
    *reinterpret_cast<uint4*>(H + (size_t)j * ld + c) = v;
  }
  __syncthreads();

  // filter|gate of output row o at centre row r = o + d: taps r - d, r,
  // r + d; G holds centre row r at row r - d (so s.G starts d rows before
  // it, inside the H buffer, and is never read there)
  pf::Params lp{};
  lp.T = p.T;
  lp.R = R;
  lp.Cc = V2 ? p.Cc : 2 * R;
  pf::Flow f{};
  f.kfg = p.w_conv;
  f.cond_w = p.w_cond;
  f.cond_b = p.b_all;
  pf::Smem s{};
  s.H = H;
  s.G = G - (size_t)d * ld;
  s.ldh = ld;
  pf::direct_layer_tc_bf<V2 ? pf::COND_DENSE : pf::COND_HOIST>(
      lp, f, s, 0, d, d + rows, d, p.cond, b, t0 - d);
  __syncthreads();

  // res and skip share the gate outputs: h_new = (h + res + b_res) *
  // sqrt(1/2) with h from the window, skip + b_skip; rows below T only
  bf* hn = static_cast<bf*>(p.h_new) + (size_t)b * p.T * R;
  bf* sk = static_cast<bf*>(p.skip) + (size_t)b * p.T * R;
  const int lane = threadIdx.x & 31;
  pf::tc_rows(static_cast<const bf*>(s.G), ld, d, d + rows, R,
              static_cast<const uint2*>(p.w_res) + lane,
              static_cast<const uint2*>(p.w_skip) + lane, R / 8,
              R / (8 * pf::TJ), pf::TJ, [&](int r, int n, float ra, float sa) {
                const int o = r - d;
                const size_t t = (size_t)(t0 + o) * R + n;
                const float h =
                    __bfloat162float(H[(size_t)(o + p.lead) * ld + n]);
                hn[t] = __float2bfloat16_rn((h + (ra + p.b_res[n])) *
                                            pf::SQRT_HALF);
                sk[t] = __float2bfloat16_rn(sa + p.b_skip[n]);
              });
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

template <bool V2>
int launch_tc(const RbParams& p, cudaStream_t stream) {
  const int smem = (int)smem_bytes_tc(p.R, p.TT, p.dil);
  cudaError_t e = cudaFuncSetAttribute(
      resblock_tc_kernel<V2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  resblock_tc_kernel<V2><<<p.B * p.n_t, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename K>
int attrs_of(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxDynamicSharedSizeBytes;
  return 0;
}

// The widths an instance takes: on the tensor cores R a multiple of 32 (a
// warp item spans 16 filter columns with their 16 gate columns, or 32
// columns of one 1x1) and, for v2, Cc a multiple of 16 (a bf16 k-step);
// on CUDA cores R dividing NT (each thread owns one column).
bool widths_ok(bool tc, bool v2, int R, int Cc) {
  if (R <= 0 || (v2 && Cc <= 0)) return false;
  return tc ? R % 32 == 0 && (!v2 || Cc % 16 == 0) : NT % R == 0;
}

}  // namespace

extern "C" {

int resblock_threads() { return NT; }

// Dynamic shared memory one CTA needs (bytes).  dtype: 0 fp32 (CUDA
// cores), 1 bf16 (tensor cores).
int resblock_smem_bytes(int dtype, int v2, int R, int Cc, int TT, int dil) {
  if (dtype == 1) return (int)smem_bytes_tc(R, TT, dil);
  return (int)smem_bytes(4, v2 != 0, R, Cc, TT, dil);
}

// ptrs: h, cond (v1 cond_fg / v2 c), w_conv, w_cond, b_all, w_res, b_res,
// w_skip, b_skip, h_new, skip (w_cond null for v1; b_all null for the fp32
// v1, 2R zeros for the bf16 one); dims: B, T, R, Cc (v2), TT, dilation,
// lead (d, or 2d when causal).  tc must say whether (dtype) is a
// tensor-core instance: bf16 runs only there, with w_conv, w_cond, w_res
// and w_skip packed in fragment order (ops/pair_flow.py:pack_tc_weights),
// fp32 only on CUDA cores.  Widths the instance does not take (widths_ok)
// are refused; the wrapper pads them.  Returns the cudaError_t of the
// launch (0 = success).
int resblock_launch(int dtype, int v2, int tc, const void* const* ptrs,
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
  if ((dtype != 0 && dtype != 1) || (tc != 0) != (dtype == 1) ||
      !widths_ok(tc != 0, v2 != 0, p.R, p.Cc) || p.TT <= 0 || p.T <= 0 ||
      p.B <= 0 || p.dil <= 0 || (tc && !p.b_all))
    return (int)cudaErrorInvalidValue;
  p.n_t = (p.T + p.TT - 1) / p.TT;
  p.CK = v2 && !tc ? c_chunk(4, p.R, p.Cc) : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc) return v2 ? launch_tc<true>(p, st) : launch_tc<false>(p, st);
  return v2 ? launch<float, true>(p, st) : launch<float, false>(p, st);
}

// out[3] = registers and local (spill) bytes per thread of the (dtype, v2)
// instance and the dynamic shared memory its last launch set, from
// cudaFuncGetAttributes.  Returns its cudaError_t.
int resblock_attrs(int dtype, int v2, int* out) {
  if (dtype == 1)
    return v2 ? attrs_of(resblock_tc_kernel<true>, out)
              : attrs_of(resblock_tc_kernel<false>, out);
  return v2 ? attrs_of(resblock_kernel<float, true>, out)
            : attrs_of(resblock_kernel<float, false>, out);
}

}  // extern "C"
