// Forward and training flow PAIR kernels for Hopper (sm_90a): the CUDA
// ports of the Pallas TPU kernels
//   flowavenet_tpu/ops/pallas_flow.py:_pair_kernel_fw        -> pair_fwd
//   flowavenet_tpu/ops/pallas_flow_train.py:_pair_kernel_fws -> pair_train_fwd
//   flowavenet_tpu/ops/pallas_flow_train.py:_pair_kernel_bwd -> pair_train_bwd
//
// One forward pair applies
//     u0 = (u + b)*s ; v0 = (v + b)*s                    ActNorm (even)
//     v2 = (v0 - t(u0; even)) * exp(-log_s(u0; even))   coupling (even)
//     v3 = (v2 + b)*s ; u2 = (u0 + b)*s                  ActNorm (odd)
//     u3 = (u2 - t(v3; odd)) * exp(-log_s(v3; odd))     coupling (odd)
// and returns (u3, v3) plus per-tile sums over the valid rows of -log_s
// (pair_fwd) and also max|log_s|, sum log_s^2, sum relu(|log_s|-margin)^2
// (pair_train_fwd).  Each (log_s, t) is a WaveNet coupling net: k=3 front
// conv -> relu -> gated layers at dilations 1 and 3 with conditioning 1x1s
// -> res/skip -> relu -> 1x1 -> relu -> zero conv.  Weight norm, exp(3*scale)
// and the ActNorm halves are folded outside the kernel
// (ops/pair_flow.py pair_forward_operands); the backward returns gradients
// of those folded operands and autograd carries them to the params.
//
// pair_train_bwd recomputes the pair over its tile plus a halo of 20 rows
// per side and runs the whole activation-gradient chain: dnet2 over the
// odd net's rows [10, L-10) of the window, dv3 over [15, L-15), dnet1 over
// [15, L-15) and du over the tile [20, L-20).  20 is the chain's real
// reach (each coupling net reads +-5 rows, and the gradient crosses four
// nets' worth of receptive field: +-10 forward, +-10 backward); the JAX
// kernel takes 32 only for sublane alignment.  Weight gradients sum the
// tile's own valid rows only, so every global row is counted once; the
// scalar cotangents on log_s (logdet, L2, hinge) apply at every valid row
// of the window, halo rows included.
//
// The TPU kernel carries its weight-gradient accumulators across a
// sequential grid.  Here CTAs run in parallel and in no order, so the grid
// is persistent (at most one CTA per SM, each walking tiles c, c+G, ...)
// and each CTA accumulates into its own fp32 slab; a second launch sums
// the G slabs in a fixed order.  No atomics: two launches on the same
// inputs give the same bits.
//
// What bounds it on this card: arithmetic (~4.2 MFLOP per pair per row
// forward, ~3x that backward, against tens of bytes per row of u, v, c).
// Two designs, chosen per instance by a template flag (TC):
//   - every bf16 instance (pair_fwd, pair_train_fwd and pair_train_bwd)
//     runs its products on the tensor cores (the section "Tensor-core
//     instances" below);
//   - every fp32 instance keeps every activation of the window in a
//     per-CTA fp32 workspace in device memory and runs every product
//     through one shared-memory-tiled CUDA-core GEMM (64x64 tiles, fp32
//     FMA); fp32 holds its rel <= 1e-4 bar, which a bf16 product cannot.
//
// Numerics mirror the Pallas kernels and the plain version
// (ops/pair_flow_train.py pair_train_fwd_ref): fp32 accumulation and
// gates; h0, h1, the gate outputs, the relu'd skip sum and the final 1x1
// output rounded to the storage type; the zero conv, the affine updates
// and the statistics in fp32.  The backward rounds the cotangent of each
// rounded activation to the storage type, as autograd through the plain
// version does, and (the tensor-core instance; an identity in fp32) the
// operands of its products where the JAX backward does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_flow_common.cuh"   // the tensor-core instances' shared body

namespace {

constexpr int NT = 256;                  // threads per CTA
constexpr int BM = 64, BN = 64, BK = 16; // GEMM tile
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

struct GemmSmem {
  float a[BK][BM + 4];
  float b[BK][BN + 4];
};

// C(m, n) = sum_k A(m, k) * B(k, n) over m < M, n < N, k < K; epi(m, n, c)
// is called once per output by the one thread that owns it.  AK: the A
// tile is loaded with neighbouring threads on neighbouring k (A row-major
// in k), else on neighbouring m; BN_: B loaded along n, else along k.
// Ends with a barrier, so the epilogue's writes are visible to the CTA.
template <bool AK, bool BN_, class LA, class LB, class EPI>
__device__ void gemm(int M, int N, int K, LA la, LB lb, EPI epi,
                     GemmSmem& sm) {
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = tid; i < BK * BM; i += NT) {
          const int kk = AK ? i % BK : i / BM;
          const int mm = AK ? i / BK : i % BM;
          const int m = m0 + mm, k = k0 + kk;
          sm.a[kk][mm] = (m < M && k < K) ? la(m, k) : 0.f;
        }
        for (int i = tid; i < BK * BN; i += NT) {
          const int kk = BN_ ? i / BN : i % BK;
          const int nn = BN_ ? i % BN : i / BK;
          const int n = n0 + nn, k = k0 + kk;
          sm.b[kk][nn] = (n < N && k < K) ? lb(k, n) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = sm.a[kk][tm * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = sm.b[kk][tn * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + tm * 4 + i, n = n0 + tn * 4 + j;
          if (m < M && n < N) epi(m, n, acc[i][j]);
        }
    }
  }
  __syncthreads();
}

// slab[n] += sum_{k < K} val(k, n) for n < N (one thread per column, rows
// in order: deterministic).  No barrier: the caller's next barrier covers it.
template <class V>
__device__ void colsum(int N, int K, V val, float* slab) {
  for (int n = threadIdx.x; n < N; n += NT) {
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += val(k, n);
    slab[n] += s;
  }
}

struct Flow {              // one flow's folded operands
  const void* front_w;     // [3][Rin][R]
  const float* front_b;    // [R]
  const void* kfg;         // [2][3][R][2R]
  const void* cond_w;      // [2][Cc][2R]
  const float* cond_b;     // [2][2R]
  const void* res_w;       // [R][R]
  const float* res_b;      // [R]
  const void* skip_w;      // [2][R][R]
  const float* skip_b;     // [2][R]
  const void* fin_w;       // [R][R]
  const float* fin_b;      // [R]
  const void* zw;          // [R][2Rin]
  const float* zb;         // [2Rin]
};

struct Args {
  const void *u, *v, *ca, *cb;   // [B][T][Rin], [B][T][Cc]
  const void *gu, *gv;           // backward: cotangents of u3, v3
  void *u_out, *v_out;           // forward outputs
  void *du, *dv, *dca, *dcb;     // backward outputs
  float* st;                     // forward: [n_tiles][4] statistics
  const float* gsc;              // backward: d raw, d sumsq, d hinge
  float* ws;                     // workspace, ws_floats per CTA
  float* slab;                   // backward: grad_floats per CTA
  Flow flow[2];                  // 0 = even, 1 = odd
  const float* an_s;             // [2 flow][2 half][Rin]
  const float* an_b;
  int B, T, Rin, R, Cc, TT, H, n_t;
  long long ws_floats, grad_floats;
  float margin;
};

// Offsets (floats) of the 15 operand gradients in one slab, in the order
// of pair_forward_operands; each stacks the two flows on its first axis.
struct GradOff {
  long long front_w, front_b, kfg, cond_w, cond_b, res_w, res_b, skip_w,
      skip_b, fin_w, fin_b, zw, zb, an_s, an_b, total;
};

__host__ __device__ inline GradOff grad_offsets(int R, int Rin, int Cc) {
  GradOff g;
  const long long R_ = R, Ri = Rin, C = Cc, R2 = 2 * R_;
  long long o = 0;
  g.front_w = o; o += 2 * 3 * Ri * R_;
  g.front_b = o; o += 2 * R_;
  g.kfg = o;     o += 2 * 2 * 3 * R_ * R2;
  g.cond_w = o;  o += 2 * 2 * C * R2;
  g.cond_b = o;  o += 2 * 2 * R2;
  g.res_w = o;   o += 2 * R_ * R_;
  g.res_b = o;   o += 2 * R_;
  g.skip_w = o;  o += 2 * 2 * R_ * R_;
  g.skip_b = o;  o += 2 * 2 * R_;
  g.fin_w = o;   o += 2 * R_ * R_;
  g.fin_b = o;   o += 2 * R_;
  g.zw = o;      o += 2 * R_ * 2 * Ri;
  g.zb = o;      o += 2 * 2 * Ri;
  g.an_s = o;    o += 2 * 2 * Ri;
  g.an_b = o;    o += 2 * 2 * Ri;
  g.total = o;
  return g;
}

// Per-row fp32 buffers of one coupling net, indexed by window row.
struct NetBuf {
  float *h0, *fg0, *g0, *h1, *sk0, *fg1, *g1, *o1, *o2;
};

struct Bufs {
  // pair level, [L][Rin] (NET*: [L][2Rin])
  float *U0, *V0, *V2, *V3, *V3M, *U2, *U3, *NET1, *NET2;
  NetBuf n1, n2;                 // n2 aliases n1 in the forward kernel
  // backward only
  float *DNET, *DA, *DB, *DG, *DFG, *DH1, *DH0, *DC, *DX, *DV3, *DV2, *DU0,
      *DU2, *DV0;
};

// Lays the buffers out from ``base``; returns the floats used per CTA.
__host__ __device__ inline long long layout(float* base, bool bwd, int R,
                                            int Rin, int Cc, int L,
                                            Bufs* w) {
  long long o = 0;
  auto take = [&](long long width) {
    float* p = base ? base + o : nullptr;
    o += width * L;
    o = (o + 3) & ~3LL;
    return p;
  };
  Bufs b;
  b.U0 = take(Rin); b.V0 = take(Rin); b.V2 = take(Rin); b.V3 = take(Rin);
  b.V3M = take(Rin); b.U2 = take(Rin); b.U3 = take(Rin);
  b.NET1 = take(2 * Rin); b.NET2 = take(2 * Rin);
  for (int k = 0; k < (bwd ? 2 : 1); ++k) {
    NetBuf& n = k == 0 ? b.n1 : b.n2;
    n.h0 = take(R); n.fg0 = take(2 * R); n.g0 = take(R); n.h1 = take(R);
    n.sk0 = take(R); n.fg1 = take(2 * R); n.g1 = take(R); n.o1 = take(R);
    n.o2 = take(R);
  }
  if (!bwd) b.n2 = b.n1;
  if (bwd) {
    b.DNET = take(2 * Rin); b.DA = take(R); b.DB = take(R); b.DG = take(R);
    b.DFG = take(2 * R); b.DH1 = take(R); b.DH0 = take(R); b.DC = take(Cc);
    b.DX = take(Rin); b.DV3 = take(Rin); b.DV2 = take(Rin);
    b.DU0 = take(Rin); b.DU2 = take(Rin); b.DV0 = take(Rin);
  }
  if (w) *w = b;
  return o;
}

// Geometry of one window: row j holds global position win0 + j.
struct Win {
  int win0, T, L;
  __device__ bool valid(int j) const {
    const int pos = win0 + j;
    return pos >= 0 && pos < T;
  }
};

// One coupling net over window rows [lo, hi): input X ([L][Rin], rows
// [lo-5, hi+5) used), conditioning rows from C ([T][Cc] of this batch row,
// zero outside the sequence).  Keeps every activation in nb and writes the
// zero-conv output (log_s || t) to NET rows [lo, hi).
template <typename T>
__device__ void net_fwd(const Flow& f, const NetBuf& nb, const float* X,
                        const T* C, float* NET, int lo, int hi, Win w,
                        int R, int Rin, int Cc, GemmSmem& sm) {
  const int R2 = 2 * R, R2in = 2 * Rin;
  const int T_ = w.T, win0 = w.win0;
  auto cval = [=](int j, int ch) -> float {
    const int pos = win0 + j;
    return (pos >= 0 && pos < T_) ? to_f(C[(size_t)pos * Cc + ch]) : 0.f;
  };
  float *h0 = nb.h0, *fg0 = nb.fg0, *g0 = nb.g0, *h1 = nb.h1, *sk0 = nb.sk0,
        *fg1 = nb.fg1, *g1 = nb.g1, *o1 = nb.o1, *o2 = nb.o2;

  // h0 = relu(front(X) + b) over [lo-4, hi+4), rounded, masked
  {
    const T* fw = static_cast<const T*>(f.front_w);
    const float* fb = f.front_b;
    const int r0 = lo - 4;
    gemm<true, true>(
        hi - lo + 8, R, 3 * Rin,
        [=](int m, int k) {
          const int tap = k / Rin, c = k - tap * Rin;
          return X[(r0 + m - 1 + tap) * Rin + c];
        },
        [=](int k, int n) { return to_f(fw[(size_t)k * R + n]); },
        [=](int m, int n, float acc) {
          const int j = r0 + m;
          h0[j * R + n] = w.valid(j) ? rnd<T>(fmaxf(acc + fb[n], 0.f)) : 0.f;
        },
        sm);
  }
  // fg0 = conv3(h0, kfg0, d=1) + c @ cond_w0 + cond_b0 over [lo-3, hi+3)
  {
    const T* kf = static_cast<const T*>(f.kfg);
    const T* cw = static_cast<const T*>(f.cond_w);
    const float* cbias = f.cond_b;
    const int r0 = lo - 3, K3 = 3 * R;
    gemm<true, true>(
        hi - lo + 6, R2, K3 + Cc,
        [=](int m, int k) {
          if (k < K3) {
            const int tap = k / R, c = k - tap * R;
            return h0[(r0 + m - 1 + tap) * R + c];
          }
          return cval(r0 + m, k - K3);
        },
        [=](int k, int n) {
          return k < K3 ? to_f(kf[(size_t)k * R2 + n])
                        : to_f(cw[(size_t)(k - K3) * R2 + n]);
        },
        [=](int m, int n, float acc) {
          fg0[(r0 + m) * R2 + n] = acc + cbias[n];
        },
        sm);
    for (int i = threadIdx.x; i < (hi - lo + 6) * R; i += NT) {
      const int j = r0 + i / R, n = i % R;
      const float fv = fg0[j * R2 + n], gv = fg0[j * R2 + R + n];
      g0[j * R + n] = rnd<T>(tanhf(fv) * (1.f / (1.f + expf(-gv))));
    }
    __syncthreads();
  }
  // res | skip0 = g0 @ [res_w | skip_w0]; h1 = (h0 + res) * sqrt(.5)
  {
    const T* rw = static_cast<const T*>(f.res_w);
    const T* sw = static_cast<const T*>(f.skip_w);
    const float* rb = f.res_b;
    const int r0 = lo - 3;
    gemm<true, true>(
        hi - lo + 6, R2, R,
        [=](int m, int k) { return g0[(r0 + m) * R + k]; },
        [=](int k, int n) {
          return n < R ? to_f(rw[(size_t)k * R + n])
                       : to_f(sw[(size_t)k * R + n - R]);
        },
        [=](int m, int n, float acc) {
          const int j = r0 + m;
          if (n < R)
            h1[j * R + n] = w.valid(j)
                ? rnd<T>((h0[j * R + n] + (acc + rb[n])) * SQRT_HALF) : 0.f;
          else
            sk0[j * R + n - R] = acc;
        },
        sm);
  }
  // fg1 = conv3(h1, kfg1, d=3) + c @ cond_w1 + cond_b1 over [lo, hi)
  {
    const T* kf = static_cast<const T*>(f.kfg) + (size_t)3 * R * R2;
    const T* cw = static_cast<const T*>(f.cond_w) + (size_t)Cc * R2;
    const float* cbias = f.cond_b + R2;
    const int K3 = 3 * R;
    gemm<true, true>(
        hi - lo, R2, K3 + Cc,
        [=](int m, int k) {
          if (k < K3) {
            const int tap = k / R, c = k - tap * R;
            return h1[(lo + m + 3 * (tap - 1)) * R + c];
          }
          return cval(lo + m, k - K3);
        },
        [=](int k, int n) {
          return k < K3 ? to_f(kf[(size_t)k * R2 + n])
                        : to_f(cw[(size_t)(k - K3) * R2 + n]);
        },
        [=](int m, int n, float acc) {
          fg1[(lo + m) * R2 + n] = acc + cbias[n];
        },
        sm);
    for (int i = threadIdx.x; i < (hi - lo) * R; i += NT) {
      const int j = lo + i / R, n = i % R;
      const float fv = fg1[j * R2 + n], gv = fg1[j * R2 + R + n];
      g1[j * R + n] = rnd<T>(tanhf(fv) * (1.f / (1.f + expf(-gv))));
    }
    __syncthreads();
  }
  // o1 = relu((skip0 + b0) + (g1 @ skip_w1 + b1)), rounded
  {
    const T* sw = static_cast<const T*>(f.skip_w) + (size_t)R * R;
    const float* sb = f.skip_b;
    gemm<true, true>(
        hi - lo, R, R, [=](int m, int k) { return g1[(lo + m) * R + k]; },
        [=](int k, int n) { return to_f(sw[(size_t)k * R + n]); },
        [=](int m, int n, float acc) {
          const int j = lo + m;
          o1[j * R + n] =
              rnd<T>(fmaxf((sk0[j * R + n] + sb[n]) + (acc + sb[R + n]), 0.f));
        },
        sm);
  }
  // o2 = relu(o1 @ fin_w + b), rounded
  {
    const T* fw = static_cast<const T*>(f.fin_w);
    const float* fb = f.fin_b;
    gemm<true, true>(
        hi - lo, R, R, [=](int m, int k) { return o1[(lo + m) * R + k]; },
        [=](int k, int n) { return to_f(fw[(size_t)k * R + n]); },
        [=](int m, int n, float acc) {
          o2[(lo + m) * R + n] = rnd<T>(fmaxf(acc + fb[n], 0.f));
        },
        sm);
  }
  // zero conv, fp32 out
  {
    const T* zw = static_cast<const T*>(f.zw);
    const float* zb = f.zb;
    gemm<true, true>(
        hi - lo, R2in, R, [=](int m, int k) { return o2[(lo + m) * R + k]; },
        [=](int k, int n) { return to_f(zw[(size_t)k * R2in + n]); },
        [=](int m, int n, float acc) {
          NET[(lo + m) * R2in + n] = acc + zb[n];
        },
        sm);
  }
}

// The forward pair over one window of L rows (tile rows [H, L-H)): both
// nets and the affine updates, every intermediate kept in ``b``.
template <typename T>
__device__ void pair_fwd_window(const Args& p, const Bufs& b, int brow,
                                Win w, GemmSmem& sm) {
  const int Rin = p.Rin, L = w.L, R2in = 2 * Rin;
  const T* ug = static_cast<const T*>(p.u) + (size_t)brow * p.T * Rin;
  const T* vg = static_cast<const T*>(p.v) + (size_t)brow * p.T * Rin;
  const T* ca = static_cast<const T*>(p.ca) + (size_t)brow * p.T * p.Cc;
  const T* cb = static_cast<const T*>(p.cb) + (size_t)brow * p.T * p.Cc;
  const float *as = p.an_s, *ab = p.an_b;   // [flow][half][Rin]
  for (int i = threadIdx.x; i < L * Rin; i += NT) {
    const int j = i / Rin, ch = i % Rin;
    const bool ok = w.valid(j);
    const size_t g = (size_t)(w.win0 + j) * Rin + ch;
    const float uu = ok ? to_f(ug[g]) : 0.f, vv = ok ? to_f(vg[g]) : 0.f;
    b.U0[i] = ok ? rnd<T>((uu + ab[ch]) * as[ch]) : 0.f;
    b.V0[i] = (vv + ab[Rin + ch]) * as[Rin + ch];
  }
  __syncthreads();
  net_fwd<T>(p.flow[0], b.n1, b.U0, ca, b.NET1, 5, L - 5, w, p.R, Rin, p.Cc,
             sm);
  for (int i = threadIdx.x; i < (L - 10) * Rin; i += NT) {
    const int j = 5 + i / Rin, ch = i % Rin, q = j * Rin + ch;
    const float ls = b.NET1[j * R2in + ch], t = b.NET1[j * R2in + Rin + ch];
    const float v2 = (b.V0[q] - t) * expf(-ls);
    const float v3 = (v2 + ab[2 * Rin + ch]) * as[2 * Rin + ch];
    b.V2[q] = v2;
    b.V3[q] = v3;
    b.V3M[q] = w.valid(j) ? rnd<T>(v3) : 0.f;
    b.U2[q] = (b.U0[q] + ab[3 * Rin + ch]) * as[3 * Rin + ch];
  }
  __syncthreads();
  net_fwd<T>(p.flow[1], b.n2, b.V3M, cb, b.NET2, 10, L - 10, w, p.R, Rin,
             p.Cc, sm);
  for (int i = threadIdx.x; i < (L - 20) * Rin; i += NT) {
    const int j = 10 + i / Rin, ch = i % Rin, q = j * Rin + ch;
    const float ls = b.NET2[j * R2in + ch], t = b.NET2[j * R2in + Rin + ch];
    b.U3[q] = (b.U2[q] - t) * expf(-ls);
  }
  __syncthreads();
}

// Pointers into one CTA's slab for one flow's gradients.
struct FlowGrad {
  float *front_w, *front_b, *kfg, *cond_w, *cond_b, *res_w, *res_b, *skip_w,
      *skip_b, *fin_w, *fin_b, *zw, *zb;
};

__device__ inline FlowGrad flow_grad(float* slab, const GradOff& g, int fl,
                                     int R, int Rin, int Cc) {
  const long long R_ = R, Ri = Rin, C = Cc, R2 = 2 * R_;
  FlowGrad d;
  d.front_w = slab + g.front_w + fl * 3 * Ri * R_;
  d.front_b = slab + g.front_b + fl * R_;
  d.kfg = slab + g.kfg + fl * 2 * 3 * R_ * R2;
  d.cond_w = slab + g.cond_w + fl * 2 * C * R2;
  d.cond_b = slab + g.cond_b + fl * 2 * R2;
  d.res_w = slab + g.res_w + fl * R_ * R_;
  d.res_b = slab + g.res_b + fl * R_;
  d.skip_w = slab + g.skip_w + fl * 2 * R_ * R_;
  d.skip_b = slab + g.skip_b + fl * 2 * R_;
  d.fin_w = slab + g.fin_w + fl * R_ * R_;
  d.fin_b = slab + g.fin_b + fl * R_;
  d.zw = slab + g.zw + fl * R_ * 2 * Ri;
  d.zb = slab + g.zb + fl * 2 * Ri;
  return d;
}

// Backward of net_fwd given b.DNET over rows [a, e).  Weight gradients sum
// rows [s0, s1) (the tile's valid rows) into ``d``.  Leaves dX (the
// gradient of the net input X) in b.DX over [a+5, e-5) and dC in b.DC over
// [a+3, e-3).  Each cotangent of a rounded activation is rounded (rc).
template <typename T>
__device__ void net_bwd(const Flow& f, const NetBuf& nb, const Bufs& b,
                        const FlowGrad& d, const float* X, const T* C, int a,
                        int e, int s0, int s1, Win w, int R, int Rin, int Cc,
                        GemmSmem& sm) {
  const int R2 = 2 * R, R2in = 2 * Rin, KS = s1 - s0;
  const int T_ = w.T, win0 = w.win0;
  auto cval = [=](int j, int ch) -> float {
    const int pos = win0 + j;
    return (pos >= 0 && pos < T_) ? to_f(C[(size_t)pos * Cc + ch]) : 0.f;
  };
  const float *h0 = nb.h0, *fg0 = nb.fg0, *g0 = nb.g0, *h1 = nb.h1,
              *fg1 = nb.fg1, *g1 = nb.g1, *o1 = nb.o1, *o2 = nb.o2;
  float *DNET = b.DNET, *DA = b.DA, *DB = b.DB, *DG = b.DG, *DFG = b.DFG,
        *DH1 = b.DH1, *DH0 = b.DH0, *DC = b.DC, *DX = b.DX;

  // zero conv: d zw, d zb; DA = d pre-relu of o2
  {
    float* dzw = d.zw;
    gemm<false, true>(
        R, R2in, KS, [=](int m, int k) { return o2[(s0 + k) * R + m]; },
        [=](int k, int n) { return DNET[(s0 + k) * R2in + n]; },
        [=](int m, int n, float acc) { dzw[m * R2in + n] += acc; }, sm);
    colsum(R2in, KS, [=](int k, int n) { return DNET[(s0 + k) * R2in + n]; },
           d.zb);
    const T* zw = static_cast<const T*>(f.zw);
    gemm<true, false>(
        e - a, R, R2in, [=](int m, int k) { return DNET[(a + m) * R2in + k]; },
        [=](int k, int n) { return to_f(zw[(size_t)n * R2in + k]); },
        [=](int m, int n, float acc) {
          const int j = a + m;
          DA[j * R + n] = o2[j * R + n] > 0.f ? rnd<T>(acc) : 0.f;
        },
        sm);
  }
  // final 1x1: d fin_w, d fin_b; DB = d pre-relu of o1 (the skip sum)
  {
    float* dfw = d.fin_w;
    gemm<false, true>(
        R, R, KS, [=](int m, int k) { return o1[(s0 + k) * R + m]; },
        [=](int k, int n) { return DA[(s0 + k) * R + n]; },
        [=](int m, int n, float acc) { dfw[m * R + n] += acc; }, sm);
    colsum(R, KS, [=](int k, int n) { return DA[(s0 + k) * R + n]; },
           d.fin_b);
    const T* fw = static_cast<const T*>(f.fin_w);
    gemm<true, false>(
        e - a, R, R, [=](int m, int k) { return DA[(a + m) * R + k]; },
        [=](int k, int n) { return to_f(fw[(size_t)n * R + k]); },
        [=](int m, int n, float acc) {
          const int j = a + m;
          DB[j * R + n] = o1[j * R + n] > 0.f ? rnd<T>(acc) : 0.f;
        },
        sm);
  }
  // skip 1: d skip_w1, d skip_b1 (= d skip_b0); DG = d g1
  {
    float* dsw = d.skip_w + (size_t)R * R;
    gemm<false, true>(
        R, R, KS, [=](int m, int k) { return g1[(s0 + k) * R + m]; },
        [=](int k, int n) { return DB[(s0 + k) * R + n]; },
        [=](int m, int n, float acc) { dsw[m * R + n] += acc; }, sm);
    colsum(R, KS, [=](int k, int n) { return DB[(s0 + k) * R + n]; },
           d.skip_b + R);
    colsum(R, KS, [=](int k, int n) { return DB[(s0 + k) * R + n]; },
           d.skip_b);
    const T* sw = static_cast<const T*>(f.skip_w) + (size_t)R * R;
    gemm<true, false>(
        e - a, R, R, [=](int m, int k) { return DB[(a + m) * R + k]; },
        [=](int k, int n) { return to_f(sw[(size_t)n * R + k]); },
        [=](int m, int n, float acc) { DG[(a + m) * R + n] = rnd<T>(acc); },
        sm);
  }
  // gate 1: DFG = d fg1 over [a, e)
  for (int i = threadIdx.x; i < (e - a) * R; i += NT) {
    const int j = a + i / R, n = i % R;
    const float t = tanhf(fg1[j * R2 + n]);
    const float s = 1.f / (1.f + expf(-fg1[j * R2 + R + n]));
    const float dg = DG[j * R + n];
    DFG[j * R2 + n] = dg * s * (1.f - t * t);
    DFG[j * R2 + R + n] = dg * t * s * (1.f - s);
  }
  __syncthreads();
  // layer 1: d kfg1, d cond_w1, d cond_b1; DC = dc over [a+3, e-3);
  // DH1 = d h1 over [a+3, e-3)
  {
    float* dk = d.kfg + (size_t)3 * R * R2;
    gemm<false, true>(
        3 * R, R2, KS,
        [=](int m, int k) {
          const int tap = m / R, c = m - tap * R;
          return h1[(s0 + k + 3 * (tap - 1)) * R + c];
        },
        [=](int k, int n) { return DFG[(s0 + k) * R2 + n]; },
        [=](int m, int n, float acc) { dk[(size_t)m * R2 + n] += acc; }, sm);
    float* dcw = d.cond_w + (size_t)Cc * R2;
    gemm<false, true>(
        Cc, R2, KS, [=](int m, int k) { return cval(s0 + k, m); },
        [=](int k, int n) { return DFG[(s0 + k) * R2 + n]; },
        [=](int m, int n, float acc) { dcw[(size_t)m * R2 + n] += acc; }, sm);
    colsum(R2, KS, [=](int k, int n) { return DFG[(s0 + k) * R2 + n]; },
           d.cond_b + R2);
    const T* cw = static_cast<const T*>(f.cond_w) + (size_t)Cc * R2;
    gemm<true, false>(
        e - a - 6, Cc, R2,
        [=](int m, int k) { return DFG[(a + 3 + m) * R2 + k]; },
        [=](int k, int n) { return to_f(cw[(size_t)n * R2 + k]); },
        [=](int m, int n, float acc) { DC[(a + 3 + m) * Cc + n] = acc; }, sm);
    const T* kf = static_cast<const T*>(f.kfg) + (size_t)3 * R * R2;
    gemm<true, false>(
        e - a - 6, R, 3 * R2,
        [=](int m, int k) {
          const int tap = k / R2, c = k - tap * R2;
          return DFG[(a + 3 + m - 3 * (tap - 1)) * R2 + c];
        },
        [=](int k, int n) {
          const int tap = k / R2, c = k - tap * R2;
          return to_f(kf[((size_t)tap * R + n) * R2 + c]);
        },
        [=](int m, int n, float acc) {
          const int j = a + 3 + m;
          DH1[j * R + n] = w.valid(j) ? rnd<T>(acc) : 0.f;
        },
        sm);
  }
  // res and skip 0: d res_w, d res_b, d skip_w0; DG = d g0 over [a+3, e-3)
  {
    float* drw = d.res_w;
    gemm<false, true>(
        R, R, KS, [=](int m, int k) { return g0[(s0 + k) * R + m]; },
        [=](int k, int n) { return DH1[(s0 + k) * R + n] * SQRT_HALF; },
        [=](int m, int n, float acc) { drw[m * R + n] += acc; }, sm);
    colsum(R, KS,
           [=](int k, int n) { return DH1[(s0 + k) * R + n] * SQRT_HALF; },
           d.res_b);
    float* dsw = d.skip_w;
    gemm<false, true>(
        R, R, KS, [=](int m, int k) { return g0[(s0 + k) * R + m]; },
        [=](int k, int n) { return DB[(s0 + k) * R + n]; },
        [=](int m, int n, float acc) { dsw[m * R + n] += acc; }, sm);
    const T* rw = static_cast<const T*>(f.res_w);
    const T* sw = static_cast<const T*>(f.skip_w);
    gemm<true, false>(
        e - a - 6, R, 2 * R,
        [=](int m, int k) {
          const int j = a + 3 + m;
          return k < R ? DH1[j * R + k] * SQRT_HALF : DB[j * R + k - R];
        },
        [=](int k, int n) {
          return k < R ? to_f(rw[(size_t)n * R + k])
                       : to_f(sw[(size_t)n * R + k - R]);
        },
        [=](int m, int n, float acc) {
          DG[(a + 3 + m) * R + n] = rnd<T>(acc);
        },
        sm);
  }
  // gate 0: DFG = d fg0 over [a+3, e-3)
  for (int i = threadIdx.x; i < (e - a - 6) * R; i += NT) {
    const int j = a + 3 + i / R, n = i % R;
    const float t = tanhf(fg0[j * R2 + n]);
    const float s = 1.f / (1.f + expf(-fg0[j * R2 + R + n]));
    const float dg = DG[j * R + n];
    DFG[j * R2 + n] = dg * s * (1.f - t * t);
    DFG[j * R2 + R + n] = dg * t * s * (1.f - s);
  }
  __syncthreads();
  // layer 0: d kfg0, d cond_w0, d cond_b0; DC += dc; DH0 = d pre-relu of
  // h0 over [a+4, e-4) (conv path plus the residual path)
  {
    float* dk = d.kfg;
    gemm<false, true>(
        3 * R, R2, KS,
        [=](int m, int k) {
          const int tap = m / R, c = m - tap * R;
          return h0[(s0 + k + tap - 1) * R + c];
        },
        [=](int k, int n) { return DFG[(s0 + k) * R2 + n]; },
        [=](int m, int n, float acc) { dk[(size_t)m * R2 + n] += acc; }, sm);
    float* dcw = d.cond_w;
    gemm<false, true>(
        Cc, R2, KS, [=](int m, int k) { return cval(s0 + k, m); },
        [=](int k, int n) { return DFG[(s0 + k) * R2 + n]; },
        [=](int m, int n, float acc) { dcw[(size_t)m * R2 + n] += acc; }, sm);
    colsum(R2, KS, [=](int k, int n) { return DFG[(s0 + k) * R2 + n]; },
           d.cond_b);
    const T* cw = static_cast<const T*>(f.cond_w);
    gemm<true, false>(
        e - a - 6, Cc, R2,
        [=](int m, int k) { return DFG[(a + 3 + m) * R2 + k]; },
        [=](int k, int n) { return to_f(cw[(size_t)n * R2 + k]); },
        [=](int m, int n, float acc) { DC[(a + 3 + m) * Cc + n] += acc; },
        sm);
    const T* kf = static_cast<const T*>(f.kfg);
    gemm<true, false>(
        e - a - 8, R, 3 * R2,
        [=](int m, int k) {
          const int tap = k / R2, c = k - tap * R2;
          return DFG[(a + 4 + m - (tap - 1)) * R2 + c];
        },
        [=](int k, int n) {
          const int tap = k / R2, c = k - tap * R2;
          return to_f(kf[((size_t)tap * R + n) * R2 + c]);
        },
        [=](int m, int n, float acc) {
          const int j = a + 4 + m;
          const float dh0 = acc + DH1[j * R + n] * SQRT_HALF;
          DH0[j * R + n] =
              (h0[j * R + n] > 0.f && w.valid(j)) ? rnd<T>(dh0) : 0.f;
        },
        sm);
  }
  // front conv: d front_w, d front_b; DX = d X over [a+5, e-5)
  {
    float* dfw = d.front_w;
    gemm<false, true>(
        3 * Rin, R, KS,
        [=](int m, int k) {
          const int tap = m / Rin, c = m - tap * Rin;
          return X[(s0 + k + tap - 1) * Rin + c];
        },
        [=](int k, int n) { return DH0[(s0 + k) * R + n]; },
        [=](int m, int n, float acc) { dfw[m * R + n] += acc; }, sm);
    colsum(R, KS, [=](int k, int n) { return DH0[(s0 + k) * R + n]; },
           d.front_b);
    const T* fw = static_cast<const T*>(f.front_w);
    gemm<true, false>(
        e - a - 10, Rin, 3 * R,
        [=](int m, int k) {
          const int tap = k / R, c = k - tap * R;
          return DH0[(a + 5 + m - (tap - 1)) * R + c];
        },
        [=](int k, int n) {
          const int tap = k / R, c = k - tap * R;
          return to_f(fw[((size_t)tap * Rin + n) * R + c]);
        },
        [=](int m, int n, float acc) { DX[(a + 5 + m) * Rin + n] = acc; },
        sm);
  }
}

// Block-wide reduction of one value per thread of NTH: sum (or max); the
// result is valid in thread 0.  Fixed order, so deterministic.
template <bool MAX, int NTH = NT>
__device__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, s);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = 0.f;
  if (threadIdx.x == 0) {
    r = red[0];
    for (int i = 1; i < NTH / 32; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  }
  __syncthreads();
  return r;
}

template <typename T, bool STATS>
__device__ void pair_fwd_cc(const Args& p) {
  __shared__ GemmSmem sm;
  __shared__ float red[NT / 32];
  Bufs b;
  const int L = p.TT + 2 * p.H, Rin = p.Rin, R2in = 2 * Rin;
  layout(p.ws + (long long)blockIdx.x * p.ws_floats, false, p.R, Rin, p.Cc,
         L, &b);
  for (int tile = blockIdx.x; tile < p.B * p.n_t; tile += gridDim.x) {
    const int brow = tile / p.n_t;
    const Win w{(tile % p.n_t) * p.TT - p.H, p.T, L};
    pair_fwd_window<T>(p, b, brow, w, sm);
    T* uo = static_cast<T*>(p.u_out) + (size_t)brow * p.T * Rin;
    T* vo = static_cast<T*>(p.v_out) + (size_t)brow * p.T * Rin;
    float raw = 0.f, mx = 0.f, sq = 0.f, hq = 0.f;
    for (int i = threadIdx.x; i < p.TT * Rin; i += NT) {
      const int j = p.H + i / Rin, ch = i % Rin, q = j * Rin + ch;
      if (!w.valid(j)) continue;
      const size_t g = (size_t)(w.win0 + j) * Rin + ch;
      uo[g] = from_f<T>(b.U3[q]);
      vo[g] = from_f<T>(b.V3[q]);
      const float l1 = b.NET1[j * R2in + ch], l2 = b.NET2[j * R2in + ch];
      raw -= l1 + l2;
      if (STATS) {
        mx = fmaxf(mx, fmaxf(fabsf(l1), fabsf(l2)));
        sq += l1 * l1 + l2 * l2;
        const float e1 = fmaxf(fabsf(l1) - p.margin, 0.f);
        const float e2 = fmaxf(fabsf(l2) - p.margin, 0.f);
        hq += e1 * e1 + e2 * e2;
      }
    }
    raw = block_reduce<false>(raw, red);
    if (STATS) {
      mx = block_reduce<true>(mx, red);
      sq = block_reduce<false>(sq, red);
      hq = block_reduce<false>(hq, red);
    }
    if (threadIdx.x == 0) {
      float* st = p.st + (size_t)tile * 4;
      st[0] = raw;
      st[1] = mx;
      st[2] = sq;
      st[3] = hq;
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void pair_bwd_cc(const Args& p) {
  __shared__ GemmSmem sm;
  Bufs b;
  const int L = p.TT + 2 * p.H, H = p.H, Rin = p.Rin, R2in = 2 * Rin;
  const int R = p.R, Cc = p.Cc;
  layout(p.ws + (long long)blockIdx.x * p.ws_floats, true, R, Rin, Cc, L,
         &b);
  float* slab = p.slab + (long long)blockIdx.x * p.grad_floats;
  const GradOff go = grad_offsets(R, Rin, Cc);
  for (long long i = threadIdx.x; i < p.grad_floats; i += NT) slab[i] = 0.f;
  const FlowGrad d0 = flow_grad(slab, go, 0, R, Rin, Cc);
  const FlowGrad d1 = flow_grad(slab, go, 1, R, Rin, Cc);
  const float gr = p.gsc[0], gq = p.gsc[1], gh = p.gsc[2], mg = p.margin;
  const float *as = p.an_s, *ab = p.an_b;
  __syncthreads();

  for (int tile = blockIdx.x; tile < p.B * p.n_t; tile += gridDim.x) {
    const int brow = tile / p.n_t;
    const Win w{(tile % p.n_t) * p.TT - H, p.T, L};
    const size_t row_off = (size_t)brow * p.T;
    const T* ug = static_cast<const T*>(p.u) + row_off * Rin;
    const T* vg = static_cast<const T*>(p.v) + row_off * Rin;
    const T* gug = static_cast<const T*>(p.gu) + row_off * Rin;
    const T* gvg = static_cast<const T*>(p.gv) + row_off * Rin;
    const T* ca = static_cast<const T*>(p.ca) + row_off * Cc;
    const T* cb = static_cast<const T*>(p.cb) + row_off * Cc;
    // the tile's valid rows: every weight-gradient sum runs over these
    const int s0 = max(H, -w.win0), s1 = min(L - H, p.T - w.win0);
    auto st_term = [=](float ls, int j) -> float {
      if (!w.valid(j)) return 0.f;
      const float ex = fmaxf(fabsf(ls) - mg, 0.f);
      return -gr + gq * 2.f * ls + gh * 2.f * ex * copysignf(1.f, ls);
    };

    pair_fwd_window<T>(p, b, brow, w, sm);

    // odd coupling: dnet2 over [10, L-10)
    for (int i = threadIdx.x; i < (L - 20) * Rin; i += NT) {
      const int j = 10 + i / Rin, ch = i % Rin;
      float dls = 0.f, dt = 0.f;
      if (w.valid(j)) {
        const float gu = to_f(gug[(size_t)(w.win0 + j) * Rin + ch]);
        const float ls = b.NET2[j * R2in + ch];
        dls = -gu * b.U3[j * Rin + ch] + st_term(ls, j);
        dt = -gu * expf(-ls);
      }
      b.DNET[j * R2in + ch] = dls;
      b.DNET[j * R2in + Rin + ch] = dt;
    }
    __syncthreads();
    net_bwd<T>(p.flow[1], b.n2, b, d1, b.V3M, cb, 10, L - 10, s0, s1, w, R,
               Rin, Cc, sm);
    {
      T* dcb = static_cast<T*>(p.dcb) + row_off * Cc;
      for (int i = threadIdx.x; i < p.TT * Cc; i += NT) {
        const int j = H + i / Cc, ch = i % Cc;
        if (w.valid(j))
          dcb[(size_t)(w.win0 + j) * Cc + ch] = from_f<T>(b.DC[j * Cc + ch]);
      }
    }
    // dv3 over [15, L-15): output cotangent + the masked, rounded net-input
    // gradient; the even coupling's dnet1 over the same rows
    for (int i = threadIdx.x; i < (L - 30) * Rin; i += NT) {
      const int j = 15 + i / Rin, ch = i % Rin, q = j * Rin + ch;
      float dv3 = 0.f, dls = 0.f, dt = 0.f;
      if (w.valid(j)) {
        dv3 = to_f(gvg[(size_t)(w.win0 + j) * Rin + ch]) + rnd<T>(b.DX[q]);
        const float dv2 = dv3 * as[2 * Rin + ch];
        const float ls = b.NET1[j * R2in + ch];
        dls = -dv2 * b.V2[q] + st_term(ls, j);
        dt = -dv2 * expf(-ls);
        b.DV2[q] = dv2;
      } else {
        b.DV2[q] = 0.f;
      }
      b.DV3[q] = dv3;
      b.DNET[j * R2in + ch] = dls;
      b.DNET[j * R2in + Rin + ch] = dt;
    }
    __syncthreads();
    net_bwd<T>(p.flow[0], b.n1, b, d0, b.U0, ca, 15, L - 15, s0, s1, w, R,
               Rin, Cc, sm);
    // tile rows: dca, du, dv and the per-row ActNorm terms
    {
      T* dca = static_cast<T*>(p.dca) + row_off * Cc;
      for (int i = threadIdx.x; i < p.TT * Cc; i += NT) {
        const int j = H + i / Cc, ch = i % Cc;
        if (w.valid(j))
          dca[(size_t)(w.win0 + j) * Cc + ch] = from_f<T>(b.DC[j * Cc + ch]);
      }
      T* du = static_cast<T*>(p.du) + row_off * Rin;
      T* dv = static_cast<T*>(p.dv) + row_off * Rin;
      for (int i = threadIdx.x; i < p.TT * Rin; i += NT) {
        const int j = H + i / Rin, ch = i % Rin, q = j * Rin + ch;
        float du2 = 0.f, du0 = 0.f, dv0 = 0.f;
        if (w.valid(j)) {
          const size_t g = (size_t)(w.win0 + j) * Rin + ch;
          du2 = to_f(gug[g]) * expf(-b.NET2[j * R2in + ch]);
          du0 = rnd<T>(b.DX[q] + du2 * as[3 * Rin + ch]);
          dv0 = b.DV2[q] * expf(-b.NET1[j * R2in + ch]);
          du[g] = from_f<T>(du0 * as[ch]);
          dv[g] = from_f<T>(dv0 * as[Rin + ch]);
        }
        b.DU2[q] = du2;
        b.DU0[q] = du0;
        b.DV0[q] = dv0;
      }
    }
    __syncthreads();
    // ActNorm gradients over the tile's valid rows, one thread per
    // (flow, half, channel) and per s/b
    for (int q = threadIdx.x; q < 8 * Rin; q += NT) {
      const int which = q / Rin, ch = q % Rin;
      const int fh = which >> 1;          // flow*2 + half
      const bool is_b = which & 1;
      float s = 0.f;
      for (int j = s0; j < s1; ++j) {
        const int r = j * Rin + ch;
        const size_t g = (size_t)(w.win0 + j) * Rin + ch;
        float dy, x;
        switch (fh) {
          case 0: dy = b.DU0[r]; x = to_f(ug[g]); break;   // even, u half
          case 1: dy = b.DV0[r]; x = to_f(vg[g]); break;   // even, v half
          case 2: dy = b.DV3[r]; x = b.V2[r]; break;       // odd, v half
          default: dy = b.DU2[r]; x = b.U0[r]; break;      // odd, u half
        }
        s += is_b ? dy * as[fh * Rin + ch] : dy * (x + ab[fh * Rin + ch]);
      }
      slab[(is_b ? go.an_b : go.an_s) + fh * Rin + ch] += s;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Tensor-core instances: pair_fwd_kernel<bf16, STATS, true> (pair_train_fwd
// with STATS, pair_fwd without) and pair_bwd_kernel<bf16, true>
// (pair_train_bwd)
// ---------------------------------------------------------------------------
//
// All three run on the reverse pairs' tensor-core body (pair_flow_common.cuh:
// pf::coupling_net with TC, 512 threads, one CTA per (batch row, tile)
// window in shared memory, B packed by the wrapper): the forward pair is
// the even net on u0 over window rows [5, L-5) and the odd net on v3m over
// [10, L-10), the same two output regions as the reverse pair's, so the
// body runs unchanged in the forward direction.  pair_fwd, pair_train_fwd
// and the backward's recompute call the same function (pair_window_tc); the
// backward passes a hook that copies each stage's activations (h0, g0, h1,
// g1, o1, o2 in bf16, the filter|gate pre-activations in fp32) and the
// pair-level rows to its per-CTA workspace in device memory.
//
// The backward of a coupling net (net_bwd_tc) then runs every product with
// R or 2R on both sides on the tensor cores (bf16 m16n8k16, fp32 sums):
//   input gradients dY W^T (final 1x1, skip-1, res|skip-0 as one K = 2R
//   product, the transposed 3-tap convs as three shifted-row terms, the
//   conditioning 1x1 -> dc): A = the cotangent's bf16 rows through
//   ldmatrix, B = the weight packed transposed in fragment order;
//   weight gradients X^T dY over the tile's valid rows: both operands
//   through ldmatrix.trans from row-major bf16 rows (X staged from the
//   workspace into shared memory, rows past the tile's end read a zero
//   row), summed over the tile in registers and added to the CTA's fp32
//   slab once per tile.
// The zero conv (N or K = 2*R_in) and the front conv (K or N = R_in) stay
// on CUDA cores.  Every product operand is a storage-type value at the
// JAX kernel's cast points (_net_bwd: dnet, dpre2, dsk, dfg, dh1*sqrt(.5)
// and dpre0 rounded before their dots); the gate derivatives, relu masks,
// affine-update and statistics cotangents and the bias row sums stay in
// fp32.  The plain version takes the same cast points
// (ops/pair_flow_train.py: _round_grad).
//
// Shared memory in the backward, after the recompute (rows of a net's
// cotangent region [a, e), at most L - 20 = TT + 20, with 16-byte row
// pads): P0 holds dpre2, then dfg1, then dfg0 ([rows][2R+8]); P1 dsk, then
// dpre0; P2 dg1, then dh1 * sqrt(.5); P3 the activation rows of the
// current weight-gradient product, the conditioning columns (tc_cond_cols
// at a time) and dg0; plus the fp32 dnet rows.  At TT = 64 that is 226
// KB, the recompute 221 KB (R = 256, R_in = 8), so one CTA per SM, 16
// warps.
// Everything else of the window lives in the workspace: bf16 activations
// and fp32 pre-activations of both nets (1.5 MB per CTA at TT = 64, R =
// 256), read back with coalesced loads.

using bf = __nv_bfloat16;
constexpr int TNT = pf::NT;          // threads of the tensor-core instances
constexpr int CCH = 80;              // conditioning columns staged at once

// Conditioning columns the backward stages at once for its cond weight
// gradient (TT rows at the row stride tc_cond_cols + 8, in P3): CCH, or R
// where R is narrower, so that the staging never needs more of P3 than
// its activation rows (TT + 20 at the stride R + 8).  A multiple of 16 at
// every R the tensor-core instances take (multiples of 32).
__host__ __device__ inline int tc_cond_cols(int R) {
  return R < CCH ? R : CCH;
}

// Transposed weights packed in fragment order (pack_tc_weights of W^T):
// kfg [2 layers][3 taps][2R/16][R/8][32], cond [2][2R/16][Cc/8][32], res
// [R/16][R/8][32], skip [2][R/16][R/8][32], fin [R/16][R/8][32] (uint2).
struct FlowT {
  const uint2 *kfg, *cond, *res, *skip, *fin;
};

struct TcArgs {
  Args p;              // the CUDA-core arguments (u, v, c, outputs, slabs)
  pf::Params pp;       // the same operands for the shared body, B packed
  FlowT ft[2];         // backward: the transposed packed weights per flow
  bf* ws;              // backward: per-CTA workspace, ws_bytes each
  long long ws_bytes;
};

// A bf16 buffer of window rows: row j lives at p + (j - org) * ld.
struct SBuf {
  bf* p;
  int ld, org;
  __device__ bf* row(int j) const { return p + (size_t)(j - org) * ld; }
};

// Workspace of one CTA (byte offsets for a window of L rows): per net the
// bf16 activations [N_ACT][L][R] and fp32 pre-activations [2][L][2R], then
// fp32 pair-level rows and the first layer's dc [L][Cc].
struct TcWs {
  long long act[2], fg[2], net1, net2, u0, v2, v3m, u3, dx, dv2, dv3, du2,
      du0, dv0, dc, total;
};

__host__ __device__ inline TcWs tc_ws(int R, int Rin, int Cc, int L) {
  TcWs w;
  long long o = 0;
  auto take = [&](long long bytes) {
    const long long at = o;
    o = (o + bytes + 255) & ~255LL;
    return at;
  };
  for (int k = 0; k < 2; ++k) {
    w.act[k] = take(2LL * pf::N_ACT * L * R);
    w.fg[k] = take(4LL * 2 * L * 2 * R);
  }
  w.net1 = take(4LL * L * 2 * Rin);
  w.net2 = take(4LL * L * 2 * Rin);
  w.u0 = take(4LL * L * Rin);
  w.v2 = take(4LL * L * Rin);
  w.v3m = take(4LL * L * Rin);
  w.u3 = take(4LL * L * Rin);
  w.dx = take(4LL * L * Rin);
  w.dv2 = take(4LL * L * Rin);
  w.dv3 = take(4LL * L * Rin);
  w.du2 = take(4LL * L * Rin);
  w.du0 = take(4LL * L * Rin);
  w.dv0 = take(4LL * L * Rin);
  w.dc = take(4LL * L * Cc);
  w.total = o;
  return w;
}

// Shared memory of the backward phases (bytes, 16-aligned offsets): P0,
// P1, P2, P3, the fp32 dnet rows, a zero row; the last entry is the size.
// P3 holds the larger of n activation rows and the conditioning staging.
__host__ __device__ inline void tc_bwd_layout(int R, int Rin, int TT,
                                              size_t off[7]) {
  const size_t n = TT + 20, ldr = R + 8, ldf = 2 * R + 8;
  const size_t p3 = n * ldr, cs = (size_t)TT * (tc_cond_cols(R) + 8);
  size_t o = 0;
  off[0] = o; o = pf::align16(o + 2 * n * ldf);
  off[1] = o; o = pf::align16(o + 2 * n * ldr);
  off[2] = o; o = pf::align16(o + 2 * n * ldr);
  off[3] = o; o = pf::align16(o + 2 * (p3 > cs ? p3 : cs));
  off[4] = o; o = pf::align16(o + 4 * n * 2 * Rin);
  off[5] = o; o = pf::align16(o + 16);
  off[6] = o;
}

// Dynamic shared memory of a tensor-core instance: the shared body over a
// window of TT + 2*halo rows, and in the backward the larger of that and
// the backward phases.
__host__ __device__ inline size_t tc_smem_bytes(bool bwd, int R, int Rin,
                                                int TT) {
  const int L = TT + (bwd ? 40 : 20);
  size_t off[11];
  pf::smem_layout(2, false, true, R, Rin, L, L - 10, off);
  if (!bwd) return off[10];
  size_t b[7];
  tc_bwd_layout(R, Rin, TT, b);
  return off[10] > b[6] ? off[10] : b[6];
}

// The widths the tensor-core instances take: those of the tensor-core
// reverse pair (pf::geometry_ok: R dividing 512, a multiple of 32; Cc a
// multiple of 16), a tile of at least 16 rows, and the shared memory of
// one CTA.
inline bool tc_geometry_ok(bool bwd, int R, int Rin, int Cc, int TT) {
  return pf::geometry_ok(R, Cc, true) && Rin > 0 && TT >= 16 &&
         tc_smem_bytes(bwd, R, Rin, TT) <= 232448;
}

// The backward's recompute hook: copies a stage's rows of one net to the
// workspace (pf::NoSave's interface).
struct SaveWs {
  bf* act;             // [N_ACT][L][R]
  float* pre;          // [2 layers][L][2R]
  int L, R, ld;
  __device__ void rows(int what, const void* buf, int rb, int re) const {
    const int c8 = R / 8;
    const bf* src = static_cast<const bf*>(buf);
    bf* dst = act + (size_t)what * L * R;
    for (int i = threadIdx.x; i < (re - rb) * c8; i += TNT) {
      const int j = rb + i / c8, c = (i % c8) * 8;
      *reinterpret_cast<uint4*>(dst + (size_t)j * R + c) =
          *reinterpret_cast<const uint4*>(src + (size_t)j * ld + c);
    }
  }
  __device__ void fg(int layer, int row, int n, float f, float g) const {
    float* d = pre + ((size_t)layer * L + row) * 2 * R;
    d[n] = f;
    d[R + n] = g;
  }
};

// Global rows of one pair window kept for the backward (null in the
// forward kernel): fp32 [L][2Rin] nets and [L][Rin] values.
struct PairRows {
  float *net1, *net2, *u0, *v2, *v3m, *u3;
};

// The forward pair over one window of L rows whose tile is [H, L-H): both
// coupling nets on the tensor cores (pf::coupling_net) and the affine
// updates, with the cast points of pair_fwd_window.  Writes u3, v3 of the
// tile's valid rows to uo / vo (this batch row's [T][Rin]) unless null,
// and adds this thread's share of the tile's statistics to st (raw -log_s
// sum, max|log_s|, sum log_s^2, hinge sum).
template <class Save>
__device__ void pair_window_tc(const pf::Params& pp, const pf::Smem& s,
                               int brow, int win0, int L, int H, float mg,
                               bf* uo, bf* vo, float (&st)[4],
                               const Save& save0, const Save& save1,
                               const PairRows& pr) {
  const int Rin = pp.Rin, R2in = 2 * Rin, T_ = pp.T;
  const bf* ug = static_cast<const bf*>(pp.u) + (size_t)brow * T_ * Rin;
  const bf* vg = static_cast<const bf*>(pp.v) + (size_t)brow * T_ * Rin;
  const float *as = pp.an_s, *ab = pp.an_b;   // [flow][half][Rin]
  bf* U0 = static_cast<bf*>(s.U);
  bf* V3M = static_cast<bf*>(s.UM);
  auto valid = [&](int j) {
    const int pos = win0 + j;
    return pos >= 0 && pos < T_;
  };
  auto stat = [&](float ls) {
    st[0] -= ls;
    st[1] = fmaxf(st[1], fabsf(ls));
    st[2] += ls * ls;
    const float e = fmaxf(fabsf(ls) - mg, 0.f);
    st[3] += e * e;
  };
  for (int i = threadIdx.x; i < L * Rin; i += TNT) {
    const int j = i / Rin, ch = i % Rin;
    const bool ok = valid(j);
    const float uu = ok ? to_f(ug[(size_t)(win0 + j) * Rin + ch]) : 0.f;
    const float u0 = ok ? rnd<bf>((uu + ab[ch]) * as[ch]) : 0.f;
    U0[i] = from_f<bf>(u0);
    if (pr.u0) pr.u0[i] = u0;
  }
  __syncthreads();
  pf::coupling_net<bf, false, pf::COND_DENSE, false, 0, true, Save>(
      pp, pp.flow[0], s, U0, 5, L - 5, pp.ca, 0.f, brow, win0, save0);
  for (int i = threadIdx.x; i < (L - 10) * Rin; i += TNT) {
    const int j = 5 + i / Rin, ch = i % Rin, q = j * Rin + ch;
    const bool ok = valid(j);
    const float* net = s.net + (size_t)(j - 5) * R2in;
    const float ls = net[ch], t = net[Rin + ch];
    const float vv = ok ? to_f(vg[(size_t)(win0 + j) * Rin + ch]) : 0.f;
    const float v0 = (vv + ab[Rin + ch]) * as[Rin + ch];
    const float v2 = (v0 - t) * expf(-ls);
    const float v3 = (v2 + ab[2 * Rin + ch]) * as[2 * Rin + ch];
    const float v3m = ok ? rnd<bf>(v3) : 0.f;
    s.VA[q] = v3;
    V3M[q] = from_f<bf>(v3m);
    if (ok && j >= H && j < L - H) stat(ls);
    if (pr.net1) {
      pr.net1[j * R2in + ch] = ls;
      pr.net1[j * R2in + Rin + ch] = t;
      pr.v2[q] = v2;
      pr.v3m[q] = v3m;
    }
  }
  __syncthreads();
  pf::coupling_net<bf, false, pf::COND_DENSE, false, 0, true, Save>(
      pp, pp.flow[1], s, V3M, 10, L - 10, pp.cb, 0.f, brow, win0, save1);
  for (int i = threadIdx.x; i < (L - 20) * Rin; i += TNT) {
    const int j = 10 + i / Rin, ch = i % Rin, q = j * Rin + ch;
    const float* net = s.net + (size_t)(j - 10) * R2in;
    const float ls = net[ch], t = net[Rin + ch];
    const float u2 = (to_f(U0[q]) + ab[3 * Rin + ch]) * as[3 * Rin + ch];
    const float u3 = (u2 - t) * expf(-ls);
    const bool ok = valid(j), in_tile = j >= H && j < L - H;
    if (ok && in_tile) {
      stat(ls);
      if (uo) {
        const size_t g = (size_t)(win0 + j) * Rin + ch;
        uo[g] = from_f<bf>(u3);
        vo[g] = from_f<bf>(s.VA[q]);
      }
    }
    if (pr.net2) {
      pr.net2[j * R2in + ch] = ls;
      pr.net2[j * R2in + Rin + ch] = t;
      pr.u3[q] = u3;
    }
  }
  __syncthreads();
}

// The pf::Smem of a window of L rows at the start of dynamic shared memory.
__device__ inline pf::Smem tc_smem(unsigned char* raw, int R, int Rin,
                                   int L) {
  size_t off[11];
  pf::smem_layout(2, false, true, R, Rin, L, L - 10, off);
  pf::Smem s;
  s.ldh = pf::row_ld_h(R, true);
  s.ldq = pf::row_ld_q(R, true);
  s.S = reinterpret_cast<float*>(raw + off[0]);
  s.net = reinterpret_cast<float*>(raw + off[1]);
  s.VA = reinterpret_cast<float*>(raw + off[2]);
  s.red = reinterpret_cast<float*>(raw + off[3]);
  s.H = raw + off[4];
  s.G = raw + off[5];
  s.U = raw + off[6];
  s.V = raw + off[7];
  s.UM = raw + off[8];
  s.Q = nullptr;
  return s;
}

// pair_train_fwd (STATS) or pair_fwd on the tensor cores: one CTA per
// (batch row, tile of TT rows), a 10-row halo per side (the pair's
// receptive field); pair_fwd reduces and stores only the -log_s sum.
template <bool STATS>
__device__ void pair_fwd_tc(const TcArgs& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[TNT / 32];
  const Args& p = a.p;
  const int L = p.TT + 20;
  const pf::Smem s = tc_smem(smem_raw, p.R, p.Rin, L);
  const int tile = blockIdx.x, brow = tile / p.n_t;
  const int win0 = (tile % p.n_t) * p.TT - 10;
  float st[4] = {0.f, 0.f, 0.f, 0.f};
  pair_window_tc(a.pp, s, brow, win0, L, 10, p.margin,
                 static_cast<bf*>(p.u_out) + (size_t)brow * p.T * p.Rin,
                 static_cast<bf*>(p.v_out) + (size_t)brow * p.T * p.Rin, st,
                 pf::NoSave{}, pf::NoSave{}, PairRows{});
  const float raw = block_reduce<false, TNT>(st[0], red);
  float mx = 0.f, sq = 0.f, hq = 0.f;
  if (STATS) {
    mx = block_reduce<true, TNT>(st[1], red);
    sq = block_reduce<false, TNT>(st[2], red);
    hq = block_reduce<false, TNT>(st[3], red);
  }
  if (threadIdx.x == 0) {
    float* o = p.st + (size_t)tile * 4;
    o[0] = raw;
    o[1] = mx;
    o[2] = sq;
    o[3] = hq;
  }
}

// Warp-item product over output rows [rb, re): out(r, n) = sum over the
// NTERM terms of A_t[r + shift_t][:16*nks_t] . B_t[:, n] for n < N, B_t a
// transposed weight packed in fragment order (lane offset included, N/8
// n-tiles per k-step).  A warp item is MT 16-row m-tiles x TW n-tiles,
// m-tiles fastest; rows past re are clamped to re - 1 and never emitted.
struct Term {
  SBuf a;
  int shift;
  const uint2* b;
  int nks;
};

// No global operand for an epilogue.
struct NoPre {
  __device__ float operator()(int, int) const { return 0.f; }
};

// pre(row, n) fetches what the epilogue needs from device memory for each
// element before the products start, so those loads overlap them;
// epi(row, n, v, x) gets the product v and pre's x.  A warp item takes
// MT = 2 m-tiles, which share each B fragment it loads.
template <int TW, int NTERM, class Epi, class Pre = NoPre>
__device__ void tc_rowprod(const Term (&t)[NTERM], int rb, int re, int N,
                           Epi epi, Pre pre = Pre{}) {
  constexpr int MT = 2;
  const int lane = threadIdx.x & 31, n_mt = (re - rb + 15) >> 4;
  const int n_it = (n_mt + MT - 1) / MT;
  const int ntl = N / 8, items = n_it * (N / (8 * TW));
  for (int it = threadIdx.x >> 5; it < items; it += TNT / 32) {
    const int m0 = rb + 16 * MT * (it % n_it), t0 = TW * (it / n_it);
    float x[MT][TW][4];
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int j = 0; j < TW; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[u][j][i] = pre(min(m0 + 16 * u + tc::frag_row(i), re - 1),
                           tc::frag_col(t0 + j, i));
    float c[MT][TW][4] = {};
#pragma unroll
    for (int q = 0; q < NTERM; ++q) {
      const bf* ar[MT];
#pragma unroll
      for (int u = 0; u < MT; ++u)
        ar[u] = t[q].a.row(min(m0 + 16 * u + (lane & 15), re - 1) +
                           t[q].shift) + (lane >> 4) * 8;
      const uint2* B = t[q].b;
#pragma unroll 2
      for (int ks = 0; ks < t[q].nks; ++ks) {
        uint2 b[TW];
#pragma unroll
        for (int j = 0; j < TW; ++j) b[j] = tc::tc_b(B, ntl, ks, t0 + j);
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          uint32_t af[4];
          tc::ldsm_x4(af, ar[u] + ks * 16);
#pragma unroll
          for (int j = 0; j < TW; ++j) tc::mma_bf16(c[u][j], af, b[j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int j = 0; j < TW; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + 16 * u + tc::frag_row(i);
          if (row < re)
            epi(row, tc::frag_col(t0 + j, i), c[u][j][i], x[u][j][i]);
        }
  }
}

// Weight gradient: out[m][n] (row stride ldo, fp32) += sum over rows r in
// [s0, s1) of X[r + shift][m] * Y[r][n], m < M, n < N (M a multiple of
// 16, N of 32); first: out = the sum (the slab's first tile, which writes
// every slab entry, so the slab needs no zeroing and no read).  Both
// operands through ldmatrix.trans; the reduction runs over 16-row k-steps
// from s0, and rows at or past s1 read the zero row, so they add nothing.
// A warp item is a 16 x 32 block of out, summed over the tile in registers
// and added once.
__device__ void tc_wgrad(SBuf X, int shift, SBuf Y, int M, int N, int s0,
                         int s1, float* out, int ldo, const bf* zero,
                         bool first) {
  const int lane = threadIdx.x & 31, q = lane >> 3, l8 = lane & 7;
  const int n_mt = M / 16, nks = (s1 - s0 + 15) >> 4;
  for (int it = threadIdx.x >> 5; it < n_mt * (N / 32); it += TNT / 32) {
    const int m0 = 16 * (it % n_mt), n0 = 32 * (it / n_mt);
    // this lane's 8 pairs of the slab block (rows frag_row(0) + 8h, columns
    // frag_col(j, 0) + {0, 1}), read before the products so the read of
    // the read-modify-write overlaps them
    float* ob = out + (size_t)(m0 + tc::frag_row(0)) * ldo + n0 +
                tc::frag_col(0, 0);
    float2 old[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        old[j][h] = first ? make_float2(0.f, 0.f)
                          : *reinterpret_cast<const float2*>(
                                ob + 8 * h * ldo + 8 * j);
    float c[4][4] = {};
    for (int ks = 0; ks < nks; ++ks) {
      // A = X^T: matrix q holds rows k0 + 8(q >> 1) .. +7 (the reduction
      // index), channels m0 + 8(q & 1) .. +7
      const int ka = s0 + 16 * ks + 8 * (q >> 1) + l8;
      uint32_t af[4];
      tc::ldsm_x4_trans(af, ka < s1 ? X.row(ka + shift) + m0 + 8 * (q & 1)
                                    : zero);
      // B = Y: matrix q holds rows k0 + 8(q & 1) .. +7 of n-tile j + (q >> 1)
      // (rows at or past s1 may lie past Y's buffer: the zero row too, as
      // 0 times a stale NaN would not be 0)
      const int kb = s0 + 16 * ks + 8 * (q & 1) + l8;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b4[4];
        tc::ldsm_x4_trans(b4, kb < s1 ? Y.row(kb) + n0 + 16 * jj + 8 * (q >> 1)
                                      : zero);
        tc::mma_bf16(c[2 * jj], af, make_uint2(b4[0], b4[1]));
        tc::mma_bf16(c[2 * jj + 1], af, make_uint2(b4[2], b4[3]));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(ob + 8 * h * ldo + 8 * j) =
            make_float2(old[j][h].x + c[j][2 * h],
                        old[j][h].y + c[j][2 * h + 1]);
  }
}

// Copies rows [rb, re) of a workspace activation ([L][R] bf16) into the
// shared buffer dst (padded stride), 16 bytes per thread.
__device__ void stage_rows(SBuf dst, const bf* src, int R, int rb, int re) {
  const int c8 = R / 8, n = (re - rb) * c8;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * TNT) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = min(i0 + k * TNT, n - 1);
      v[k] = *reinterpret_cast<const uint4*>(
          src + (size_t)(rb + i / c8) * R + (i % c8) * 8);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * TNT;
      if (i < n)
        *reinterpret_cast<uint4*>(dst.row(rb + i / c8) + (i % c8) * 8) = v[k];
    }
  }
}

// A slab entry += v, or = v on the CTA's first tile (tc_wgrad's first).
__device__ __forceinline__ void slab_add(float& slot, float v, bool first) {
  slot = first ? v : slot + v;
}

// slab[c] += sum over rows [s0, s1) of buf[r][c] for c < N, one thread
// per column, rows in order.
__device__ void col_sums(SBuf buf, int N, int s0, int s1, float* slab,
                         bool first) {
  for (int c = threadIdx.x; c < N; c += TNT) {
    float s = 0.f;
    for (int r = s0; r < s1; ++r) s += to_f(buf.row(r)[c]);
    slab_add(slab[c], s, first);
  }
}

// The backward phases' shared buffers for a net whose cotangent region
// starts at window row a.
struct BwdSmem {
  bf *p0, *p1, *p2, *p3;
  float* dnet;                   // [rows][2Rin] from window row a
  const bf* zero;                // 16 zero bytes
  int R;
  __device__ SBuf wide(int a) const { return SBuf{p0, 2 * R + 8, a}; }
  __device__ SBuf buf(bf* p, int org) const { return SBuf{p, R + 8, org}; }
};

// One net's backward given dnet rows [a, e) in sm.dnet (tile rows [s0,
// s1), window start win0): weight gradients into d, the net input's
// gradient over [a+5, e-5) into DX (fp32 [L][Rin]), and dc of the tile's
// valid rows into dc_out (this batch row's [T][Cc]).  X: the net input
// (fp32 values of its bf16 rows, [L][Rin]); C: this batch row's c.
__device__ void net_bwd_tc(const pf::Flow& f, const FlowT& ft,
                           const FlowGrad& d, const bf* act, const float* fg,
                           const float* X, const bf* C, float* DX,
                           float* DCW, bf* dc_out, const BwdSmem& sm, int a,
                           int e, int s0, int s1, int win0, int L, int T_,
                           int R, int Rin, int Cc, bool first) {
  const int R2 = 2 * R, R2in = 2 * Rin, nkr = R / 16;
  const int lane = threadIdx.x & 31;
  auto valid = [&](int j) {
    const int pos = win0 + j;
    return pos >= 0 && pos < T_;
  };
  auto A = [&](int what, int j) {
    return act + ((size_t)what * L + j) * R;
  };
  const SBuf P0 = sm.buf(sm.p0, a), P1 = sm.buf(sm.p1, a),
             P2 = sm.buf(sm.p2, a), P3a = sm.buf(sm.p3, a),
             DFG = sm.wide(a);
  const float* dnet = sm.dnet;
  const bf* zw = static_cast<const bf*>(f.zw);

  // zero conv (CUDA cores): d zb (fp32 dnet), d zw (rounded dnet), and
  // dpre2 = relu'(o2) * rnd(rnd(dnet) zw^T) -> P0
  for (int c = threadIdx.x; c < R2in; c += TNT) {
    float s = 0.f;
    for (int r = s0; r < s1; ++r) s += dnet[(r - a) * R2in + c];
    slab_add(d.zb[c], s, first);
  }
  for (int i = threadIdx.x; i < R * R2in; i += TNT) {
    const int m = i / R2in, c = i % R2in;
    float s = 0.f;
#pragma unroll 8
    for (int r = s0; r < s1; ++r)
      s += to_f(A(pf::ACT_O2, r)[m]) * rnd<bf>(dnet[(r - a) * R2in + c]);
    slab_add(d.zw[i], s, first);
  }
  for (int i0 = threadIdx.x; i0 < (e - a) * R; i0 += 4 * TNT) {
    float o2[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = min(i0 + k * TNT, (e - a) * R - 1);
      o2[k] = to_f(A(pf::ACT_O2, a + i / R)[i % R]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * TNT, r = a + i / R, c = i % R;
      if (i >= (e - a) * R) break;
      float v = 0.f;
      if (o2[k] > 0.f) {
        for (int j = 0; j < R2in; ++j)
          v += rnd<bf>(dnet[(r - a) * R2in + j]) *
               to_f(zw[(size_t)c * R2in + j]);
        v = rnd<bf>(v);
      }
      P0.row(r)[c] = from_f<bf>(v);
    }
  }
  const SBuf O1 = sm.buf(sm.p3, s0);
  stage_rows(O1, A(pf::ACT_O1, 0), R, s0, s1);
  __syncthreads();
  col_sums(P0, R, s0, s1, d.fin_b, first);
  // final 1x1: d fin_w; dsk = relu'(o1) * rnd(dpre2 fin^T) -> P1
  tc_wgrad(O1, 0, P0, R, R, s0, s1, d.fin_w, R, sm.zero, first);
  {
    const Term t[1] = {{P0, 0, ft.fin + lane, nkr}};
    tc_rowprod<4>(
        t, a, e, R,
        [&](int r, int c, float v, float o1) {
          P1.row(r)[c] = from_f<bf>(o1 > 0.f ? rnd<bf>(v) : 0.f);
        },
        [&](int r, int c) { return to_f(A(pf::ACT_O1, r)[c]); });
  }
  __syncthreads();
  for (int c = threadIdx.x; c < R; c += TNT) {
    float s = 0.f;
    for (int r = s0; r < s1; ++r) s += to_f(P1.row(r)[c]);
    slab_add(d.skip_b[c], s, first);
    slab_add(d.skip_b[R + c], s, first);
  }
  const SBuf G1 = sm.buf(sm.p3, s0);
  stage_rows(G1, A(pf::ACT_G1, 0), R, s0, s1);
  __syncthreads();
  // skip-1: d skip_w1; dg1 = rnd(dsk skip1^T) -> P2
  tc_wgrad(G1, 0, P1, R, R, s0, s1, d.skip_w + (size_t)R * R, R, sm.zero, first);
  {
    const Term t[1] = {{P1, 0, ft.skip + (size_t)nkr * (R / 8) * 32 + lane,
                        nkr}};
    tc_rowprod<4>(t, a, e, R, [&](int r, int c, float v, float) {
      P2.row(r)[c] = from_f<bf>(v);
    });
  }
  __syncthreads();
  // gate 1 (fp32): dfg1 -> DFG rounded, d cond_b1 from the fp32 values;
  // gate 0 likewise over [a+3, e-3) from dg0 in P3
  // (8 rows' pre-activations loaded at once)
  auto gate_bwd = [&](int layer, SBuf dg, int rb, int re) {
    const float* fgl = fg + (size_t)layer * L * R2;
    for (int c = threadIdx.x; c < R2; c += TNT) {
      const int n = c < R ? c : c - R;
      float bs = 0.f;
      for (int r0 = rb; r0 < re; r0 += 8) {
        float fv[8], gv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = min(r0 + i, re - 1);
          fv[i] = fgl[(size_t)r * R2 + n];
          gv[i] = fgl[(size_t)r * R2 + R + n];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + i;
          if (r >= re) break;
          const float t = tanhf(fv[i]), sg = 1.f / (1.f + expf(-gv[i]));
          const float g = to_f(dg.row(r)[n]);
          const float v = c < R ? g * sg * (1.f - t * t)
                                : g * t * sg * (1.f - sg);
          DFG.row(r)[c] = from_f<bf>(v);
          if (r >= s0 && r < s1) bs += v;
        }
      }
      slab_add(d.cond_b[layer * R2 + c], bs, first);
    }
  };
  gate_bwd(1, P2, a, e);
  const SBuf H1 = sm.buf(sm.p3, s0 - 3);
  stage_rows(H1, A(pf::ACT_H1, 0), R, s0 - 3, s1 + 3);
  __syncthreads();
  // layer 1 (d=3): d kfg1; dh1 * sqrt(.5), masked and rounded twice (the
  // cotangent of h1, then of the residual sum) -> P2; dc of layer 1 -> DCW
  for (int k = 0; k < 3; ++k)
    tc_wgrad(H1, 3 * (k - 1), DFG, R, R2, s0, s1,
             d.kfg + (size_t)(3 + k) * R * R2, R2, sm.zero, first);
  {
    const size_t tap = (size_t)(R2 / 16) * (R / 8) * 32;
    const uint2* kt = ft.kfg + 3 * tap + lane;
    const Term t[3] = {{DFG, 3, kt, R2 / 16},
                       {DFG, 0, kt + tap, R2 / 16},
                       {DFG, -3, kt + 2 * tap, R2 / 16}};
    tc_rowprod<4>(t, a + 3, e - 3, R, [&](int r, int c, float v, float) {
      P2.row(r)[c] = from_f<bf>(
          valid(r) ? rnd<bf>(rnd<bf>(v) * SQRT_HALF) : 0.f);
    });
    const Term tc1[1] = {{DFG, 0,
                          ft.cond + (size_t)(R2 / 16) * (Cc / 8) * 32 + lane,
                          R2 / 16}};
    tc_rowprod<2>(tc1, s0, s1, Cc, [&](int r, int c, float v, float) {
      DCW[(size_t)r * Cc + c] = v;
    });
  }
  __syncthreads();
  // d cond_w1 = c^T dfg1 over the tile, tc_cond_cols(R) columns of c at a
  // time
  auto cond_wgrad = [&](int layer) {
    const int cch = tc_cond_cols(R);
    for (int c0 = 0; c0 < Cc; c0 += cch) {
      const int cw = min(cch, Cc - c0);
      const SBuf Cs{sm.p3, cch + 8, s0};
      for (int i = threadIdx.x; i < (s1 - s0) * (cw / 8); i += TNT) {
        const int r = s0 + i / (cw / 8), c = (i % (cw / 8)) * 8;
        *reinterpret_cast<uint4*>(Cs.row(r) + c) =
            *reinterpret_cast<const uint4*>(
                C + (size_t)(win0 + r) * Cc + c0 + c);
      }
      __syncthreads();
      tc_wgrad(Cs, 0, DFG, cw, R2, s0, s1,
               d.cond_w + ((size_t)layer * Cc + c0) * R2, R2, sm.zero, first);
      __syncthreads();
    }
  };
  cond_wgrad(1);
  col_sums(P2, R, s0, s1, d.res_b, first);
  const SBuf G0 = sm.buf(sm.p3, s0);
  stage_rows(G0, A(pf::ACT_G0, 0), R, s0, s1);
  __syncthreads();
  // res | skip-0: d res_w, d skip_w0; dg0 = rnd(dh1h res^T + dsk skip0^T)
  // -> P3 (after the weight products are done with g0)
  tc_wgrad(G0, 0, P2, R, R, s0, s1, d.res_w, R, sm.zero, first);
  tc_wgrad(G0, 0, P1, R, R, s0, s1, d.skip_w, R, sm.zero, first);
  __syncthreads();
  {
    const Term t[2] = {{P2, 0, ft.res + lane, nkr},
                       {P1, 0, ft.skip + lane, nkr}};
    tc_rowprod<4>(t, a + 3, e - 3, R, [&](int r, int c, float v, float) {
      P3a.row(r)[c] = from_f<bf>(v);
    });
  }
  __syncthreads();
  gate_bwd(0, P3a, a + 3, e - 3);
  __syncthreads();
  const SBuf H0 = sm.buf(sm.p3, s0 - 1);
  stage_rows(H0, A(pf::ACT_H0, 0), R, s0 - 1, s1 + 1);
  __syncthreads();
  // layer 0 (d=1): d kfg0; dpre0 = relu'(h0) * rnd(dfg0 conv^T + dh1h),
  // masked -> P1; dc = layer 1's + layer 0's -> dc_out
  for (int k = 0; k < 3; ++k)
    tc_wgrad(H0, k - 1, DFG, R, R2, s0, s1, d.kfg + (size_t)k * R * R2, R2,
             sm.zero, first);
  {
    const size_t tap = (size_t)(R2 / 16) * (R / 8) * 32;
    const uint2* kt = ft.kfg + lane;
    const Term t[3] = {{DFG, 1, kt, R2 / 16},
                       {DFG, 0, kt + tap, R2 / 16},
                       {DFG, -1, kt + 2 * tap, R2 / 16}};
    tc_rowprod<4>(
        t, a + 4, e - 4, R,
        [&](int r, int c, float v, float h0) {
          const float dh = v + to_f(P2.row(r)[c]);
          P1.row(r)[c] = from_f<bf>(valid(r) && h0 > 0.f ? rnd<bf>(dh) : 0.f);
        },
        [&](int r, int c) { return to_f(A(pf::ACT_H0, r)[c]); });
    const Term tc0[1] = {{DFG, 0, ft.cond + lane, R2 / 16}};
    tc_rowprod<2>(
        tc0, s0, s1, Cc,
        [&](int r, int c, float v, float dc1) {
          dc_out[(size_t)(win0 + r) * Cc + c] = from_f<bf>(dc1 + v);
        },
        [&](int r, int c) { return DCW[(size_t)r * Cc + c]; });
  }
  __syncthreads();
  cond_wgrad(0);
  // front conv (CUDA cores): d front_b, d front_w = x^T dpre0 per tap,
  // dx over [a+5, e-5) (a warp per row and channel, fixed-order shuffles)
  col_sums(P1, R, s0, s1, d.front_b, first);
  for (int i = threadIdx.x; i < 3 * Rin * R; i += TNT) {
    const int k = i / (Rin * R), ci = (i / R) % Rin, c = i % R;
    float s = 0.f;
#pragma unroll 8
    for (int r = s0; r < s1; ++r)
      s += X[(r + k - 1) * Rin + ci] * to_f(P1.row(r)[c]);
    slab_add(d.front_w[i], s, first);
  }
  const bf* fw = static_cast<const bf*>(f.front_w);
  for (int w = threadIdx.x >> 5; w < (e - a - 10) * Rin; w += TNT / 32) {
    const int r = a + 5 + w / Rin, ci = w % Rin;
    float s = 0.f;
    for (int k = 0; k < 3; ++k) {
      const bf* dp = P1.row(r - (k - 1));
      const bf* wk = fw + ((size_t)k * Rin + ci) * R;
      for (int c = lane; c < R; c += 32) s += to_f(dp[c]) * to_f(wk[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) DX[r * Rin + ci] = s;
  }
  __syncthreads();
}

// pair_train_bwd on the tensor cores: a persistent grid (one CTA per SM,
// each walking tiles c, c+G, ...), a 20-row halo per side, a per-CTA fp32
// slab as in the CUDA-core instance.  A CTA's first tile writes every
// slab entry (first), so the slab is neither zeroed nor read for it.
__device__ void pair_bwd_tc(const TcArgs& ta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Args& p = ta.p;
  const int H = 20, L = p.TT + 2 * H, Rin = p.Rin, R2in = 2 * Rin;
  const int R = p.R, Cc = p.Cc;
  const pf::Smem s = tc_smem(smem_raw, R, Rin, L);
  size_t bo[7];
  tc_bwd_layout(R, Rin, p.TT, bo);
  BwdSmem sm;
  sm.p0 = reinterpret_cast<bf*>(smem_raw + bo[0]);
  sm.p1 = reinterpret_cast<bf*>(smem_raw + bo[1]);
  sm.p2 = reinterpret_cast<bf*>(smem_raw + bo[2]);
  sm.p3 = reinterpret_cast<bf*>(smem_raw + bo[3]);
  sm.dnet = reinterpret_cast<float*>(smem_raw + bo[4]);
  bf* zero = reinterpret_cast<bf*>(smem_raw + bo[5]);
  sm.zero = zero;
  sm.R = R;

  unsigned char* wsb = reinterpret_cast<unsigned char*>(ta.ws) +
                       (long long)blockIdx.x * ta.ws_bytes;
  const TcWs wo = tc_ws(R, Rin, Cc, L);
  auto fws = [&](long long off) {
    return reinterpret_cast<float*>(wsb + off);
  };
  bf* act[2] = {reinterpret_cast<bf*>(wsb + wo.act[0]),
                reinterpret_cast<bf*>(wsb + wo.act[1])};
  float* fgw[2] = {fws(wo.fg[0]), fws(wo.fg[1])};
  const SaveWs save0{act[0], fgw[0], L, R, s.ldh};
  const SaveWs save1{act[1], fgw[1], L, R, s.ldh};
  const PairRows pr{fws(wo.net1), fws(wo.net2), fws(wo.u0), fws(wo.v2),
                    fws(wo.v3m), fws(wo.u3)};
  float *DX = fws(wo.dx), *DV2 = fws(wo.dv2), *DV3 = fws(wo.dv3),
        *DU2 = fws(wo.du2), *DU0 = fws(wo.du0), *DV0 = fws(wo.dv0),
        *DCW = fws(wo.dc);

  float* slab = p.slab + (long long)blockIdx.x * p.grad_floats;
  const GradOff go = grad_offsets(R, Rin, Cc);
  const FlowGrad d0 = flow_grad(slab, go, 0, R, Rin, Cc);
  const FlowGrad d1 = flow_grad(slab, go, 1, R, Rin, Cc);
  const float gr = p.gsc[0], gq = p.gsc[1], gh = p.gsc[2], mg = p.margin;
  const float *as = p.an_s, *ab = p.an_b;
  __syncthreads();

  for (int tile = blockIdx.x; tile < p.B * p.n_t; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int brow = tile / p.n_t;
    const int win0 = (tile % p.n_t) * p.TT - H;
    const Win w{win0, p.T, L};
    const size_t row_off = (size_t)brow * p.T;
    const bf* ug = static_cast<const bf*>(p.u) + row_off * Rin;
    const bf* vg = static_cast<const bf*>(p.v) + row_off * Rin;
    const bf* gug = static_cast<const bf*>(p.gu) + row_off * Rin;
    const bf* gvg = static_cast<const bf*>(p.gv) + row_off * Rin;
    const bf* ca = static_cast<const bf*>(p.ca) + row_off * Cc;
    const bf* cb = static_cast<const bf*>(p.cb) + row_off * Cc;
    const int s0 = max(H, -win0), s1 = min(L - H, p.T - win0);
    auto st_term = [=](float ls, int j) -> float {
      if (!w.valid(j)) return 0.f;
      const float ex = fmaxf(fabsf(ls) - mg, 0.f);
      return -gr + gq * 2.f * ls + gh * 2.f * ex * copysignf(1.f, ls);
    };

    float st[4] = {0.f, 0.f, 0.f, 0.f};
    pair_window_tc(ta.pp, s, brow, win0, L, H, mg, nullptr, nullptr, st,
                   save0, save1, pr);
    if (threadIdx.x < 8) zero[threadIdx.x] = from_f<bf>(0.f);

    // odd coupling: dnet2 over [10, L-10)
    for (int i = threadIdx.x; i < (L - 20) * Rin; i += TNT) {
      const int j = 10 + i / Rin, ch = i % Rin;
      float dls = 0.f, dt = 0.f;
      if (w.valid(j)) {
        const float gu = to_f(gug[(size_t)(win0 + j) * Rin + ch]);
        const float ls = pr.net2[j * R2in + ch];
        dls = -gu * pr.u3[j * Rin + ch] + st_term(ls, j);
        dt = -gu * expf(-ls);
      }
      sm.dnet[(j - 10) * R2in + ch] = dls;
      sm.dnet[(j - 10) * R2in + Rin + ch] = dt;
    }
    __syncthreads();
    net_bwd_tc(ta.pp.flow[1], ta.ft[1], d1, act[1], fgw[1], pr.v3m, cb, DX,
               DCW, static_cast<bf*>(p.dcb) + row_off * Cc, sm, 10, L - 10,
               s0, s1, win0, L, p.T, R, Rin, Cc, first);
    // dv3 over [15, L-15): output cotangent + the masked, rounded net-input
    // gradient; the even coupling's dnet1 over the same rows
    for (int i = threadIdx.x; i < (L - 30) * Rin; i += TNT) {
      const int j = 15 + i / Rin, ch = i % Rin, q = j * Rin + ch;
      float dv3 = 0.f, dls = 0.f, dt = 0.f, dv2 = 0.f;
      if (w.valid(j)) {
        dv3 = to_f(gvg[(size_t)(win0 + j) * Rin + ch]) + rnd<bf>(DX[q]);
        dv2 = dv3 * as[2 * Rin + ch];
        const float ls = pr.net1[j * R2in + ch];
        dls = -dv2 * pr.v2[q] + st_term(ls, j);
        dt = -dv2 * expf(-ls);
      }
      DV2[q] = dv2;
      DV3[q] = dv3;
      sm.dnet[(j - 15) * R2in + ch] = dls;
      sm.dnet[(j - 15) * R2in + Rin + ch] = dt;
    }
    __syncthreads();
    net_bwd_tc(ta.pp.flow[0], ta.ft[0], d0, act[0], fgw[0], pr.u0, ca, DX,
               DCW, static_cast<bf*>(p.dca) + row_off * Cc, sm, 15, L - 15,
               s0, s1, win0, L, p.T, R, Rin, Cc, first);
    // tile rows: du, dv and the per-row ActNorm terms
    {
      bf* du = static_cast<bf*>(p.du) + row_off * Rin;
      bf* dv = static_cast<bf*>(p.dv) + row_off * Rin;
      for (int i = threadIdx.x; i < p.TT * Rin; i += TNT) {
        const int j = H + i / Rin, ch = i % Rin, q = j * Rin + ch;
        float du2 = 0.f, du0 = 0.f, dv0 = 0.f;
        if (w.valid(j)) {
          const size_t g = (size_t)(win0 + j) * Rin + ch;
          du2 = to_f(gug[g]) * expf(-pr.net2[j * R2in + ch]);
          du0 = rnd<bf>(DX[q] + du2 * as[3 * Rin + ch]);
          dv0 = DV2[q] * expf(-pr.net1[j * R2in + ch]);
          du[g] = from_f<bf>(du0 * as[ch]);
          dv[g] = from_f<bf>(dv0 * as[Rin + ch]);
        }
        DU2[q] = du2;
        DU0[q] = du0;
        DV0[q] = dv0;
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < 8 * Rin; q += TNT) {
      const int which = q / Rin, ch = q % Rin;
      const int fh = which >> 1;          // flow*2 + half
      const bool is_b = which & 1;
      float sum = 0.f;
      for (int j = s0; j < s1; ++j) {
        const int r = j * Rin + ch;
        const size_t g = (size_t)(win0 + j) * Rin + ch;
        float dy, x;
        switch (fh) {
          case 0: dy = DU0[r]; x = to_f(ug[g]); break;    // even, u half
          case 1: dy = DV0[r]; x = to_f(vg[g]); break;    // even, v half
          case 2: dy = DV3[r]; x = pr.v2[r]; break;       // odd, v half
          default: dy = DU2[r]; x = pr.u0[r]; break;      // odd, u half
        }
        sum += is_b ? dy * as[fh * Rin + ch] : dy * (x + ab[fh * Rin + ch]);
      }
      slab_add(slab[(is_b ? go.an_b : go.an_s) + fh * Rin + ch], sum, first);
    }
    __syncthreads();
  }
}

template <typename T, bool STATS, bool TC>
__global__ void __launch_bounds__(TC ? TNT : NT) pair_fwd_kernel(TcArgs a) {
  if constexpr (TC) {
    static_assert(sizeof(T) == 2,
                  "the tensor-core forward pairs are bf16");
    pair_fwd_tc<STATS>(a);
  } else {
    pair_fwd_cc<T, STATS>(a.p);
  }
}

template <typename T, bool TC>
__global__ void __launch_bounds__(TC ? TNT : NT) pair_bwd_kernel(TcArgs a) {
  if constexpr (TC) {
    static_assert(sizeof(T) == 2, "the tensor-core backward is bf16");
    pair_bwd_tc(a);
  } else {
    pair_bwd_cc<T>(a.p);
  }
}

// out[i] = sum over the G slabs, in slab order.
__global__ void reduce_slabs(const float* slab, float* out, long long n,
                             int G) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < G; ++c) s += slab[(long long)c * n + i];
    out[i] = s;
  }
}

void fill_flows(Args& p, const void* const* ops, int es) {
  const size_t R = p.R, Rin = p.Rin, Cc = p.Cc, R2 = 2 * R;
  const char* base[15];
  for (int i = 0; i < 15; ++i) base[i] = static_cast<const char*>(ops[i]);
  for (int fl = 0; fl < 2; ++fl) {
    Flow& f = p.flow[fl];
    f.front_w = base[0] + fl * 3 * Rin * R * es;
    f.front_b = reinterpret_cast<const float*>(base[1]) + fl * R;
    f.kfg = base[2] + fl * 2 * 3 * R * R2 * es;
    f.cond_w = base[3] + fl * 2 * Cc * R2 * es;
    f.cond_b = reinterpret_cast<const float*>(base[4]) + fl * 2 * R2;
    f.res_w = base[5] + fl * R * R * es;
    f.res_b = reinterpret_cast<const float*>(base[6]) + fl * R;
    f.skip_w = base[7] + fl * 2 * R * R * es;
    f.skip_b = reinterpret_cast<const float*>(base[8]) + fl * 2 * R;
    f.fin_w = base[9] + fl * R * R * es;
    f.fin_b = reinterpret_cast<const float*>(base[10]) + fl * R;
    f.zw = base[11] + fl * R * 2 * Rin * es;
    f.zb = reinterpret_cast<const float*>(base[12]) + fl * 2 * Rin;
  }
  p.an_s = reinterpret_cast<const float*>(base[13]);
  p.an_b = reinterpret_cast<const float*>(base[14]);
}

void fill_dims(Args& p, const int* dims, int bwd) {
  p.B = dims[0]; p.T = dims[1]; p.Rin = dims[2]; p.R = dims[3];
  p.Cc = dims[4]; p.TT = dims[5];
  p.H = bwd ? 20 : 10;
  p.n_t = (p.T + p.TT - 1) / p.TT;
  p.ws_floats = layout(nullptr, bwd != 0, p.R, p.Rin, p.Cc, p.TT + 2 * p.H,
                       nullptr);
  p.grad_floats = grad_offsets(p.R, p.Rin, p.Cc).total;
}

}  // namespace

// The training instances on the tensor cores: all three kernels (0
// pair_fwd, 1 pair_train_fwd, 2 pair_train_bwd) in bf16.  Every fp32
// instance runs the CUDA-core GEMM.
constexpr bool tc_instance(int dtype, int kernel) {
  return dtype == 1 && kernel >= 0 && kernel <= 2;
}

// The shared body's view of the operands: pf::Flow per flow (B packed in
// fragment order for the tensor-core instances) and the pair's inputs.
pf::Params body_params(const Args& p) {
  pf::Params q = {};
  q.u = p.u; q.v = p.v; q.ca = p.ca; q.cb = p.cb;
  q.u_out = p.u_out; q.v_out = p.v_out;
  for (int fl = 0; fl < 2; ++fl) {
    const Flow& f = p.flow[fl];
    pf::Flow& g = q.flow[fl];
    g.front_w = f.front_w; g.front_b = f.front_b; g.kfg = f.kfg;
    g.cond_w = f.cond_w; g.cond_b = f.cond_b; g.res_w = f.res_w;
    g.res_b = f.res_b; g.skip_w = f.skip_w; g.skip_b = f.skip_b;
    g.fin_w = f.fin_w; g.fin_b = f.fin_b; g.zw = f.zw; g.zb = f.zb;
  }
  q.an_s = p.an_s; q.an_b = p.an_b;
  q.B = p.B; q.T = p.T; q.Rin = p.Rin; q.R = p.R; q.Cc = p.Cc;
  q.TT = p.TT; q.n_t = p.n_t;
  return q;
}

// Launches kernel k (a __global__ taking TcArgs) with the dynamic shared
// memory it needs.
template <class K>
int launch_tc(K k, int grid, size_t smem, const TcArgs& a, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, TNT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

// Workspace bytes one CTA needs: bwd 0 the forward kernels, 1 the
// backward; tc 1 the tensor-core instance (bf16 activations, fp32
// pre-activations and pair rows), 0 the CUDA-core one (fp32 floats * 4).
long long pair_train_ws_bytes(int bwd, int tc, int R, int Rin, int Cc,
                              int TT) {
  if (tc) return bwd ? tc_ws(R, Rin, Cc, TT + 40).total : 0;
  return 4 * layout(nullptr, bwd != 0, R, Rin, Cc, TT + 2 * (bwd ? 20 : 10),
                    nullptr);
}

// Dynamic shared memory of a tensor-core instance (bytes; 0 on the CUDA
// cores, which use static shared memory only).
long long pair_train_smem_bytes(int bwd, int tc, int R, int Rin, int TT) {
  return tc ? (long long)tc_smem_bytes(bwd != 0, R, Rin, TT) : 0;
}

// Threads per CTA of an instance.
int pair_train_threads(int tc) { return tc ? TNT : NT; }

// Floats of one gradient slab: the 15 folded operands' gradients.
long long pair_train_grad_floats(int R, int Rin, int Cc) {
  return grad_offsets(R, Rin, Cc).total;
}

// ptrs: u, v, c_a, c_b, u_out, v_out, st [n_tiles][4], ws, then the 15
// operands of pair_forward_operands (on the tensor cores kfg, cond_w,
// res_w, skip_w and fin_w packed by pack_tc_weights).  dims: B, T, Rin, R,
// Cc, TT, G (CTAs; the tensor-core instance takes one CTA per tile).
// dtype: 0 fp32, 1 bf16.  stats: 0 pair_fwd, 1 pair_train_fwd.  tc must
// say whether (dtype, stats) is the tensor-core instance, and that
// instance refuses widths it does not take (tc_geometry_ok).  Returns the
// cudaError_t of the launch.
int pair_train_fwd_launch(int dtype, int stats, int tc,
                          const void* const* ptrs, const int* dims,
                          float margin, void* stream) {
  if ((tc != 0) != tc_instance(dtype, stats ? 1 : 0) ||
      (tc && !tc_geometry_ok(false, dims[3], dims[2], dims[4], dims[5])))
    return (int)cudaErrorInvalidValue;
  TcArgs a = {};
  Args& p = a.p;
  fill_dims(p, dims, 0);
  p.u = ptrs[0]; p.v = ptrs[1]; p.ca = ptrs[2]; p.cb = ptrs[3];
  p.u_out = const_cast<void*>(ptrs[4]);
  p.v_out = const_cast<void*>(ptrs[5]);
  p.st = static_cast<float*>(const_cast<void*>(ptrs[6]));
  p.ws = static_cast<float*>(const_cast<void*>(ptrs[7]));
  p.margin = margin;
  fill_flows(p, ptrs + 8, dtype == 0 ? 4 : 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = dims[6];
  if (tc) {
    a.pp = body_params(p);
    return launch_tc(stats ? pair_fwd_kernel<__nv_bfloat16, true, true>
                           : pair_fwd_kernel<__nv_bfloat16, false, true>,
                     p.B * p.n_t, tc_smem_bytes(false, p.R, p.Rin, p.TT), a,
                     st);
  }
  if (stats) pair_fwd_kernel<float, true, false><<<G, NT, 0, st>>>(a);
  else pair_fwd_kernel<float, false, false><<<G, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: u, v, c_a, c_b, gu, gv, du, dv, dc_a, dc_b, gsc [3] (d raw,
// d sumsq, d hinge; device fp32), ws, slab (G * grad_floats), d_ops
// (grad_floats), then the 15 operands (packed as for the forward on the
// tensor cores), then on the tensor cores the transposed packed kfg,
// cond_w, res_w, skip_w and fin_w (FlowT).  dims as for the forward.  tc
// as for the forward: the bf16 backward is the tensor-core instance.
int pair_train_bwd_launch(int dtype, int tc, const void* const* ptrs,
                          const int* dims, float margin, void* stream) {
  if ((tc != 0) != tc_instance(dtype, 2) ||
      (tc && !tc_geometry_ok(true, dims[3], dims[2], dims[4], dims[5])))
    return (int)cudaErrorInvalidValue;
  TcArgs a = {};
  Args& p = a.p;
  fill_dims(p, dims, 1);
  p.u = ptrs[0]; p.v = ptrs[1]; p.ca = ptrs[2]; p.cb = ptrs[3];
  p.gu = ptrs[4]; p.gv = ptrs[5];
  p.du = const_cast<void*>(ptrs[6]);
  p.dv = const_cast<void*>(ptrs[7]);
  p.dca = const_cast<void*>(ptrs[8]);
  p.dcb = const_cast<void*>(ptrs[9]);
  p.gsc = static_cast<const float*>(ptrs[10]);
  p.ws = static_cast<float*>(const_cast<void*>(ptrs[11]));
  p.slab = static_cast<float*>(const_cast<void*>(ptrs[12]));
  float* d_ops = static_cast<float*>(const_cast<void*>(ptrs[13]));
  p.margin = margin;
  fill_flows(p, ptrs + 14, dtype == 0 ? 4 : 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = dims[6];
  int err;
  if (tc) {
    a.pp = body_params(p);
    const size_t R = p.R, Cc = p.Cc, R2 = 2 * R;
    const size_t sz[5] = {2 * 3 * R2 * R / 4, 2 * R2 * Cc / 4, R * R / 4,
                          2 * R * R / 4, R * R / 4};   // uint2 per flow
    for (int fl = 0; fl < 2; ++fl) {
      const uint2* q[5];
      for (int i = 0; i < 5; ++i)
        q[i] = static_cast<const uint2*>(ptrs[29 + i]) + fl * sz[i];
      a.ft[fl] = FlowT{q[0], q[1], q[2], q[3], q[4]};
    }
    a.ws = reinterpret_cast<bf*>(p.ws);
    a.ws_bytes = tc_ws(p.R, p.Rin, p.Cc, p.TT + 40).total;
    err = launch_tc(pair_bwd_kernel<__nv_bfloat16, true>, G,
                    tc_smem_bytes(true, p.R, p.Rin, p.TT), a, st);
  } else {
    pair_bwd_kernel<float, false><<<G, NT, 0, st>>>(a);
    err = (int)cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const long long n = p.grad_floats;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_slabs<<<blocks, 256, 0, st>>>(p.slab, d_ops, n, G);
  return (int)cudaGetLastError();
}

// out = registers and local (spill) bytes per thread of the instance of
// kernel (0 pair_fwd, 1 pair_train_fwd, 2 pair_train_bwd) in dtype, from
// cudaFuncGetAttributes.  Returns its cudaError_t.
int pair_train_attrs(int kernel, int dtype, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (kernel == 2)
    e = dtype == 0 ? cudaFuncGetAttributes(&a, pair_bwd_kernel<float, false>)
                   : cudaFuncGetAttributes(
                         &a, pair_bwd_kernel<__nv_bfloat16, true>);
  else if (dtype == 0)
    e = kernel == 1
            ? cudaFuncGetAttributes(&a, pair_fwd_kernel<float, true, false>)
            : cudaFuncGetAttributes(&a, pair_fwd_kernel<float, false, false>);
  else
    e = kernel == 1 ? cudaFuncGetAttributes(
                          &a, pair_fwd_kernel<__nv_bfloat16, true, true>)
                    : cudaFuncGetAttributes(
                          &a, pair_fwd_kernel<__nv_bfloat16, false, true>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}

}  // extern "C"
