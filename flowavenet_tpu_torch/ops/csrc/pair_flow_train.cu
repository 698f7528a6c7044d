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
// This first version keeps every activation of the window in a per-CTA
// fp32 workspace in device memory and runs every product through one
// shared-memory-tiled CUDA-core GEMM (64x64 tiles, fp32 FMA); tensor cores
// and shared-memory residency of the activations are later work.
//
// Numerics mirror the Pallas kernels and the plain version
// (ops/pair_flow_train.py pair_train_fwd_ref): fp32 accumulation and
// gates; h0, h1, the gate outputs, the relu'd skip sum and the final 1x1
// output rounded to the storage type; the zero conv, the affine updates
// and the statistics in fp32.  The backward rounds the cotangent of each
// rounded activation to the storage type, as autograd through the plain
// version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Block-wide reduction of one value per thread: sum (or max); the result
// is valid in thread 0.  Fixed order, so deterministic.
template <bool MAX>
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
    for (int i = 1; i < NT / 32; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  }
  __syncthreads();
  return r;
}

template <typename T, bool STATS>
__global__ void __launch_bounds__(NT) pair_fwd_kernel(Args p) {
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
__global__ void __launch_bounds__(NT) pair_bwd_kernel(Args p) {
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

extern "C" {

// Workspace floats one CTA needs (bwd: 0 forward kernels, 1 backward).
long long pair_train_ws_floats(int bwd, int R, int Rin, int Cc, int TT) {
  return layout(nullptr, bwd != 0, R, Rin, Cc, TT + 2 * (bwd ? 20 : 10),
                nullptr);
}

// Floats of one gradient slab: the 15 folded operands' gradients.
long long pair_train_grad_floats(int R, int Rin, int Cc) {
  return grad_offsets(R, Rin, Cc).total;
}

// ptrs: u, v, c_a, c_b, u_out, v_out, st [n_tiles][4], ws, then the 15
// operands of pair_forward_operands.  dims: B, T, Rin, R, Cc, TT, G (CTAs).
// dtype: 0 fp32, 1 bf16.  stats: 0 pair_fwd, 1 pair_train_fwd.
int pair_train_fwd_launch(int dtype, int stats, const void* const* ptrs,
                          const int* dims, float margin, void* stream) {
  Args p = {};
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
  if (dtype == 0) {
    if (stats) pair_fwd_kernel<float, true><<<G, NT, 0, st>>>(p);
    else pair_fwd_kernel<float, false><<<G, NT, 0, st>>>(p);
  } else {
    if (stats) pair_fwd_kernel<__nv_bfloat16, true><<<G, NT, 0, st>>>(p);
    else pair_fwd_kernel<__nv_bfloat16, false><<<G, NT, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// ptrs: u, v, c_a, c_b, gu, gv, du, dv, dc_a, dc_b, gsc [3] (d raw,
// d sumsq, d hinge; device fp32), ws, slab (G * grad_floats), d_ops
// (grad_floats), then the 15 operands.  dims as for the forward.
int pair_train_bwd_launch(int dtype, const void* const* ptrs,
                          const int* dims, float margin, void* stream) {
  Args p = {};
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
  if (dtype == 0) pair_bwd_kernel<float><<<G, NT, 0, st>>>(p);
  else pair_bwd_kernel<__nv_bfloat16><<<G, NT, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = p.grad_floats;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_slabs<<<blocks, 256, 0, st>>>(p.slab, d_ops, n, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
