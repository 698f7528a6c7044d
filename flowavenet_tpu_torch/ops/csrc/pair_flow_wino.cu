// Fused reverse flow PAIR with Winograd filter|gate convs for Hopper
// (sm_90a): the CUDA ports of the Pallas TPU kernels
// flowavenet_tpu/ops/pallas_flow.py:_pair_kernel_wino and
// :_pair_kernel_wino_hoisted, F(2,3) (P = 6, 4 multiplies per 2 outputs)
// and F(4,3) (P = 12, 6 per 4) over the G-transformed weights of
// ops/pair_flow.py pair_reverse_operands_wino[4].  The front conv, the
// conditioning 1x1s (or, hoisted, the precomputed pre-activations read
// per row), gating, res/skip, the final 1x1 and the zero conv are those of
// the direct pair.
//
// The TPU kernel stores every intermediate as P de-interleaved phase planes
// so that each Winograd tap is a whole shifted plane; here a thread reads
// the taps of its group straight from the window rows in shared memory, so
// no de-interleave exists.  What the planes fix, and what this kernel must
// keep, is which rows share a group: group membership follows absolute
// position (pair_flow_common.cuh), so tiles start at multiples of P and the
// output does not depend on the tiling.  The design, numerics and bound
// are those of pair_flow_common.cuh; the bound counts the Winograd's own
// multiplies (4/6 or 6/12 of the direct fg-conv operations).

#include "pair_flow_common.cuh"

namespace {

template <int COND>
int launch_p(int dtype, int P, const pf::Params& p, cudaStream_t st) {
  if (P == 6)
    return dtype == 0 ? pf::launch<float, false, COND, false, 6>(p, st)
                      : pf::launch<__nv_bfloat16, false, COND, false, 6>(p,
                                                                        st);
  return dtype == 0 ? pf::launch<float, false, COND, false, 12>(p, st)
                    : pf::launch<__nv_bfloat16, false, COND, false, 12>(p,
                                                                       st);
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs (bytes).  dtype: 0 fp32, 1 bf16;
// P: 6 (F(2,3)) or 12 (F(4,3)).
int pair_wino_smem_bytes(int dtype, int P, int R, int Rin, int TT) {
  const int es = dtype == 0 ? 4 : 2;
  if (P == 6) return (int)pf::smem_bytes<6>(es, false, R, Rin, TT);
  if (P == 12) return (int)pf::smem_bytes<12>(es, false, R, Rin, TT);
  return -1;
}

int pair_wino_threads() { return pf::NT; }

// ptrs and dims as pair_reverse_launch (pair_flow.cu) with the 15 operands
// of pair_reverse_operands_wino[4] in the first 15 slots; TT a multiple of
// P.  hoisted != 0: the port of _pair_kernel_wino_hoisted, c_a / c_b hold
// the precomputed conditioning pre-activations [B, T, 2 layers * 2R] of
// the even / odd flow (Cc = 4R) and the cond_w slot is null.  Returns the
// cudaError_t of the launch (0 = success).
int pair_wino_launch(int dtype, int P, int hoisted, const void* const* ptrs,
                     const int* dims, void* stream) {
  if ((P != 6 && P != 12) || dims[5] % P) return (int)cudaErrorInvalidValue;
  const pf::Params p = pf::make_params(ptrs, dims, P == 6 ? 4 : 6,
                                       dtype == 0 ? 4 : 2, false, false);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hoisted) return launch_p<pf::COND_HOIST>(dtype, P, p, st);
  return launch_p<pf::COND_DENSE>(dtype, P, p, st);
}

}  // extern "C"
