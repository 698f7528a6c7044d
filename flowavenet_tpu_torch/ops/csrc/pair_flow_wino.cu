// Fused reverse flow PAIR with Winograd filter|gate convs for Hopper
// (sm_90a): the CUDA ports of the Pallas TPU kernels
// flowavenet_tpu/ops/pallas_flow.py:_pair_kernel_wino (pair_flow_wino,
// F(2,3); pair_flow_wino4, F(4,3)) and :_pair_kernel_wino_hoisted
// (pair_flow_wino[4]_hoisted), F(2,3) (P = 6, 4 multiplies per 2 outputs)
// and F(4,3) (P = 12, 6 per 4) over the G-transformed weights of
// ops/pair_flow.py pair_reverse_operands_wino[4].  The front conv, the
// conditioning 1x1s (or, hoisted, the precomputed pre-activations read
// per row), gating, res/skip, the final 1x1 and the zero conv are those of
// the direct pair.
//
// What bounds it on this card: the tensor cores' rate, as for the direct
// pair (pair_flow_common.cuh); the bound counts the Winograd's own
// multiplies (4/6 or 6/12 of the direct fg-conv operations).  The CUDA-core
// version recomputed every (group, channel) input transform once per
// output column thread, 256 times over.  The F(2,3) bf16 instance with
// dense conditioning (pair_flow_wino on the FWN_INT8=0 route) therefore
// runs on the tensor cores: a warp builds the A fragments of the four
// Winograd planes in registers from the taps in shared memory (one
// transform per warp fragment), four accumulator sets take bf16 mma.sync
// products with the packed G-transformed weights, and the output transform
// runs in fp32 on the lane's accumulators; the conditioning, res/skip and
// final 1x1s are bf16 mma.sync too.  What bounds it then: the input
// transforms on the CUDA cores and the L2 weight re-reads.  F(4,3), the
// hoisted pairs and every fp32 instance still run on CUDA cores.
//
// The TPU kernel stores every intermediate as P de-interleaved phase planes
// so that each Winograd tap is a whole shifted plane; here the taps of a
// group are read straight from the window rows in shared memory, so no
// de-interleave exists.  What the planes fix, and what this kernel must
// keep, is which rows share a group: group membership follows absolute
// position (pair_flow_common.cuh), so tiles start at multiples of P and the
// output does not depend on the tiling.

#include "pair_flow_common.cuh"

namespace {

// The one Winograd instance on the tensor cores: F(2,3) with dense
// conditioning in bf16, pair_flow_wino of the FWN_INT8=0 route.  fp32,
// F(4,3) and the hoisted pairs run the CUDA-core product.
constexpr bool tc_instance(int dtype, int P, int hoisted) {
  return dtype == 1 && P == 6 && !hoisted;
}

template <int COND>
int launch_p(int dtype, int P, const pf::Params& p, cudaStream_t st) {
  // bf16 F(2,3) with dense conditioning is the tensor-core instance
  if (P == 6)
    return dtype == 0
               ? pf::launch<float, false, COND, false, 6>(p, st)
               : pf::launch<__nv_bfloat16, false, COND, false, 6,
                            COND == pf::COND_DENSE>(p, st);
  return dtype == 0 ? pf::launch<float, false, COND, false, 12>(p, st)
                    : pf::launch<__nv_bfloat16, false, COND, false, 12>(p,
                                                                       st);
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs (bytes).  dtype: 0 fp32, 1 bf16;
// P: 6 (F(2,3)) or 12 (F(4,3)); tc: the tensor-core instance (F(2,3),
// bf16, dense conditioning).
int pair_wino_smem_bytes(int dtype, int P, int tc, int R, int Rin, int TT) {
  const int es = dtype == 0 ? 4 : 2;
  if (tc && !tc_instance(dtype, P, 0)) return -1;
  if (P == 6) return (int)pf::smem_bytes<6>(es, false, tc != 0, R, Rin, TT);
  if (P == 12) return (int)pf::smem_bytes<12>(es, false, false, R, Rin, TT);
  return -1;
}

int pair_wino_threads() { return pf::NT; }

// ptrs and dims as pair_reverse_launch (pair_flow.cu) with the 15 operands
// of pair_reverse_operands_wino[4] in the first 15 slots; TT a multiple of
// P.  hoisted != 0: the port of _pair_kernel_wino_hoisted, c_a / c_b hold
// the precomputed conditioning pre-activations [B, T, 2 layers * 2R] of
// the even / odd flow (Cc = 4R) and the cond_w slot is null.  Returns the
// cudaError_t of the launch (0 = success).  tc != 0 runs the tensor-core
// instance, whose kfg, cond_w, res_w, skip_w and fin_w come packed in
// fragment order (ops/pair_flow.py:pack_tc_weights); it takes R a multiple
// of 32 and Cc a multiple of 16.  tc must say whether (dtype, P,
// hoisted) is that instance: neither runs in the other's place.
int pair_wino_launch(int dtype, int P, int hoisted, int tc,
                     const void* const* ptrs, const int* dims,
                     void* stream) {
  if ((P != 6 && P != 12) || dims[5] % P) return (int)cudaErrorInvalidValue;
  if ((tc != 0) != tc_instance(dtype, P, hoisted) ||
      (tc && (dims[3] % 32 || dims[4] % 16)))
    return (int)cudaErrorInvalidValue;
  const pf::Params p = pf::make_params(ptrs, dims, P == 6 ? 4 : 6,
                                       dtype == 0 ? 4 : 2, false, false);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hoisted) return launch_p<pf::COND_HOIST>(dtype, P, p, st);
  return launch_p<pf::COND_DENSE>(dtype, P, p, st);
}

}  // extern "C"
