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
// version recomputes every (group, channel) input transform once per
// output column thread, 256 times over.  Every bf16 instance (pair_flow_wino
// on the FWN_INT8=0 route, pair_flow_wino4 on FWN_WINO4=1, and their
// hoisted twins, which no model route runs) therefore runs on the tensor
// cores: a warp builds the A fragments of the four (F(2,3)) or six
// (F(4,3)) Winograd planes in registers from the taps in shared memory (one
// transform per warp fragment; F(4,3)'s in bf16x2 arithmetic), as many
// accumulator sets take bf16 mma.sync products with the packed
// G-transformed weights, and the output transform runs in fp32 on the
// lane's accumulators; the conditioning, res/skip and final 1x1s are bf16
// mma.sync too.  The hoisted twins have no conditioning product: each lane
// adds the precomputed pre-activations of its elements (bf16x2 words,
// loaded per output of a group after the taps' products); the hoisted
// F(2,3) takes one n-tile of f and g per warp item, as F(4,3) does (with
// two it spills at the 128-register cap), and its input transform in
// bf16x2.
// What bounds them then: the input transforms on the CUDA cores and the L2
// weight re-reads (one n-tile per warp item re-reads the weights twice as
// often as two); the hoisted twins do the same work less the conditioning
// product.  The front and zero convs stay on CUDA cores (R_in is 1-4 at
// the blocks these pairs take).  Every fp32 instance runs on CUDA cores.
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

// The Winograd instances on the tensor cores: F(2,3) and F(4,3) in bf16,
// with dense or hoisted conditioning (pair_flow_wino, pair_flow_wino4 and
// their _hoisted twins).  fp32 runs the CUDA-core product.
constexpr bool tc_instance(int dtype) { return dtype == 1; }

// fn(pf::Instance<...>{}) for the instance of (dtype, P, hoisted); every
// bf16 instance is a tensor-core one.
template <int P, typename Fn>
int with_p(int dtype, int hoisted, Fn fn) {
  using pf::COND_DENSE;
  using pf::COND_HOIST;
  using bf = __nv_bfloat16;
  if (dtype == 0)
    return hoisted ? fn(pf::Instance<float, false, COND_HOIST, false, P>{})
                   : fn(pf::Instance<float, false, COND_DENSE, false, P>{});
  return hoisted ? fn(pf::Instance<bf, false, COND_HOIST, false, P, true>{})
                 : fn(pf::Instance<bf, false, COND_DENSE, false, P, true>{});
}

template <typename Fn>
int with_instance(int dtype, int P, int hoisted, Fn fn) {
  if (P == 6) return with_p<6>(dtype, hoisted, fn);
  if (P == 12) return with_p<12>(dtype, hoisted, fn);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs (bytes).  dtype: 0 fp32, 1 bf16;
// P: 6 (F(2,3)) or 12 (F(4,3)); tc: a tensor-core instance (bf16).  The
// same for dense and hoisted conditioning: no Winograd instance pads its
// u/v windows (pf::pad_windows).
int pair_wino_smem_bytes(int dtype, int P, int tc, int R, int Rin, int TT) {
  const int es = dtype == 0 ? 4 : 2;
  if ((tc != 0) != tc_instance(dtype)) return -1;
  if (P == 6) return (int)pf::smem_bytes<6>(es, false, tc != 0, R, Rin, TT);
  if (P == 12) return (int)pf::smem_bytes<12>(es, false, tc != 0, R, Rin, TT);
  return -1;
}

int pair_wino_threads() { return pf::NT; }

// ptrs and dims as pair_reverse_launch (pair_flow.cu) with the 15 operands
// of pair_reverse_operands_wino[4] in the first 15 slots; TT a multiple of
// P.  hoisted != 0: the port of _pair_kernel_wino_hoisted, c_a / c_b hold
// the precomputed conditioning pre-activations [B, T, 2 layers * 2R] of
// the even / odd flow (Cc = 4R) and the cond_w slot is null.  Returns the
// cudaError_t of the launch (0 = success).  tc = 1 runs a tensor-core
// instance, whose kfg, cond_w (dense only), res_w, skip_w and fin_w come
// packed in fragment order (ops/pair_flow.py:pack_tc_weights); no
// Winograd instance takes tc = 2 (front and zero convs on the tensor
// cores).  tc must say whether dtype names such an instance: neither runs
// in the other's place.  Widths the instance does not take
// (pf::geometry_ok; hoisted c not 4R wide) are refused; the wrapper pads
// them.
int pair_wino_launch(int dtype, int P, int hoisted, int tc,
                     const void* const* ptrs, const int* dims,
                     void* stream) {
  if ((P != 6 && P != 12) || dims[5] % P || tc < 0 || tc > 1)
    return (int)cudaErrorInvalidValue;
  if ((tc != 0) != tc_instance(dtype) ||
      !pf::geometry_ok(dims[3], dims[4], tc != 0) ||
      (hoisted && dims[4] != 4 * dims[3]))
    return (int)cudaErrorInvalidValue;
  const pf::Params p = pf::make_params(ptrs, dims, P == 6 ? 4 : 6,
                                       dtype == 0 ? 4 : 2, false, false);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_instance(dtype, P, hoisted,
                       [&](auto k) { return k.launch(p, st); });
}

// out[3] = registers and local (spill) bytes per thread of the (dtype, P,
// hoisted) instance and the dynamic shared memory its last launch set,
// from cudaFuncGetAttributes.  Returns its cudaError_t.
int pair_wino_attrs(int dtype, int P, int hoisted, int* out) {
  return with_instance(dtype, P, hoisted,
                       [&](auto k) { return k.attrs(out); });
}

}  // extern "C"
