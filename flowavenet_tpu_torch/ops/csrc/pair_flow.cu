// Fused reverse flow PAIR with direct 3-tap filter|gate convs for Hopper
// (sm_90a): the CUDA port of the Pallas TPU kernels in
// flowavenet_tpu/ops/pallas_flow.py
//   _pair_kernel              variant 0 (storage-type convs),
//   _pair_kernel_i8           variant 1 (int8 fg convs and conditioning),
//   _pair_kernel_i8rs         variant 2 (variant 1 plus int8 res/skip),
//   _pair_kernel_hoisted      variant 3 (precomputed cond pre-activations),
//   _pair_kernel_hoisted_i8   variant 4 (variant 3 with int8 fg convs).
// The kernel body, its design and what bounds it are described in
// pair_flow_common.cuh; the direct variants run with a 10-row halo (the
// pair's receptive field).  Every variant in bf16 (pair_flow on the
// FWN_INT8=0 route's block 3, pair_flow_i8 on the default synthesis route,
// pair_flow_i8rs on the FWN_INT8_RS=1 route, pair_flow_hoisted on the deep
// blocks 4-7 of FWN_INT8=0 FWN_HOISTED=1, pair_flow_hoisted_i8 on blocks
// 5-7 of FWN_HOISTED=1) runs its products on the tensor cores: bf16
// mma.sync for the filter|gate convs of variants 0 and 3 and variant 0's
// conditioning 1x1s, int8 for those of variants 1, 2 and 4; res/skip in
// bf16, except in int8 on the gate codes for variant 2; the final 1x1 in
// bf16.  The hoisted variants have no conditioning product (the lanes add
// the precomputed pre-activations) and, at R_in a multiple of 16, run
// their front and zero convs on the tensor cores too, since at the deep
// blocks' R_in = 16-128 those are 2-14 % of a net's operations.  What
// bounds them is what bounds the other tensor-core pairs (the L2 weight
// traffic, pair_flow_common.cuh) and, at the deep blocks' short T, how
// full the SMs are: the wrapper picks their tile for the fewest waves
// (ops/pair_flow.py:hoisted_t_tile).  Every fp32 instance runs on CUDA
// cores (FMAs and __dp4a).  The bf16 variant 1 quantizes its activations
// with quantize_rows_bf2, which spends no integer division per element;
// what its time on the card goes to is split in pair_flow_common.cuh's
// header.

#include "pair_flow_common.cuh"

namespace {

using pf::COND_DENSE;
using pf::COND_HOIST;
using pf::COND_I8;

// variant -> (int8 fg convs, cond mode, int8 res/skip)
constexpr bool kI8[5] = {false, true, true, false, true};
constexpr bool kRS[5] = {false, false, true, false, false};

// The direct instances on the tensor cores: every variant in bf16 storage,
// with bf16 convs (variant 0, pair_flow), int8 fg convs and conditioning
// (variant 1, pair_flow_i8 of the main path), with int8 res/skip too
// (variant 2, pair_flow_i8rs), and hoisted with bf16 or int8 fg convs
// (variants 3 and 4, pair_flow_hoisted and pair_flow_hoisted_i8).  The
// fp32 instances run the CUDA-core product.
constexpr bool tc_instance(int dtype, int variant) {
  return dtype == 1 && variant >= 0 && variant <= 4;
}

// fn(pf::Instance<...>{}) for the instance of (T, variant).
template <typename T, typename Fn>
int with_variant(int variant, Fn fn) {
  constexpr bool bf = sizeof(T) == 2;
  switch (variant) {
    // bf16: the tensor-core instances; the CUDA-core ones run in fp32 only
    case 0: return fn(pf::Instance<T, false, COND_DENSE, false, 0, bf>{});
    case 1: return fn(pf::Instance<T, true, COND_I8, false, 0, bf>{});
    case 2: return fn(pf::Instance<T, true, COND_I8, true, 0, bf>{});
    case 3: return fn(pf::Instance<T, false, COND_HOIST, false, 0, bf>{});
    case 4: return fn(pf::Instance<T, true, COND_HOIST, false, 0, bf>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Fn>
int with_instance(int dtype, int variant, Fn fn) {
  return dtype == 0 ? with_variant<float>(variant, fn)
                    : with_variant<__nv_bfloat16>(variant, fn);
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs (bytes).  dtype: 0 fp32, 1 bf16;
// tc: a tensor-core instance (every variant in bf16 only; the hoisted ones
// keep the u/v windows at a padded row stride).
int pair_reverse_smem_bytes(int dtype, int variant, int tc, int R, int Rin,
                            int TT) {
  if (variant < 0 || variant > 4 || (tc != 0) != tc_instance(dtype, variant))
    return -1;
  return (int)pf::smem_bytes<0>(
      dtype == 0 ? 4 : 2, kI8[variant], tc != 0, R, Rin, TT,
      pf::pad_windows(tc != 0, variant >= 3 ? COND_HOIST : COND_DENSE, 0));
}

int pair_reverse_threads() { return pf::NT; }

// ptrs: u, v, c_a, c_b, u_out, v_out, the 19 operand slots and
// c_row_scales (pf::make_params); dims: B, T, Rin, R, Cc, TT (Cc: the row
// width of c_a/c_b, n_layer*2R for the hoisted variants).  tc != 0 runs
// a tensor-core instance, whose kfg, cond_w, res_w, skip_w and fin_w
// come packed in fragment order (ops/pair_flow.py:pack_tc_weights); tc = 2
// (the hoisted variants 3 and 4 only, R_in a multiple of 16) also runs the
// front and zero convs on the tensor cores, with front_w and zw packed.
// tc must say whether (dtype, variant) is such an instance: neither runs
// in the other's place.  Widths the instance does not take
// (pf::geometry_ok; hoisted c not n_layer*2R = 4R wide) are refused; the
// wrapper pads them.  Returns the cudaError_t of the launch (0 =
// success).
int pair_reverse_launch(int dtype, int variant, int tc,
                        const void* const* ptrs, const int* dims,
                        void* stream) {
  if (variant < 0 || variant > 4 || tc < 0 || tc > 2)
    return (int)cudaErrorInvalidValue;
  if ((tc != 0) != tc_instance(dtype, variant) ||
      !pf::geometry_ok(dims[3], dims[4], tc != 0) ||
      (variant >= 3 && dims[4] != 4 * dims[3]) ||
      (tc == 2 && (variant < 3 || dims[2] % 16)))
    return (int)cudaErrorInvalidValue;
  pf::Params p = pf::make_params(ptrs, dims, 3, dtype == 0 ? 4 : 2,
                                 kI8[variant], kRS[variant], tc != 0);
  p.ftc = tc == 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_instance(dtype, variant,
                       [&](auto k) { return k.launch(p, st); });
}

// out[3] = registers and local (spill) bytes per thread of the (dtype,
// variant) instance and the dynamic shared memory its last launch set,
// from cudaFuncGetAttributes.  Returns its cudaError_t.
int pair_reverse_attrs(int dtype, int variant, int* out) {
  return with_instance(dtype, variant,
                       [&](auto k) { return k.attrs(out); });
}

}  // extern "C"
