"""PyTorch port, the widths the pair kernels take (ops/pair_flow.py): every
(R, Cc) that the route predicates send to a pair kernel, for the presets,
the generic flow family of tests/test_torch_family.py and a filter_size
that does not divide the CTA's threads, passes the launchers' geometry
checks once the wrapper pads it (``kernel_widths``); and a pair run padded
equals the same pair run unpadded, bit for bit, in every operand family
(the plain versions here; on the card tests/test_torch_card.py and
chip_smoke.py run the kernels).  No JAX."""

import dataclasses
import itertools

import pytest
import torch

from flowavenet_tpu_torch.config import PRESETS, tiny
from flowavenet_tpu_torch.models import flowavenet as fwn
from flowavenet_tpu_torch.ops import launch
from flowavenet_tpu_torch.ops import pair_flow as pf
from flowavenet_tpu_torch.ops.conv import quantize_act

# the variants of tests/test_torch_family.py, on the tiny model
FAMILY = {"causal": dict(causal=True), "additive": dict(affine=False),
          "n_flow3": dict(n_flow=3), "logs_clamp": dict(logs_clamp=3.0),
          "n_layer3": dict(n_layer=3), "odd_mels": dict(num_mels=79),
          "filter_size48": dict(filter_size=48),
          "filter_size48_odd_mels": dict(filter_size=48, num_mels=79)}
MODELS = {**{name: make().model for name, make in PRESETS.items()},
          **{name: dataclasses.replace(tiny().model, **kw)
             for name, kw in FAMILY.items()}}
# the model switches of every route (fwn module globals)
SWITCHES = [dict(PAIR_KERNEL_INT8=i8, PAIR_KERNEL_WINO=wino,
                 PAIR_KERNEL_WINO4=w4, PAIR_KERNEL_HOISTED=h, INT8_RS=rs)
            for i8, wino, w4, h, rs in itertools.product((True, False),
                                                         repeat=5)]


def _options(mode: str, switches: dict) -> dict:
    """The wrapper options a route mode launches with."""
    return {"int8": dict(int8=True, rs=switches["INT8_RS"]),
            "wino": dict(phases=6), "wino4": dict(phases=12), "direct": {},
            "hoisted": dict(hoisted=True,
                            int8=switches["PAIR_KERNEL_INT8"])}[mode]


@pytest.mark.parametrize("name", list(MODELS))
def test_route_widths_pass_the_launcher_geometry_after_padding(
        monkeypatch, name):
    cfg = MODELS[name]
    seen = set()
    for switches in SWITCHES:
        for key, val in switches.items():
            monkeypatch.setattr(fwn, key, val)
        for bi in range(cfg.n_block):
            if cfg.n_flow % 2:
                continue                  # the generic flow scan
            cc = (cfg.num_mels << (bi + 1)) // 2
            mode = fwn._pair_kernel_mode(cfg, cc, cfg.gin_channels > 0)
            if mode is None:
                continue
            opts = _options(mode, switches)
            R = cfg.filter_size
            cc = 4 * R if opts.get("hoisted") else cc
            for dt in (torch.float32, torch.bfloat16):
                tc = launch.uses_tensor_cores(dt)
                r_k, cc_k = pf.kernel_widths(R, cc, tc, opts.get("hoisted",
                                                                 False))
                pf.check_kernel_geometry(r_k, cc_k, tc)
                assert r_k >= R and cc_k >= cc
                if R == 256 and cc % 16 == 0:
                    assert (r_k, cc_k) == (R, cc)   # lj22k: never padded
                seen.add((R, cc, mode, tc))
    if name == "odd_mels":
        assert (32, 79, "int8", True) in seen
    if name.startswith("filter_size48"):
        assert pf.kernel_widths(48, 80, True) == (64, 80)


def test_unpadded_widths_fail_the_geometry_check():
    for r, cc, tc in ((48, 80, False), (32, 79, False), (32, 78, True),
                      (16, 80, True), (1024, 80, False)):
        with pytest.raises(ValueError):
            pf.check_kernel_geometry(r, cc, tc)
    with pytest.raises(ValueError, match="up to 512"):
        pf.kernel_widths(600, 80, False)


# operand families: (make operands, wrapper options)
FAMILIES = {
    "direct": (lambda p: pf.pair_reverse_operands(p, torch.bfloat16), {}),
    "int8": (lambda p: pf.pair_reverse_operands_int8(p, torch.bfloat16),
             dict(int8=True)),
    "i8rs": (lambda p: pf.pair_reverse_operands_int8(p, torch.bfloat16,
                                                     rs=True),
             dict(int8=True)),
    "hoisted": (lambda p: pf.pair_reverse_operands_hoisted(
        p, torch.bfloat16), dict(hoisted=True)),
    "hoisted_i8": (lambda p: pf.pair_reverse_operands_hoisted_int8(
        p, torch.bfloat16), dict(hoisted=True, int8=True)),
    "wino": (lambda p: pf.pair_reverse_operands_wino(p, torch.bfloat16),
             dict(phases=6)),
    "wino4": (lambda p: pf.pair_reverse_operands_wino4(p, torch.bfloat16),
              dict(phases=12)),
    "wino4_hoisted": (lambda p: pf.pair_reverse_operands_wino4(
        p, torch.bfloat16, hoisted=True), dict(phases=12, hoisted=True)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_padded_pair_equals_unpadded_bit_for_bit(family):
    """R = 48 and Cc = 79 (an odd-num_mels block 0 of a filter_size 48
    model), padded to the tensor-core widths (64, 80): the plain version
    gives the same bits, since every padded channel stays zero."""
    cfg = dataclasses.replace(tiny().model, filter_size=48, num_mels=79)
    gen = torch.Generator().manual_seed(3)
    block = fwn.init_block(gen, 2, 79, cfg)
    block["flows"]["coupling"]["zero"]["w"].normal_(0, 0.05, generator=gen)
    pair = fwn._index(fwn._pair_params(block), 0)
    make, opts = FAMILIES[family]
    ops = make(pair)
    hoisted = opts.get("hoisted", False)
    int8 = opts.get("int8", False)
    B, T = 2, 150
    u, v = (torch.randn(B, T, 2, generator=gen).bfloat16() for _ in "uv")
    c = [torch.rand(B, T, 79, generator=gen).bfloat16() for _ in "ab"]
    kw = {}
    if hoisted:
        ops, (we, wo) = ops
        c = [pf.hoist_cond(c[0], we), pf.hoist_cond(c[1], wo)]
    elif int8:
        q = [quantize_act(x, per_row=True) for x in c]
        c = [q[0][0], q[1][0]]
        kw["c_row_scales"] = torch.cat([s.reshape(-1, 1) for _, s in q], 1)
    r_k, cc_k = pf.kernel_widths(48, c[0].shape[-1], True, hoisted)
    assert (r_k, cc_k) == ((64, 256) if hoisted else (64, 80))
    ca_k, cb_k, ops_k = pf.pad_pair_widths(c[0], c[1], ops, r_k, cc_k,
                                           int8=int8, hoisted=hoisted)
    assert ops_k[pf._operand_names(len(ops), int8, hoisted)
                 .index("res_w")].shape[-1] == 64
    assert ca_k.shape == (B, T, cc_k)
    if "phases" in opts:
        def run(ca, cb, o):
            return pf.pair_reverse_wino_ref(u, v, ca, cb, o, t_tile=60,
                                            hoisted=hoisted)
    else:
        def run(ca, cb, o):
            return pf.pair_reverse_ref(u, v, ca, cb, o, t_tile=64, int8=int8,
                                       hoisted=hoisted, **kw)
    for got, want in zip(run(ca_k, cb_k, ops_k), run(c[0], c[1], ops)):
        assert torch.equal(got, want)
