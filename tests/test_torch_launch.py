"""PyTorch port, the launch layer under the CUDA kernel wrappers
(ops/launch.py): one launch record for all fourteen kernels, one
tensor-core rule, one attributes call keyed by kernel name, and imports
among the ops modules that point one way (``pair_flow_train`` ->
``pair_flow`` -> ``launch``, ``resblock`` -> ``launch``).  No JAX and no
card: the launches themselves run in tests/test_torch_card.py."""

import ast
import functools
import pathlib
import types

import pytest
import torch

from flowavenet_tpu_torch.ops import launch

OPS = pathlib.Path(launch.__file__).resolve().parent
KERNELS = ("pair_flow", "pair_flow_i8", "pair_flow_i8rs",
           "pair_flow_hoisted", "pair_flow_hoisted_i8", "pair_flow_wino",
           "pair_flow_wino4", "pair_flow_wino_hoisted",
           "pair_flow_wino4_hoisted", "pair_fwd", "pair_train_fwd",
           "pair_train_bwd", "resblock", "resblock_v2")


def _tree(name: str) -> ast.Module:
    return ast.parse((OPS / f"{name}.py").read_text())


def _ops_imports(name: str) -> set:
    """The ops modules that ops/<name>.py imports, at any depth of its
    code (function-level imports included)."""
    mods = {p.stem for p in OPS.glob("*.py")}
    found = set()
    for node in ast.walk(_tree(name)):
        if isinstance(node, ast.ImportFrom):
            if node.level == 1 and node.module is None:   # from . import x
                found |= {a.name for a in node.names}
            elif node.level == 1:                         # from .x import y
                found.add(node.module.split(".")[0])
            elif (node.module or "").startswith("flowavenet_tpu_torch.ops."):
                found.add(node.module.split(".")[2])
            elif node.module == "flowavenet_tpu_torch.ops":
                found |= {a.name for a in node.names}
        elif isinstance(node, ast.Import):
            found |= {a.name.split(".")[2] for a in node.names
                      if a.name.startswith("flowavenet_tpu_torch.ops.")}
    return found & mods


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_uses_tensor_cores_in_bf16_only(dtype):
    """Every kernel in bf16 runs its products on the tensor cores (the nine
    reverse pairs, pair_fwd, pair_train_fwd, pair_train_bwd and both
    ResBlocks); every fp32 instance on CUDA cores.  The one rule takes
    the storage type alone."""
    assert launch.uses_tensor_cores(dtype) == (dtype == torch.bfloat16)


def test_one_launch_record_for_the_fourteen_kernels():
    """LAUNCHES counts each of the fourteen kernels once, each kernel maps
    to a library whose signatures launch.py declares, and no other ops
    module defines or imports a LAUNCHES or LAST_LAUNCH of its own."""
    assert list(launch.LAUNCHES) == list(KERNELS)
    assert set(launch.KERNELS) == set(KERNELS)
    assert {lib for lib, _ in launch.KERNELS.values()} == set(
        launch.SIGNATURES)
    for path in OPS.glob("*.py"):
        if path.stem == "launch":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names = [t.id for t in targets if isinstance(t, ast.Name)]
            elif isinstance(node, ast.ImportFrom):
                names = [a.asname or a.name for a in node.names]
            assert not {"LAUNCHES", "LAST_LAUNCH"} & set(names), path.name


def test_ops_imports_point_one_way():
    """pair_flow_train may import pair_flow (the pair operand format it
    shares), and every wrapper imports launch; pair_flow, resblock and
    launch never import pair_flow_train, resblock never imports pair_flow,
    launch imports no wrapper, and the ops modules' imports hold no
    cycle."""
    wrappers = {"pair_flow", "pair_flow_train", "resblock"}
    graph = {p.stem: _ops_imports(p.stem) for p in OPS.glob("*.py")}
    for name in ("pair_flow", "resblock", "launch"):
        assert "pair_flow_train" not in graph[name], name
    assert "pair_flow" not in graph["resblock"]
    assert not graph["launch"] & wrappers
    assert all("launch" in graph[w] for w in wrappers)
    assert "pair_flow" in graph["pair_flow_train"]

    def reach(start):
        seen, todo = set(), list(graph[start])
        while todo:
            m = todo.pop()
            if m not in seen:
                seen.add(m)
                todo += graph.get(m, ())
        return seen
    assert not [m for m in graph if m in reach(m)]


def test_kernel_attrs_call_each_library_in_its_argument_order(
        monkeypatch):
    """kernel_attrs(name, dtype) calls the attributes function of the
    kernel's library with that library's arguments, as the C sources
    declare them: (dtype code, variant) for the direct pairs, (dtype code,
    P, hoisted) for the Winograd pairs, (kernel, dtype code) for the
    training pairs and (dtype code, v2) for the ResBlocks; then returns
    (registers, local bytes) from the out array."""
    calls = []

    def attrs(fn, *args):
        calls.append((fn, *args[:-1]))
        args[-1][0], args[-1][1] = 40, 8
        return 0
    fns = {f: functools.partial(attrs, f)
           for lib in launch.SIGNATURES.values() for f in lib
           if f.endswith("_attrs")}
    monkeypatch.setattr(launch, "library",
                        lambda lib: types.SimpleNamespace(**fns))
    want = {"pair_flow": ("pair_reverse_attrs", "dt", 0),
            "pair_flow_i8": ("pair_reverse_attrs", "dt", 1),
            "pair_flow_i8rs": ("pair_reverse_attrs", "dt", 2),
            "pair_flow_hoisted": ("pair_reverse_attrs", "dt", 3),
            "pair_flow_hoisted_i8": ("pair_reverse_attrs", "dt", 4),
            "pair_flow_wino": ("pair_wino_attrs", "dt", 6, 0),
            "pair_flow_wino4": ("pair_wino_attrs", "dt", 12, 0),
            "pair_flow_wino_hoisted": ("pair_wino_attrs", "dt", 6, 1),
            "pair_flow_wino4_hoisted": ("pair_wino_attrs", "dt", 12, 1),
            "pair_fwd": ("pair_train_attrs", 0, "dt"),
            "pair_train_fwd": ("pair_train_attrs", 1, "dt"),
            "pair_train_bwd": ("pair_train_attrs", 2, "dt"),
            "resblock": ("resblock_attrs", "dt", 0),
            "resblock_v2": ("resblock_attrs", "dt", 1)}
    assert set(want) == set(KERNELS)
    for name, args in want.items():
        for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            calls.clear()
            assert launch.kernel_attrs(name, dtype) == (40, 8)
            assert calls == [tuple(code if a == "dt" else a for a in args)]
