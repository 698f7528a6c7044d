"""Compare the machine code (SASS) of the PyTorch port's CUDA kernels
between this tree and another, function by function.  No JAX, no card
needed, only ``nvcc`` and ``cuobjdump``.  Run from the repository root:

    python tools/sass_compare.py --parent DIR [SOURCE ...]

DIR is another tree (e.g. a commit unpacked by ``git archive``); SOURCE
names files of ``flowavenet_tpu_torch/ops/csrc`` without ``.cu`` (default:
all four).  Each source of each tree is compiled to a cubin with the
package's own architecture and optimisation flags (one ``nvcc`` each, all
at once); ``cuobjdump -sass`` lists every kernel instance, and the text of
each is hashed.  The tag nvcc gives a file's anonymous namespace (it
follows the file's path) is replaced by the file's name in kernel names
and in the SASS, so the same code under two paths compares equal; runs of
blanks are collapsed to one, since cuobjdump pads every line to the
widest instruction of the whole file, which an added or removed kernel
changes.
Prints, per source, the instances whose SASS is identical in both trees,
those that differ and those found in one tree only, then one JSON line
with the same.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

SOURCES = ("pair_flow", "pair_flow_wino", "pair_flow_train", "resblock")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin"]
# nvcc's name of a file's anonymous namespace:
# _GLOBAL__N__<8 hex>_<length>_<file>_cu_<8 hex>
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}")


def _tool(name: str) -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", name)
    found = cand if os.path.exists(cand) else shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (set CUDA_HOME)")
    return found


def sass_by_function(tree: str, source: str, out_dir: str) -> dict:
    """{mangled kernel name: sha256 of its SASS text} of one source."""
    src = os.path.join(tree, "flowavenet_tpu_torch", "ops", "csrc",
                       f"{source}.cu")
    cubin = os.path.join(out_dir, f"{source}.cubin")
    subprocess.run([_tool("nvcc"), *FLAGS, "-o", cubin, src], check=True,
                   capture_output=True, text=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    text = ANON.sub(r"_GLOBAL__N__\1_cu", text)
    funcs, name, body = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name is not None:
                funcs[name] = "\n".join(body)
            name, body = m.group(1), []
        elif name is not None:
            body.append(" ".join(line.split()))
    if name is not None:
        funcs[name] = "\n".join(body)
    return {k: hashlib.sha256(v.encode()).hexdigest()
            for k, v in funcs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other tree")
    ap.add_argument("sources", nargs="*", default=list(SOURCES))
    a = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"this": here, "parent": os.path.abspath(a.parent)}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for t in trees:
            for s in a.sources:
                os.makedirs(os.path.join(tmp, t, s))
                jobs[t, s] = (trees[t], s, os.path.join(tmp, t, s))
        with ThreadPoolExecutor(len(jobs)) as pool:
            futs = {k: pool.submit(sass_by_function, *v)
                    for k, v in jobs.items()}
            got = {k: f.result() for k, f in futs.items()}
    out = {}
    for s in a.sources:
        this, parent = got["this", s], got["parent", s]
        res = {"identical": sorted(k for k in this if parent.get(k)
                                   == this[k]),
               "different": sorted(k for k in this if k in parent
                                   and parent[k] != this[k]),
               "only_this": sorted(set(this) - set(parent)),
               "only_parent": sorted(set(parent) - set(this))}
        out[s] = res
        print(f"{s}: {len(res['identical'])} identical, "
              f"{len(res['different'])} different, {len(res['only_this'])} "
              f"only in this tree, {len(res['only_parent'])} only in the "
              f"parent", flush=True)
        for key in ("different", "only_this", "only_parent"):
            for k in res[key]:
                print(f"  {key}: {k}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
