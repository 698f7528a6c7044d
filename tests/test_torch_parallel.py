"""PyTorch port, scale-out training (parallel/mesh.py, multihost.py, tp.py
and the mesh path of training/): the mesh layout, the batch slice and the
tensor-parallel rule held against the JAX package's, and gloo runs of 2
and 4 CPU processes held against the JAX package's sharded gradients on
its 8-device CPU mesh (tests/conftest.py) at tests/test_parallel.py's
bars."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import flowavenet_tpu.parallel.mesh as jmesh
from flowavenet_tpu.checkpoint import checkpoint as jckpt
from flowavenet_tpu.config import MeshConfig as JMeshConfig
from flowavenet_tpu.config import tiny
from flowavenet_tpu.models.flowavenet import loss_fn
from flowavenet_tpu.training import train_state as jts
from flowavenet_tpu_torch import config as tconfig
from flowavenet_tpu_torch.checkpoint import checkpoint as tckpt
from flowavenet_tpu_torch.data.records import FwRecordWriter
from flowavenet_tpu_torch.models import flowavenet as tfwn
from flowavenet_tpu_torch.parallel import mesh as tmesh
from flowavenet_tpu_torch.parallel import multihost as tmh
from flowavenet_tpu_torch.parallel import tp as ttp
from flowavenet_tpu_torch.training import train_state as tts
from flowavenet_tpu_torch.utils.tree import tree_map_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
JCFG = tiny()
TCFG = tconfig.tiny()


@pytest.mark.parametrize("n,data,model", [
    (8, -1, 1), (8, 8, 1), (8, 4, 2), (8, -1, 2), (4, 2, 2), (2, -1, 2),
    (8, 3, 1), (8, -1, 3), (4, 4, 2), (1, -1, 1)])
def test_mesh_layout_matches_jax(n, data, model):
    """(data, model) extents and the errors for sizes that do not divide
    are the JAX package's make_mesh on n devices, and rank = d * model + m
    is JAX's device order."""
    jc = JMeshConfig(data_parallel=data, model_parallel=model)
    tc = tconfig.MeshConfig(data_parallel=data, model_parallel=model)
    try:
        jm = jmesh.make_mesh(jc, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{str(e)}$"):
            tmesh.mesh_shape(tc, n)
        return
    d, m = tmesh.mesh_shape(tc, n)
    assert (d, m) == (jm.shape["data"], jm.shape["model"])
    ids = np.vectorize(lambda dv: dv.id)(jm.devices)
    first = min(x.id for x in jax.devices()[:n])
    for r in range(n):
        pm = tmesh.ProcessMesh({"data": d, "model": m}, r,
                               torch.device("cpu"))
        assert ids[pm.data_index, pm.model_index] - first == r
        assert pm.rank_of(pm.data_index, pm.model_index) == r


def test_single_process_mesh():
    """Without torch.distributed the mesh is one rank, (1, 1), with no
    groups (every collective is the identity); batch_sharding and
    replicated give JAX's specs."""
    mesh = tmesh.make_mesh(TCFG.mesh, "cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert not mesh.distributed and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "model_parallel=2"):
        tmesh.make_mesh(tconfig.MeshConfig(model_parallel=2), "cpu")
    # the batch and replicated specs are JAX's
    jc = JMeshConfig(data_parallel=8)
    jb = jmesh.batch_sharding(jmesh.make_mesh(jc), jc, ("audio", "speaker"))
    assert tmesh.batch_sharding(mesh, TCFG.mesh, ("audio", "speaker")) == \
        {k: v.spec for k, v in jb.items()}
    assert tmesh.replicated({"a": torch.zeros(2), "b": [torch.zeros(1)]},
                            mesh) == {"a": PartitionSpec(),
                                      "b": [PartitionSpec()]}


def test_host_batch_slice_matches_jax(monkeypatch):
    """The rows of a data coordinate, as JAX's host_batch_slice gives a
    process its rows (tests/test_multihost.py:17-28); ranks that differ
    only in their model coordinate feed the same rows."""
    import flowavenet_tpu.parallel.multihost as jmh

    assert tmh.host_batch_slice(8) == jmh.host_batch_slice(8) == slice(0, 8)
    monkeypatch.setattr(jmh.jax, "process_count", lambda: 4)
    monkeypatch.setattr(jmh.jax, "process_index", lambda: 2)
    mesh = tmesh.ProcessMesh({"data": 4, "model": 1}, 2, torch.device("cpu"))
    assert tmh.host_batch_slice(8, mesh) == jmh.host_batch_slice(8) == \
        slice(4, 6)
    with pytest.raises(ValueError, match="not divisible"):
        jmh.host_batch_slice(7)
    with pytest.raises(ValueError, match="^global batch 7 not divisible by "
                                         "4 processes$"):
        tmh.host_batch_slice(7, mesh)
    for r in (4, 5):
        m2 = tmesh.ProcessMesh({"data": 4, "model": 2}, r,
                               torch.device("cpu"))
        assert tmh.host_batch_slice(8, m2) == slice(4, 6)


@pytest.fixture(scope="module")
def jax_setup():
    """The JAX package's DDI'd tiny state on a seeded batch of 4 (made
    once: JAX's eager DDI takes seconds on the CPU)."""
    rng = np.random.RandomState(0)
    B, T, hop = 4, JCFG.data.max_time_steps, JCFG.audio.hop_size
    batch = {"audio": (0.1 * rng.randn(B, T, 1)).astype(np.float32),
             "mel": rng.rand(B, T // hop, 80).astype(np.float32)}
    state = jts.ddi_initialize(jts.create_state(jax.random.PRNGKey(0), JCFG),
                               JCFG, batch)
    return state, batch


def _jax_tp_paths(monkeypatch, tp_min, shape, params):
    monkeypatch.setattr(jmesh, "TP_MIN_CIN", tp_min)
    mc = JMeshConfig(data_parallel=shape[0], model_parallel=shape[1])
    mesh = jmesh.make_mesh(mc, devices=jax.devices()[:shape[0] * shape[1]])
    sh = jmesh.param_sharding(params, mesh, mc)
    return {jax.tree_util.keystr(p): s.spec for p, s in
            jax.tree_util.tree_flatten_with_path(sh)[0]}


@pytest.mark.parametrize("tp_min", [32, 64])
def test_param_sharding_matches_jax(monkeypatch, jax_setup, tp_min):
    """The TP rule splits exactly the leaves JAX's splits on its (4, 2)
    CPU mesh, with the same specs: at TP_MIN_CIN 32 the tiny model's
    32-wide convs too; at 64 only the conditioning 1x1s (Cc 80 and 160)."""
    want = _jax_tp_paths(monkeypatch, tp_min, (4, 2), jax_setup[0].params)
    monkeypatch.setattr(tmesh, "TP_MIN_CIN", tp_min)
    params = tfwn.init_flowavenet(torch.Generator().manual_seed(0),
                                  TCFG.model)
    mesh = tmesh.ProcessMesh({"data": 4, "model": 2}, 0, torch.device("cpu"))
    specs = tmesh.param_sharding(params, mesh, TCFG.mesh)
    got = {}
    tree_map_with_path(lambda p, s: got.__setitem__(p, s), specs)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    split = set(tmh.sharded_paths(specs))
    assert split == {k for k, s in want.items()
                     if s == PartitionSpec(None, None, "model", None)}
    if tp_min == 64:
        assert len(split) == 8 and all(
            p.endswith(("['filter_c']['v']", "['gate_c']['v']"))
            for p in split)
    else:
        assert any(p.endswith("['filter']['v']") for p in split)
        with pytest.raises(ValueError, match="conditioning 1x1s only"):
            tts.make_train_step(TCFG, mesh, specs)


def test_shard_outside_tensor_parallel_raises():
    """A conditioning shard never runs unsharded: outside
    tensor_parallel, and on a kernel route, it raises."""
    with pytest.raises(ValueError, match="tensor_parallel"):
        ttp.shard_of(160, 80)
    assert ttp.shard_of(80, 80) is None
    params = tfwn.init_flowavenet(torch.Generator().manual_seed(0),
                                  TCFG.model)
    flows = params["blocks"][0]["flows"]
    half = dict(flows["coupling"]["layers"][0]["filter_c"])
    half["v"] = half["v"][:, :, :40]
    flows["coupling"]["layers"][0]["filter_c"] = half
    with pytest.raises(ValueError, match="no tensor-parallel shard"):
        tfwn._whole_cond(flows, 80, "train")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(world, data, model, tp_min, mode, inp, out):
    """Start WORLD worker ranks; ``_wait`` collects them."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(r), str(world), str(data),
         str(model), str(tp_min), mode, str(inp), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    return procs


def _wait(procs, timeout=240):
    """The ranks' outputs (each must exit 0)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-4000:]}"
    return outs


def _jax_grads(params, batch, mesh_cfg, n):
    """tests/test_parallel.py:_grads on the first n CPU devices."""
    def gfn(p, b):
        return jax.grad(
            lambda p: loss_fn(p, JCFG.model, b["audio"], b["mel"])[0])(p)

    mesh = jmesh.make_mesh(mesh_cfg, devices=jax.devices()[:n])
    p_sh = jmesh.param_sharding(params, mesh, mesh_cfg)
    b_sh = jmesh.batch_sharding(mesh, mesh_cfg)
    params = jax.device_put(params, p_sh)
    batch = {k: jax.device_put(v, b_sh[k]) for k, v in batch.items()}
    out = jax.jit(gfn, in_shardings=(p_sh, b_sh), out_shardings=p_sh)(
        params, batch)
    return {jax.tree_util.keystr(p): np.asarray(l) for p, l in
            jax.tree_util.tree_flatten_with_path(jax.device_get(out))[0]}


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2)],
                         ids=["dp2", "dp2xtp2"])
def test_gloo_grads_match_jax_sharded(tmp_path, monkeypatch, jax_setup,
                                      data, model):
    """gloo ranks of the port on a (data, model) mesh (TP_MIN_CIN 64: the
    conditioning 1x1s of both tiny blocks split) give the JAX package's
    gradients on a mesh of the same shape, same weights (DDI'd JAX params,
    bridged) and batch, at rtol 5e-4, atol max(5e-7, 5e-5 max|g|); the
    loss is one number on every rank; and two make_train_step steps give
    every rank the same finite loss, that of one process on the global
    batch."""
    monkeypatch.setattr(jmesh, "TP_MIN_CIN", 64)
    state, batch = jax_setup
    jckpt.save_checkpoint(str(tmp_path), 0, state.params, prefix="params")
    os.replace(tmp_path / "params-0.npz", tmp_path / "params.npz")
    np.savez(tmp_path / "batch.npz", **batch)
    world = data * model
    procs = _start(world, data, model, 64, "grads", tmp_path, tmp_path)
    # JAX's sharded gradients while the ranks run
    mc = JMeshConfig(data_parallel=data, model_parallel=model)
    want = _jax_grads(state.params, batch, mc, world)
    outs = _wait(procs)
    with np.load(tmp_path / "grads" / "ckpt-0.npz") as f:
        got = {k: f[k] for k in f.files if k != "__meta__"}
    assert set(got) == set(want)
    for k, a in want.items():
        atol = max(5e-7, 5e-5 * float(np.abs(a).max()))
        np.testing.assert_allclose(got[k], a, rtol=5e-4, atol=atol,
                                   err_msg=k)
    split = [sorted(l.split()[1] for l in o.splitlines()
                    if l.startswith("SHARDED")) for o in outs]
    jsplit = sorted(k for k, s in _jax_tp_paths(
        monkeypatch, 64, (data, model), state.params).items()
        if s != PartitionSpec())
    assert all(s == jsplit for s in split)
    assert len(jsplit) == (8 if model > 1 else 0)
    losses = [float([l for l in o.splitlines() if l.startswith("LOSS")][-1]
                    .split()[1]) for o in outs]
    assert len(set(losses)) == 1 and np.isfinite(losses[0])
    params, _ = tckpt.restore_checkpoint(
        str(tmp_path / "params.npz"),
        tfwn.init_flowavenet(torch.Generator().manual_seed(0), TCFG.model))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss1 = float(tfwn.loss_fn(params, TCFG.model, tb["audio"],
                                   tb["mel"])[0])
    np.testing.assert_allclose(losses[0], loss1, rtol=1e-5)
    steps = [[l for l in o.splitlines() if l.startswith("STEP")][-1].split()
             for o in outs]
    assert all(s == steps[0] for s in steps) and steps[0][2] == "2"
    # one process, the global batch, the same state
    st = tts.ddi_initialize(
        tts.create_state(torch.Generator().manual_seed(0), TCFG), TCFG,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    step = tts.make_train_step(TCFG)
    for _ in range(2):
        st, m = step(st, tb)
    # Adam turns the ~1e-7 reduction noise of near-zero gradients into
    # lr-sized steps (tests/test_parallel.py:72-74), hence 1e-4 here
    np.testing.assert_allclose(float(steps[0][1]), float(m["loss"]),
                               rtol=1e-4)


def _corpus(d, n=6, frames=(20, 11, 40, 9, 33, 24)):
    os.makedirs(d, exist_ok=True)
    r = np.random.RandomState(0)
    for name in ("train", "test"):
        with FwRecordWriter(os.path.join(d, f"{name}.fwrec")) as w:
            for i in range(n):
                f = frames[i % len(frames)]
                w.write(r.randn(f * 256).astype(np.float32) * 0.1,
                        r.rand(f, 80).astype(np.float32), i % 3)
    return d


def test_gloo_tp_trainer_checkpoint_restores(tmp_path):
    """train() over two gloo ranks on a (1, 2) mesh (TP_MIN_CIN 64): rank 0
    alone writes the metrics (finite losses) and the probe's audio, and
    its checkpoint holds the full one-device layout, which the port
    restores in one process and the JAX package's restore_checkpoint reads
    with the same values."""
    data = _corpus(str(tmp_path / "data"))
    logdir = tmp_path / "logs"
    _wait(_start(2, 1, 2, 64, "train", data, logdir))
    recs = [json.loads(l) for l in open(logdir / "train" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert (logdir / "train" / "wavs" / "prediction-2.wav").exists()
    path = logdir / "pretrained" / "ckpt-2.npz"
    assert tckpt.read_meta(str(path))["loader"] == "python"
    target = tts.create_state(torch.Generator().manual_seed(1), TCFG)
    tstate, step = tckpt.restore_checkpoint(str(path), target)
    assert step == 2
    jstate, jstep = jckpt.restore_checkpoint(
        str(path), jts.create_state(jax.random.PRNGKey(1), JCFG))
    assert jstep == 2
    with np.load(path) as f:
        saved = {k: f[k] for k in f.files if k != "__meta__"}
    jl = {jax.tree_util.keystr(p): np.asarray(l) for p, l in
          jax.tree_util.tree_flatten_with_path(jstate)[0]}
    cond = [k for k in saved if k.endswith("['filter_c']['v']")]
    assert cond and all(saved[k].shape[2] in (80, 160) for k in cond)
    for k, v in saved.items():
        np.testing.assert_array_equal(jl[k], v, err_msg=k)
    for k, leaf in tckpt._paths(tstate):
        np.testing.assert_array_equal(leaf.numpy(), saved[k], err_msg=k)
