"""The port's comm façade (``deepspeed_tpu_torch/comm``) against the JAX
package's: ``MeshConfig`` sizes and errors, the hybrid layout, ``get_bw``,
``mpi_discovery`` and the ``CommsLogger`` views, and every collective on one
gloo world of 4 processes (a 2 x 2 ``data`` x ``fsdp`` mesh, started once
for the module with ``subprocess``; ``tests/torch_dp_worker.py``) against
JAX's ``shard_map`` result over 4 CPU devices on the same numpy inputs,
on each axis and on both orders of the axis pair."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.comm import collectives as jcoll
from deepspeed_tpu.comm import logger as jlog
from deepspeed_tpu.comm.mesh import MeshConfig as JMeshConfig
from deepspeed_tpu.comm.mesh import build_hybrid_mesh as jhybrid
from deepspeed_tpu.comm.mesh import build_mesh as jbuild
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch import comm as tcomm
from deepspeed_tpu_torch.comm import collectives as tcoll
from deepspeed_tpu_torch.comm import logger as tlog
from deepspeed_tpu_torch.comm.mesh import MeshConfig as TMeshConfig
from deepspeed_tpu_torch.comm.mesh import build_hybrid_mesh as thybrid

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_dp_worker.py"
AXES = {"data": "data", "fsdp": "fsdp", "data+fsdp": ("data", "fsdp"), "fsdp+data": ("fsdp", "data")}
OPS = ["all_reduce_sum", "all_reduce_mean", "all_reduce_max", "all_reduce_min", "reduce_scatter", "all_gather",
       "all_to_all", "ring_shift", "broadcast"]


def shared_once(tmp_path_factory, name, compute):
    """``compute(tmp)``'s result, computed once per test session across the
    xdist workers (the first worker to get here computes it under a file
    lock and pickles it into the session's shared temporary directory; the
    others load it), so a module's gloo world and JAX runs are not repeated
    by every worker that draws one of its tests."""
    import fcntl
    import pickle

    base = tmp_path_factory.getbasetemp()
    # under xdist every worker's base is a child of the session's directory
    root = (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / f"shared-{name}"
    root.mkdir(exist_ok=True)
    done = root / "result.pkl"
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                result = compute(root)
                with open(root / "result.tmp", "wb") as f:
                    pickle.dump(result, f)
                os.replace(root / "result.tmp", done)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with open(done, "rb") as f:
        return pickle.load(f)  # written by this session's own workers


def run_world(job, spec, world, tmp, timeout=600):
    """Start ``world`` ranks of ``torch_dp_worker.py JOB`` (subprocesses, a
    FileStore rendezvous) and return their npz results and JSON sidecars."""
    out = tmp / "out"
    out.mkdir(exist_ok=True)
    spec = {**spec, "store": str(tmp / "store"), "out": str(out)}
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(WORKER), job, str(spec_path), str(r), str(world)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * world, f"ranks exited {rcs}:\n" + "\n".join(log[-3000:] for log in logs)
    return ([dict(np.load(out / f"rank{r}.npz")) for r in range(world)],
            [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)])


# ---------------------------------------------------------------------------
# The mesh (test_comm.py:15-30, :165-240)
# ---------------------------------------------------------------------------

MESH_CASES = [
    (dict(data=2, fsdp=2, model=2), 8), (dict(data=-1, model=2), 8), (dict(data=3, model=3), 8),
    (dict(data=-1, fsdp=-1), 8), (dict(data=-1), 1), (dict(data=2, fsdp=2), 4), (dict(data=-1, fsdp=3), 8),
]


@pytest.mark.parametrize("kw,n", MESH_CASES)
def test_mesh_config_sizes_and_errors_match_jax(kw, n):
    try:
        want = JMeshConfig(**kw).sizes(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TMeshConfig(**kw).sizes(n)
        assert str(got.value) == str(e)
        return
    assert TMeshConfig(**kw).sizes(n) == want


def test_mesh_ranks_row_major_like_jax_devices():
    """The rank array is JAX's device-id array for the same mesh; members and
    axis indices follow it, the first axis of a tuple major."""
    j = jbuild(JMeshConfig(data=2, fsdp=2, model=2))
    t = tcomm.build_mesh(TMeshConfig(data=2, fsdp=2, model=2), world=8, rank=5)
    assert t.shape == dict(j.shape)
    np.testing.assert_array_equal(t.ranks, np.vectorize(lambda d: d.id)(j.devices))
    assert tcomm.data_parallel_size(t) == jcomm.data_parallel_size(j) == 4
    assert t.members(("data", "fsdp")) == [1, 3, 5, 7] and t.members(("fsdp", "data")) == [1, 5, 3, 7]
    assert t.axis_index(("data", "fsdp")) == 2 and t.axis_index(("fsdp", "data")) == 1  # rank 5: data 1, fsdp 0
    assert tcomm.get_world_size(group="fsdp") == jcomm.get_world_size(group="fsdp") == 2
    tcomm.mesh.set_current_mesh(None)


class FakeDev:
    def __init__(self, d, idx, slice_index):
        self.id = idx
        self.slice_index = slice_index
        self.process_index = slice_index
        self.platform = d.platform
        self.device_kind = d.device_kind

    def __repr__(self):
        return f"fake(id={self.id}, slice={self.slice_index})"


@pytest.mark.parametrize("kw", [dict(data=2, fsdp=2, model=2), dict(data=8), dict(data=4, fsdp=2)])
def test_hybrid_mesh_layout_matches_jax(kw):
    """Ranks grouped 4 to a node lay out as JAX lays devices out 4 to a
    slice: the DCN axis changes across nodes, the rest stays inside one."""
    fakes = [FakeDev(jax.devices()[i], i, i // 4) for i in range(8)]
    j = jhybrid(JMeshConfig(**kw), devices=fakes)
    t = thybrid(TMeshConfig(**kw), world=8, rank=0, local_world_size=4)
    np.testing.assert_array_equal(t.ranks, np.vectorize(lambda d: d.id)(j.devices))
    single = thybrid(TMeshConfig(**kw), world=8, rank=0, local_world_size=8)  # one node: build_mesh
    np.testing.assert_array_equal(single.ranks, np.arange(8).reshape(single.ranks.shape))
    with pytest.raises(ValueError, match="cannot cover"):
        thybrid(TMeshConfig(data=1, fsdp=8), world=8, rank=0, local_world_size=4)
    tcomm.mesh.set_current_mesh(None)


# ---------------------------------------------------------------------------
# get_bw, mpi_discovery, the CommsLogger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast"])
def test_get_bw_matches_jax(op):
    for size, dur, n in ((1 << 20, 1e-3, 8), (123456, 0.0, 4), (7, 2.5, 2)):
        assert tcomm.get_bw(op, size, dur, n) == jcomm.get_bw(op, size, dur, n)


MPI_ENVS = [
    {},
    {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2", "MASTER_ADDR": "10.0.0.1"},
    {"PMI_RANK": "3", "PMI_SIZE": "4", "AZ_BATCH_MASTER_NODE": "10.1.1.1:6000"},
    {"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "h", "MASTER_PORT": "1234"},
    {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_LOCAL_SIZE": "4"},
    {"MV2_COMM_WORLD_RANK": "1", "MV2_COMM_WORLD_SIZE": "4"},
]


@pytest.mark.parametrize("env", MPI_ENVS)
def test_mpi_discovery_matches_jax(monkeypatch, env):
    for k in ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK",
              "PMI_SIZE", "MV2_COMM_WORLD_RANK", "MV2_COMM_WORLD_SIZE", "RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "AZ_BATCH_MASTER_NODE", "MPI_LOCALNRANKS", "MV2_COMM_WORLD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        want = jcoll.mpi_discovery()
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as got:
            tcoll.mpi_discovery()
        assert str(got.value) == str(e)
        return
    assert tcoll.mpi_discovery() == want


RECORDS = [("all_reduce[sum]", ("data", "fsdp"), (4, 8), np.float32), ("all_gather", "fsdp", (16,), np.float16),
           ("reduce_scatter", "data", (2, 3, 5), np.float32), ("all_reduce[sum]", ("data", "fsdp"), (7,), np.int32),
           ("ppermute", "data", (3,), np.float64), ("all_gather", ("fsdp", "data"), (8, 2), np.float32)]


def test_comms_logger_summary_axis_totals_and_reconcile_match_jax():
    """The same record sequence (numpy operands in JAX's, torch tensors in
    the port's) gives the same summary, roll-up and reconcile rows, with
    and without the mesh shape; a reset empties both."""
    jl, tl = jlog.CommsLogger(), tlog.CommsLogger()
    jl.configure(enabled=True)
    tl.configure(enabled=True)
    for op, axis, shape, dt in RECORDS:
        jl.record(op, axis, np.zeros(shape, dt))
        tl.record(op, axis, torch.from_numpy(np.zeros(shape, dt)))
    assert tl.summary() == jl.summary() and tl.axis_totals() == jl.axis_totals()
    hlo = {"data+fsdp": {"count": 1, "bytes": 128}, "model": {"count": 2, "bytes": 8}}
    mesh = {"pipe": 1, "data": 2, "fsdp": 2, "context": 1, "model": 2}
    assert tl.reconcile(hlo) == jl.reconcile(hlo)
    assert tl.reconcile(hlo, mesh_shape=mesh) == jl.reconcile(hlo, mesh_shape=mesh)
    assert tl.reconcile(hlo, mesh_shape={**mesh, "fsdp": 1}) == jl.reconcile(hlo, mesh_shape={**mesh, "fsdp": 1})
    tl.reset()
    jl.reset()
    assert tl.summary() == jl.summary() == {}


# ---------------------------------------------------------------------------
# The collectives on a gloo world of 4 against shard_map over 4 devices
# ---------------------------------------------------------------------------

X = np.random.default_rng(0).standard_normal((4, 8, 6)).astype(np.float32)  # rank r's input is X[r]


def _world4(tmp):
    np.savez(tmp / "inputs.npz", x=X)
    arrays, _ = run_world("comm", {"inputs": str(tmp / "inputs.npz")}, 4, tmp)
    return arrays


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return shared_once(tmp_path_factory, "comm_world4", _world4)


def _jax_op(op, axes):
    if op.startswith("all_reduce_"):
        return lambda x: jcomm.all_reduce(x, axes, op[len("all_reduce_"):])
    return {"reduce_scatter": lambda x: jcomm.reduce_scatter(x, axes, scatter_dimension=0),
            "all_gather": lambda x: jcomm.all_gather(x, axes, gather_dimension=1),
            "all_to_all": lambda x: jcomm.all_to_all(x, axes, split_axis=0, concat_axis=1),
            "ring_shift": lambda x: jcomm.ring_shift(x, axes, shift=1),
            "broadcast": lambda x: jcomm.broadcast_in_axis(x, axes, src_index=1)}[op]


def jax_result(op, axes):
    """[4, ...]: device k's output (device k = rank k: both meshes are
    row-major over the same axis order)."""
    mesh = jbuild(JMeshConfig(data=2, fsdp=2), devices=jax.devices()[:4])
    fn = _jax_op(op, axes)
    spec = P(("data", "fsdp"))
    body = lambda x: fn(x[0])[None]  # noqa: E731
    try:
        sm = shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    except TypeError:  # older jax spelling
        sm = shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=spec, check_rep=False)
    return np.asarray(jax.jit(sm)(jnp.asarray(X)))


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_jax_shard_map(world4, op, axes):
    want = jax_result(op, AXES[axes])
    for r in range(4):
        got = world4[r][f"{op}@{axes}"]
        assert got.shape == want[r].shape, (op, axes, r)
        np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6, err_msg=f"{op}@{axes} rank {r}")


def test_exports_match_jax_less_the_compressed_allreduce():
    """``comm`` exports every name the JAX package's does, less the 1-bit
    compressed all-reduce (which comes with the 1-bit optimizers)."""
    public = {n for n in dir(jcomm) if not n.startswith("_")} - {"collectives", "compressed", "logger", "mesh"}
    assert public - {n for n in dir(tcomm) if not n.startswith("_")} == {
        "CompressedBackend", "compressed_allreduce", "compressed_allreduce_p"}


def test_world1_collectives_are_identities_and_logged():
    """Without a process group (a world of 1) every collective returns its
    input's values, and the logger counts each call once."""
    tcomm.mesh.set_current_mesh(tcomm.single_device_mesh())
    tlog.comms_logger.reset()
    tlog.comms_logger.configure(enabled=True)
    try:
        x = torch.arange(6.0).reshape(2, 3)
        for fn in (lambda: tcomm.all_reduce(x, "data"), lambda: tcomm.all_gather(x, ("data", "fsdp")),
                   lambda: tcomm.reduce_scatter(x, "fsdp"), lambda: tcomm.broadcast_in_axis(x, "data"),
                   lambda: tcomm.ring_shift(x, "data"), lambda: tcomm.all_to_all(x, "data", 0, 1)):
            torch.testing.assert_close(fn(), x, rtol=0, atol=0)
        s = tlog.comms_logger.summary()
        assert sum(v["count"] for k, v in s.items() if k != "by_axis") == 6
        assert s["all_reduce[sum]@data"]["bytes"] == 24
    finally:
        tlog.comms_logger.reset()
        tlog.comms_logger.configure(enabled=False)
        tcomm.mesh.set_current_mesh(None)
