"""``zero.Init`` / ``GatheredParameters``, ``SparseTensor`` and the collective
ledger of the port against the JAX package's.

``Init`` and ``GatheredParameters`` hold to ``tests/test_zero_init.py``'s
five cases on one gloo world of 2 (``tests/torch_dp_worker.py zero_init``,
started once for the module), the sparse all-reduce there against JAX's
``shard_map`` over 2 CPU devices; ``SparseTensor`` holds to
``test_training_features.py:200-230``; the ``CollectiveLedger`` is fed the
per-op rows the JAX ledger parses out of HLO (its parser stubbed to return
them) and must give the same summaries, bytes by axis, wire factors, step
anatomy and comms-logger reconcile view."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.comm import logger as jlog
from deepspeed_tpu.comm.mesh import MeshConfig as JMeshConfig
from deepspeed_tpu.comm.mesh import build_mesh as jbuild
from deepspeed_tpu.parallel import sharding as jshd
from deepspeed_tpu.runtime import sparse_tensor as jsparse
from deepspeed_tpu.telemetry import collective_ledger as jcl
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.comm import logger as tlog
from deepspeed_tpu_torch.comm.mesh import single_device_mesh
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.runtime import sparse_tensor as tsparse
from deepspeed_tpu_torch.runtime.zero import GatheredParameters, Init
from deepspeed_tpu_torch.telemetry import collective_ledger as tcl
from test_torch_comm import run_world, shared_once

MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
V, D, N = 8, 4, 3
SP_IDS = np.random.default_rng(0).integers(0, V, size=(2, N)).astype(np.int32)
SP_VALS = np.random.default_rng(1).normal(size=(2, N, D)).astype(np.float32)
SP_COUNTS = np.asarray([3, 2], np.int32)  # rank 1's last row is padding


def _world(tmp):
    np.savez(tmp / "sparse.npz", ids=SP_IDS, vals=SP_VALS, counts=SP_COUNTS, shape=np.asarray([V, D]))
    return run_world("zero_init", {"model": MODEL, "sparse": str(tmp / "sparse.npz")}, 2, tmp)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return shared_once(tmp_path_factory, "zero_init_world2", _world)


class _Mesh:
    def __init__(self, shape):
        self.shape = shape


def _plain():
    return tfm.init(tfm.TransformerConfig(**MODEL), torch.Generator().manual_seed(0))


def test_init_materializes_sharded(world2):
    """Every rank holds its half of ``wq`` (on the stage-3 spec's axes), and
    the halves are the unsharded init's, drawn from the same generator."""
    arrays, meta = world2
    shape = (MODEL["num_layers"], MODEL["hidden_size"], MODEL["num_heads"], MODEL["hidden_size"] // MODEL["num_heads"])
    want = jshd.spec_from_logical(("layers", "embed", "heads", "kv"), shape, jshd.zero_stage_rules(3)[0],
                                  _Mesh({"pipe": 1, "data": 2, "fsdp": 1, "context": 1, "model": 1}),
                                  zero_fallback=("fsdp", "data"))
    assert [list(a) if isinstance(a, tuple) else a for a in want] == meta[0]["wq_layout"]
    full = _plain()["layers"]["wq"].numpy()
    np.testing.assert_array_equal(np.concatenate([arrays[r]["wq_shard"] for r in range(2)], axis=1), full)


def test_init_dtype_cast(world2):
    assert world2[1][0]["bf16_dtype"] == "torch.bfloat16"


def test_init_disabled_plain(world2):
    np.testing.assert_array_equal(world2[0][0]["plain_wq"], _plain()["layers"]["wq"].numpy())


def test_gathered_parameters_roundtrip(world2):
    """The gather gives every rank the whole leaf; a read-only gather leaves
    the shards as they were."""
    arrays, _ = world2
    full = _plain()["layers"]["wq"].numpy()
    for r in range(2):
        np.testing.assert_array_equal(arrays[r]["wq_full"], full)
        np.testing.assert_array_equal(arrays[r]["wq_shard_after"], arrays[r]["wq_shard"])


def test_gathered_parameters_modifier_writes_back(world2):
    """Rank 0 (the modifier) zeroes ``wte`` in the gathered copy: every rank's
    shard is zero afterwards, and still a shard."""
    arrays, meta = world2
    for r in range(2):
        assert float(np.abs(arrays[r]["wte_after_modify"]).sum()) == 0.0
        assert meta[r]["wte_shape_after_modify"] == [MODEL["vocab_size"], MODEL["hidden_size"] // 2]


def test_init_without_a_world_is_the_plain_init():
    """No mesh (or a world of 1): every leaf whole, the generator's draws
    unchanged; a whole-tree init_fn without ``place`` works too."""
    model = tfm.Model(tfm.TransformerConfig(**MODEL))
    ref = _plain()
    with Init(mesh=None) as zi:
        got = zi.materialize(model.init, torch.Generator().manual_seed(0), model.logical_axes())
    with Init(mesh=single_device_mesh()) as zi:
        one = zi.materialize(model.init, torch.Generator().manual_seed(0), model.logical_axes())
    with Init(mesh=single_device_mesh()) as zi:
        whole = zi.materialize(lambda g: model.init(g), torch.Generator().manual_seed(0), model.logical_axes())
    for tree in (got, one, whole):
        torch.testing.assert_close(tree["layers"]["wq"], ref["layers"]["wq"], rtol=0, atol=0)
        torch.testing.assert_close(tree["wte"], ref["wte"], rtol=0, atol=0)
    with GatheredParameters(one) as full:
        assert full["wte"] is one["wte"]


# ---------------------------------------------------------------------------
# SparseTensor (test_training_features.py:200-230)
# ---------------------------------------------------------------------------

def test_sparse_tensor_dense_roundtrip_matches_jax():
    ids = np.asarray([3, 1, 3], np.int32)  # the duplicate id accumulates
    grads = np.asarray([[1.0, 0.0], [0.0, 2.0], [1.0, 1.0]], np.float32)
    want = np.asarray(jsparse.from_embedding_grad(jnp.asarray(ids), jnp.asarray(grads), vocab_size=5).to_dense())
    st = tsparse.from_embedding_grad(torch.from_numpy(ids), torch.from_numpy(grads), vocab_size=5)
    assert int(st.count) == 3 and st.dense_shape == (5, 2)
    np.testing.assert_array_equal(st.to_dense().numpy(), want)


def test_sparse_all_reduce_matches_jax(world2):
    """Two ranks' rows (rank 1 with a padding row) gathered over ``data``:
    the dense sum equals JAX's over 2 devices and the numpy reference."""
    mesh = jbuild(JMeshConfig(data=2), devices=jax.devices()[:2])

    def body(ids, vals, counts):
        st = jsparse.SparseTensor(ids[0], vals[0], counts[0], (V, D))
        return jsparse.sparse_all_reduce(st, "data").to_dense()[None]

    spec = P("data")
    try:
        sm = shard_map(body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
    except TypeError:  # older jax spelling
        sm = shard_map(body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check_rep=False)
    want = np.asarray(jax.jit(sm)(jnp.asarray(SP_IDS), jnp.asarray(SP_VALS), jnp.asarray(SP_COUNTS)))
    ref = np.zeros((V, D), np.float32)
    for r in range(2):
        np.add.at(ref, SP_IDS[r, :SP_COUNTS[r]], SP_VALS[r, :SP_COUNTS[r]])
    for r in range(2):
        np.testing.assert_allclose(world2[0][r]["sparse_dense"], want[r], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(world2[0][r]["sparse_dense"], ref, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The collective ledger
# ---------------------------------------------------------------------------

MESH = {"pipe": 1, "data": 2, "fsdp": 2, "context": 1, "model": 1}
# per-op rows as the JAX ledger parses them: groups over the 4 devices of MESH
JAX_OPS = [
    {"op": "all-reduce", "payload_bytes": 4096, "groups": [[0, 1, 2, 3]]},
    {"op": "reduce-scatter", "payload_bytes": 65536, "groups": [[0, 1, 2, 3]]},
    {"op": "all-gather", "payload_bytes": 16384, "groups": [[0, 1, 2, 3]]},
    {"op": "all-gather", "payload_bytes": 512, "groups": [[0, 2], [1, 3]]},
    {"op": "all-reduce", "payload_bytes": 8, "groups": [[0, 1], [2, 3]]},
    {"op": "all-to-all", "payload_bytes": 1024, "groups": [[0, 2], [1, 3]]},
]
# the same collectives as comm/ records them
PORT_OPS = [{"op": o["op"], "payload_bytes": o["payload_bytes"], "group_size": len(o["groups"][0]),
             "axis": {4: "data+fsdp"}.get(len(o["groups"][0])) or ("data" if o["groups"][0] == [0, 2] else "fsdp")}
            for o in JAX_OPS]


def _jax_ledger(monkeypatch, ops):
    rows = [dict(o, **{"async": False, "name": f"op{i}", "line": i, "pairs": [], "channel_id": None,
                       "overlapped": False}) for i, o in enumerate(ops)]
    monkeypatch.setattr(jcl, "parse_hlo_collectives", lambda text: [dict(r) for r in rows])
    led = jcl.CollectiveLedger()
    led.set_mesh_shape(MESH)
    led.record("train/train_step", "HloModule stub")
    return led


def test_collective_ledger_summary_and_bytes_by_axis_match_jax(monkeypatch):
    jl = _jax_ledger(monkeypatch, JAX_OPS)
    tl = tcl.CollectiveLedger()
    tl.set_mesh_shape(MESH)
    tl.record("train/train_step", PORT_OPS)
    got, want = tl.get("train/train_step"), jl.get("train/train_step")
    assert got == want
    assert tl.bytes_by_axis() == jl.bytes_by_axis()
    tl.record("serving/decode", [])  # a program without collectives records nothing, as in JAX
    assert tl.get("serving/decode") is None


@pytest.mark.parametrize("op", ["all-reduce", "reduce-scatter", "all-gather", "all-to-all", "collective-permute"])
def test_wire_factor_matches_jax(op):
    for n in (1, 2, 4, 8, 64):
        assert tcl._wire_factor(op, n) == jcl._wire_factor(op, n)


def test_step_anatomy_and_reconcile_view_match_jax(monkeypatch):
    """The anatomy row from the same ledger row, wall summary and summary,
    unrated (labeled nulls) and rated by ``ici_gbps``; the comms logger's
    reconcile view over the ledger's bytes by axis."""
    jl = _jax_ledger(monkeypatch, JAX_OPS)
    tl = tcl.CollectiveLedger()
    tl.record("train/train_step", PORT_OPS)
    row = {"name": "train/train_step", "flops": 5e12, "bytes_accessed": 2e10}
    wall = {"count": 3, "p50": 0.35}
    for peaks, ici in (({"platform": "cpu"}, None), ({"platform": "gpu", "peak_tflops": 989.0,
                                                      "peak_hbm_gbps": 3350.0}, None),
                       ({"platform": "gpu", "peak_tflops": 989.0, "peak_hbm_gbps": 3350.0}, 450.0)):
        assert tcl.step_anatomy(row, wall, peaks, tl.get(row["name"]), ici_gbps=ici) == \
            jcl.step_anatomy(row, wall, peaks, jl.get(row["name"]), ici_gbps=ici)
    jlogger, tlogger = jlog.CommsLogger(), tlog.CommsLogger()
    for lg, tensor in ((jlogger, np.zeros(1024, np.float32)), (tlogger, torch.zeros(1024))):
        lg.configure(enabled=True)
        lg.record("all_reduce[sum]", ("data", "fsdp"), tensor)
        lg.record("all_gather", "data", tensor)
    assert tlogger.reconcile(tl.bytes_by_axis(), mesh_shape=MESH) == \
        jlogger.reconcile(jl.bytes_by_axis(), mesh_shape=MESH)
    tlogger.reset()
    jlogger.reset()
