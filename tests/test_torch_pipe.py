"""The port's pipeline parallelism (``deepspeed_tpu_torch/pipe/``) against
``deepspeed_tpu/pipe/`` on JAX's 8-device CPU mesh.

In process: the topology's rank algebra, the schedules' instructions and
buffer counts, the partitioners, ``PipelineModule``, and
``PipelinedTransformer``'s loss with every stage in this process (JAX's
``mesh=None`` case) against JAX's pipelined loss at S 2 and 4 (rtol 2e-5),
its gradients against the plain model's (rtol 1e-4), and block-sparse
attention inside the stages. Gloo worlds (``tests/torch_dp_worker.py
pipe``, started once for the module): pipe 2 under ``gpipe`` and ``1f1b`` at
ZeRO 0 and 1, pipe 2 x data 2 (ZeRO 1) and pipe 2 x model 2, each 3 steps
against JAX's ``PipelineEngine`` on the same global batch (JAX's ``{pipe 2,
data 4}``; ``{pipe 2, data 2, model 2}`` for pipe x model), held to
``test_torch_zero.py``'s ``LOSS_RTOL`` and ``_assert_params``; the executed
1F1B trace against JAX's; a port save that JAX's engine resumes and a JAX
save the port resumes, each to the other's next loss. Refusals: a plain
engine with ``pipe`` above 1, ``offload_param`` under the pipeline,
dropout, and a gas / micro-batch conflict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import MeshConfig as JMeshConfig
from deepspeed_tpu.comm.mesh import build_mesh as jbuild_mesh
from deepspeed_tpu.models.transformer import Model as JModel
from deepspeed_tpu.models.transformer import TransformerConfig as JConfig
from deepspeed_tpu.pipe import PipelineEngine as JPipelineEngine
from deepspeed_tpu.pipe import PipelinedTransformer as JPipelinedTransformer
from deepspeed_tpu.pipe import schedule as jschedule
from deepspeed_tpu.pipe import topology as jtopology
from deepspeed_tpu.pipe.engine import pipeline_train_1f1b as jpipeline_train_1f1b
from deepspeed_tpu.pipe.module import partition_balanced as jbalanced
from deepspeed_tpu.pipe.module import partition_uniform as juniform
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.pipe import (LayerSpec, PipelineEngine, PipelinedTransformer, PipelineModule,
                                      TiedLayerSpec, partition_balanced, partition_uniform)
from deepspeed_tpu_torch.pipe import schedule as tschedule
from deepspeed_tpu_torch.pipe import topology as ttopology
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from simple_model import base_config, random_tokens
from test_torch_comm import run_world, shared_once
from test_torch_zero import LOSS_RTOL, _assert_params, _flat_np, _np_tree

# tests/simple_model.py's transformer with 4 layers: 2 a stage at S 2
MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=4, num_heads=4, hidden_size=64)
STAGES = 2
MICRO = 2  # micro-batches: the config's gradient_accumulation_steps
STEPS = 3
ROWS = 8  # the global batch


def _jax_ds(zero, schedule="gpipe", dp=4):
    return base_config(train_batch_size=ROWS, train_micro_batch_size_per_gpu=ROWS // (MICRO * dp),
                       gradient_accumulation_steps=MICRO, zero_optimization={"stage": zero},
                       pipeline={"schedule": schedule})


def _port_ds(zero, schedule="gpipe", dp=1, **mesh):
    ds = _jax_ds(zero, schedule, dp)
    ds["mesh"] = {"pipe": STAGES, **mesh}
    return ds


# ---------------------------------------------------------------------------
# topology, schedules, partitioning
# ---------------------------------------------------------------------------

def test_topology_rank_algebra_matches_jax():
    for mod in (jtopology, ttopology):
        topo = mod.ProcessTopology(axes=["pipe", "data", "model"], dims=[2, 2, 2])
        assert topo.world_size() == 8
        assert topo.get_rank(pipe=0, data=0, model=0) == 0
        assert topo.get_rank(pipe=1, data=1, model=1) == 7
        assert topo.get_rank(pipe=1, data=0, model=0) == 4  # the outermost axis varies slowest
        assert topo.get_coord(5) == topo.ProcessCoord(pipe=1, data=0, model=1)
        assert topo.get_axis_list("pipe", 1) == [4, 5, 6, 7]
        groups = topo.get_axis_comm_lists("data")
        assert [0, 2] in groups and [5, 7] in groups
        assert topo.get_rank_repr(5) == "pipe_01-model_01"
    for args in ((2, 4), (4, 2)):
        j, t = jtopology.PipeDataParallelTopology(*args), ttopology.PipeDataParallelTopology(*args)
        assert [tuple(t.get_coord(r)) for r in range(8)] == [tuple(j.get_coord(r)) for r in range(8)]
    j, t = jtopology.PipeModelDataParallelTopology(2, 2, 2), ttopology.PipeModelDataParallelTopology(2, 2, 2)
    for r in range(8):
        jg, tg = jtopology.PipelineParallelGrid(j, r), ttopology.PipelineParallelGrid(t, r)
        assert (tg.stage_id, tg.data_parallel_id, tg.model_parallel_id, tg.prev_stage, tg.next_stage,
                tg.stage_to_global(1 - tg.stage_id)) == (jg.stage_id, jg.data_parallel_id, jg.model_parallel_id,
                                                         jg.prev_stage, jg.next_stage,
                                                         jg.stage_to_global(1 - jg.stage_id))


def test_mesh_topology_agrees_with_the_port_mesh():
    """The rank algebra over the mesh's axes (``pipe`` outermost) gives every
    rank the coordinates ``comm/mesh.py`` lays it out at."""
    from deepspeed_tpu_torch.comm.mesh import AXIS_ORDER, Mesh, MeshConfig

    sizes = MeshConfig(pipe=2, data=2, model=2).sizes(8)
    ranks = np.arange(8).reshape(tuple(sizes[a] for a in AXIS_ORDER))
    topo = ttopology.ProcessTopology(axes=list(AXIS_ORDER), dims=[sizes[a] for a in AXIS_ORDER])
    for r in range(8):
        assert topo.get_rank(**Mesh(ranks, r).coords()) == r
        assert dict(topo.get_coord(r)._asdict()) == Mesh(ranks, 0).coords(r)
    assert topo.get_axis_comm_lists("pipe") == Mesh(ranks, 0).partition("pipe")


def _steps(sched):
    return [[(type(c).__name__, c.kwargs) for c in step] for step in sched.steps()]


@pytest.mark.parametrize("stages,micro", [(2, 2), (2, 4), (4, 4), (4, 8)])
def test_schedules_equal_jax(stages, micro):
    for s in range(stages):
        for name in ("TrainSchedule", "InferenceSchedule"):
            j, t = getattr(jschedule, name)(micro, stages, s), getattr(tschedule, name)(micro, stages, s)
            assert _steps(t) == _steps(j), (name, s)
            assert t.num_pipe_buffers() == j.num_pipe_buffers()


@pytest.mark.parametrize("n,parts", [(8, 4), (7, 3), (5, 5), (12, 2)])
def test_partitioners_equal_jax(n, parts):
    assert partition_uniform(n, parts) == juniform(n, parts)
    for w in ([1.0] * n, [float((i * 7) % 5 + 1) for i in range(n)], [1, 1, 1, 9] + [1] * (n - 4)):
        assert partition_balanced(w, parts) == jbalanced(w, parts)


def test_pipeline_module_partitions_and_ties():
    """Layers of nn.Modules and functions, split by parameters (the
    parameterless function weighs 1, as in JAX), uniformly and by type; a
    tied layer is one module; the stages in turn are the whole stack."""
    torch.manual_seed(0)
    layers = [TiedLayerSpec("emb", torch.nn.Linear, 8, 8), LayerSpec(torch.nn.Linear, 8, 32),
              torch.relu, LayerSpec(torch.nn.Linear, 32, 8),
              TiedLayerSpec("emb", torch.nn.Linear, 8, 8, forward_fn=lambda m, x: x @ m.weight)]
    pm = PipelineModule(layers, num_stages=2)
    weights = [72, 288, 1, 264, 72]
    assert pm.parts == partition_balanced(weights, 2)
    assert pm.built[0] is pm.built[4] and len(list(pm.parameters())) == 6
    x = torch.randn(3, 8)
    assert torch.equal(pm.stage_forward(1, pm.stage_forward(0, x)), pm(x))
    assert PipelineModule(layers, 2, partition_method="uniform").parts == partition_uniform(5, 2)
    assert PipelineModule(layers, 2, partition_method="type:linear").parts == \
        partition_balanced([1, 1, 0, 1, 1], 2)


# ---------------------------------------------------------------------------
# PipelinedTransformer with every stage in this process
# ---------------------------------------------------------------------------

LOSS_CFG = dict(vocab_size=211, max_seq_len=32, num_layers=4, num_heads=4, hidden_size=32, loss_chunk_size=0)


def _stack(params, S):
    return dict(params, layers=jax.tree.map(lambda a: a.reshape((S, a.shape[0] // S) + a.shape[1:]),
                                            params["layers"]))


@pytest.mark.parametrize("stages,micro,extra", [(2, 2, {}), (4, 4, {}),
                                                (2, 2, {"attn_impl": "sparse", "max_seq_len": 64,
                                                        "sparsity": {"mode": "fixed", "block": 16}})],
                         ids=["s2", "s4", "s2_sparse"])
def test_in_process_loss_and_grads_match_jax(stages, micro, extra):
    kw = dict(LOSS_CFG, **extra)
    seq = 33 if "sparsity" in extra else 17
    toks = np.random.default_rng(0).integers(0, kw["vocab_size"], size=(4, seq)).astype(np.int32)
    plain = JModel(JConfig(**kw, dtype=jnp.float32))
    piped = JPipelinedTransformer(JConfig(**kw, dtype=jnp.float32), num_stages=stages, num_micro_batches=micro)
    piped.set_mesh(jbuild_mesh(JMeshConfig(pipe=stages, data=-1)))
    params = plain.init(jax.random.PRNGKey(1))
    want = float(piped.loss(_stack(params, stages), {"tokens": toks}))
    tparams = interop.params_from_jax(_np_tree(_stack(params, stages)))
    for leaf in [tparams["wte"], tparams["wpe"], *tparams["layers"].values()]:
        leaf.requires_grad_()
    model = PipelinedTransformer(tfm.TransformerConfig(**kw, dtype=torch.float32), stages, micro)
    loss = model.loss(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss.detach()), want, rtol=2e-5)
    if extra:
        return
    loss.backward()
    g = jax.grad(lambda p: plain.loss(p, {"tokens": toks}))(params)
    for got, ref in ((tparams["wte"].grad, g["wte"]), (tparams["layers"]["wq"].grad, g["layers"]["wq"]),
                     (tparams["layers"]["wo_mlp"].grad, g["layers"]["wo_mlp"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref, rtol=1e-4, atol=1e-6)


def test_logical_axes_and_init_are_stage_stacked():
    cfg = tfm.TransformerConfig(**MODEL, dtype=torch.float32)
    m = PipelinedTransformer(cfg, STAGES)
    jm = JPipelinedTransformer(JConfig(**MODEL, dtype=jnp.float32), STAGES)
    assert m.logical_axes() == jax.tree.map(tuple, jm.logical_axes(), is_leaf=lambda x: isinstance(x, tuple))
    p = m.init(torch.Generator().manual_seed(0))
    assert tuple(p["layers"]["wq"].shape) == (STAGES, 2, 64, 4, 16) and tuple(p["wte"].shape) == (128, 64)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------

def test_refusals():
    cfg = tfm.TransformerConfig(**MODEL, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="'pipe'=2: pipeline parallelism runs through .*PipelineEngine"):
        DeepSpeedConfig.from_dict(_port_ds(1), world_size=2)
    DeepSpeedConfig.from_dict(_port_ds(1), world_size=2, pipelined=True)
    off = _port_ds(1)
    off["zero_optimization"] = {"stage": 1, "offload_optimizer": {"device": "cpu"},
                                "offload_param": {"device": "cpu"}}
    with pytest.raises(NotImplementedError, match="offload_param under pipeline parallelism is not wired up"):
        DeepSpeedConfig.from_dict(off, world_size=2, pipelined=True)
    with pytest.raises(NotImplementedError, match="offload_param under pipeline parallelism is not wired up"):
        PipelineEngine(PipelinedTransformer(cfg, 1), dict(off, mesh={"pipe": 1}), device="cpu")
    with pytest.raises(NotImplementedError, match="dropout/progressive-layer-drop under pipeline parallelism"):
        PipelinedTransformer(cfg.replace(hidden_dropout=0.1), STAGES)
    with pytest.raises(AssertionError, match="must divide evenly into 3 stages"):
        PipelinedTransformer(cfg, 3)
    with pytest.raises(ValueError, match="conflicts with num_micro_batches=3"):
        PipelineEngine(PipelinedTransformer(cfg, 1, num_micro_batches=3), dict(_port_ds(0), mesh={"pipe": 1}),
                       device="cpu")
    with pytest.raises(ValueError, match="pipeline.schedule must be gpipe|1f1b"):
        PipelineEngine(PipelinedTransformer(cfg, 1), dict(_port_ds(0, "zb"), mesh={"pipe": 1}), device="cpu")
    with pytest.raises(TypeError, match="requires a pipelined model"):
        PipelineEngine(tfm.Model(cfg), dict(_port_ds(0), mesh={"pipe": 1}), device="cpu")


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_one_stage_engine_at_world_1_takes_the_plain_engines_steps(schedule):
    """A one-stage pipeline in one process is the plain engine with gas =
    micro-batches: the same losses (the micro-batches' mean)."""
    import deepspeed_tpu_torch

    cfg = tfm.TransformerConfig(**MODEL, dtype=torch.float32)
    params = tfm.init(cfg, torch.Generator().manual_seed(0))
    ds = dict(_port_ds(1, schedule), mesh={"pipe": 1})
    pipe = PipelineEngine(PipelinedTransformer(cfg, 1), ds,
                          params={**params, "layers": {k: v[None] for k, v in params["layers"].items()}},
                          device="cpu")
    plain = deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=_port_ds(1) | {"mesh": {}},
                                           model_parameters=params, device="cpu")[0]
    tokens = random_tokens(ROWS)["tokens"]
    for _ in range(2):
        np.testing.assert_allclose(float(pipe.train_batch({"tokens": tokens})["loss"]),
                                   float(plain.train_batch({"tokens": tokens})["loss"]), rtol=1e-6)
    assert pipe.gradient_accumulation_steps == 1 and pipe.micro_batches == MICRO
    snap = pipe.telemetry_snapshot()
    assert snap["metrics"]["gauges"]["train/pipe/bubble_fraction"] == 0.0


# ---------------------------------------------------------------------------
# Gloo worlds against JAX's PipelineEngine
# ---------------------------------------------------------------------------

CASES = [
    *({"name": f"{sch}{z}", "ds": {"zero_optimization": {"stage": z}, "pipeline": {"schedule": sch}},
       "steps": STEPS} for sch in ("gpipe", "1f1b") for z in (0, 1)),
    # a save after step 2, then step 3: JAX's engine resumes from the save
    {"name": "save", "ds": {"zero_optimization": {"stage": 1}}, "steps": STEPS, "save_after": 2},
    {"name": "x4data", "world": 4, "ds": {"zero_optimization": {"stage": 1}, "mesh": {"pipe": 2, "data": 2},
                                          "train_micro_batch_size_per_gpu": 2}, "steps": STEPS},
    {"name": "x4model", "world": 4, "ds": {"zero_optimization": {"stage": 1}, "mesh": {"pipe": 2, "model": 2}},
     "steps": STEPS},
]


def _jax_engine(zero, schedule="gpipe", mesh=None):
    mesh = mesh or {"pipe": STAGES, "data": 4}
    model = JPipelinedTransformer(JConfig(**MODEL, dtype=jnp.float32), num_stages=STAGES, num_micro_batches=MICRO)
    dp = mesh.get("data", 1)
    return JPipelineEngine(model=model, config=_jax_ds(zero, schedule, dp),
                           mesh=jbuild_mesh(JMeshConfig(**{"data": -1, **mesh})))


def _jax_trace():
    """JAX's executed 1F1B trace at S 2, M 2 (a stage function that scales
    its input), per stage: [is_fwd, fwd_mb, is_bwd, bwd_mb] over the ticks."""
    mesh = jbuild_mesh(JMeshConfig(pipe=STAGES, data=4))
    x = jnp.ones((MICRO, 4, 3), jnp.float32)
    out = jpipeline_train_1f1b(lambda p, h: h * p["w"][0], lambda hp, y, lab: jnp.mean(y * hp["h"]),
                               {"w": jnp.ones((STAGES, 1), jnp.float32)}, {"h": jnp.ones((), jnp.float32)},
                               x, jnp.zeros((MICRO, 4), jnp.int32), 1.0, STAGES, mesh)
    return [[np.asarray(t)[s].tolist() for t in out[4]] for s in range(STAGES)]


def _runs(tmp):
    tokens = random_tokens(ROWS)["tokens"]
    jax_runs = {}
    init = None
    for name, zero, sch, mesh in (("gpipe0", 0, "gpipe", None), ("gpipe1", 1, "gpipe", None),
                                  ("1f1b0", 0, "1f1b", None), ("1f1b1", 1, "1f1b", None),
                                  ("x4model", 1, "gpipe", {"pipe": STAGES, "data": 2, "model": 2})):
        eng = _jax_engine(zero, sch, mesh)
        first = _flat_np(_np_tree(eng.state["params"]))
        init = first if init is None else init
        assert all(np.array_equal(first[k], init[k]) for k in init)  # one seed: every engine's weights
        losses = []
        for step in range(STEPS):
            losses.append(float(eng.train_batch({"tokens": tokens})["loss"]))
            if name == "gpipe1" and step == 1:
                eng.save_checkpoint(str(tmp / "jax_ckpt"), tag="jax")  # what the port resumes
        jax_runs[name] = {"losses": losses, "params": _flat_np(_np_tree(eng.state["params"]))}
    np.savez(tmp / "params.npz", **init)
    np.savez(tmp / "tokens.npz", tokens=tokens)
    cases = [dict(c) for c in CASES]
    for c in cases:
        if c["name"] == "save":
            c["save"] = str(tmp / "port_ckpt")
    cases.append({"name": "jaxload", "ds": {"zero_optimization": {"stage": 1}}, "steps": 1,
                  "load": str(tmp / "jax_ckpt"), "load_tag": "jax"})
    cases.append({"name": "interop", "ds": {"zero_optimization": {"stage": 1}}, "steps": 1, "interop": True})
    spec = {"params": str(tmp / "params.npz"), "tokens": str(tmp / "tokens.npz"), "model": MODEL,
            "stages": STAGES, "ds": _port_ds(0, dp=1), "cases": cases}
    for w in ("w2", "w4"):
        (tmp / w).mkdir(exist_ok=True)
    w2 = run_world("pipe", spec, 2, tmp / "w2")
    w4 = run_world("pipe", spec, 4, tmp / "w4")
    # the port's world-2 save after step 2, resumed by JAX's gpipe ZeRO-1 engine
    j = _jax_engine(1)
    j.load_checkpoint(str(tmp / "port_ckpt"), tag="port")
    jax_runs["resumed_from_port"] = float(j.train_batch({"tokens": tokens})["loss"])
    jax_runs["trace"] = _jax_trace()
    return {"jax": jax_runs, "w2": w2, "w4": w4, "init": init}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "pipe_runs", _runs)


def _losses(world, name, rank):
    return world[0][rank][f"{name}::losses"]


def _params(world, name, rank):
    prefix = f"{name}::params::"
    return {k[len(prefix):]: v for k, v in world[0][rank].items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", ["gpipe0", "gpipe1", "1f1b0", "1f1b1"])
def test_world2_losses_and_params_match_jax(runs, case):
    """pipe 2, one stage a rank: every rank returns JAX's losses (the last
    stage's, reduced over ``pipe``) and gathers JAX's final parameters."""
    want = runs["jax"][case]
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], case, r), want["losses"], rtol=LOSS_RTOL)
        _assert_params(_params(runs["w2"], case, r), want["params"])
        meta = runs["w2"][1][r][case]
        assert meta["stage"] == r and meta["stage_shape"][:2] == [1, MODEL["num_layers"] // STAGES]
        # the gauge and the train step's anatomy row, as the JAX engine sets them (set_pipeline)
        assert meta["bubble"] == pytest.approx(1 / 3)
        assert meta["pipeline_row"] == {"num_stages": STAGES, "micro_batches": MICRO, "schedule": case[:-1],
                                        "bubble_fraction": pytest.approx(1 / 3)}


@pytest.mark.parametrize("case,jax_case", [("x4data", "gpipe1"), ("x4model", "x4model")])
def test_world4_pipe_by_data_and_by_model_match_jax(runs, case, jax_case):
    want = runs["jax"][jax_case]
    for r in range(4):
        np.testing.assert_allclose(_losses(runs["w4"], case, r), want["losses"], rtol=LOSS_RTOL)
        _assert_params(_params(runs["w4"], case, r), want["params"])
        assert runs["w4"][1][r][case]["stage"] == r // 2


def test_executed_1f1b_trace_equals_jax_and_the_schedule(runs):
    want = runs["jax"]["trace"]
    for r in range(2):
        got = runs["w2"][1][r]["1f1b1"]["trace"]
        assert got == want[r], r
        clocks = [i for i, f in enumerate(got[0]) if f]
        sched = tschedule.TrainSchedule(MICRO, STAGES, r)
        assert clocks == [t for t, step in enumerate(sched.steps()) if any(
            isinstance(c, tschedule.ForwardPass) for c in step)]


def test_checkpoints_move_both_ways(runs):
    """The port's world-2 save after step 2 (each stage's layers a shard of
    the table, split on the stage dimension) resumes in JAX's engine at the
    port's step-3 loss; JAX's save after step 2 resumes in the port at
    JAX's step-3 loss."""
    np.testing.assert_allclose(runs["jax"]["resumed_from_port"], _losses(runs["w2"], "save", 0)[2], rtol=LOSS_RTOL)
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], "jaxload", r)[0], runs["jax"]["gpipe1"]["losses"][2],
                                   rtol=LOSS_RTOL)


def test_interop_cuts_the_jax_tree_to_each_stage(runs):
    """``interop.tp_params_from_jax`` gives each rank its stage's
    ``[1, K, ...]`` slices of the JAX tree's ``[S, K, ...]`` leaves (and the
    whole of the rest): the first loss is JAX's."""
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], "interop", r)[0], runs["jax"]["gpipe1"]["losses"][0],
                                   rtol=LOSS_RTOL)
        assert runs["w2"][1][r]["interop"]["stage_shape"][0] == 1


def test_stage_leaves_checkpoint_as_pipe_shards_in_rank_order(runs):
    """A stage leaf's shard table: one shard a stage, split on the stage
    dimension, listed in the order of its first holder's rank (JAX's
    multi-device save), on every layout of the worlds."""
    S, K = STAGES, MODEL["num_layers"] // STAGES
    want = [[[s, s + 1], [0, K], [0, 64], [0, 4], [0, 16]] for s in range(S)]
    for world, case in ((runs["w2"], "gpipe1"), (runs["w4"], "x4data")):
        for meta in world[1]:
            assert [list(map(list, b)) for b in meta[case]["table"]] == want
    halves = [[[s, s + 1], [0, K], [0, 64], [2 * m, 2 * m + 2], [0, 16]] for s in range(S) for m in range(2)]
    for meta in runs["w4"][1]:
        assert [list(map(list, b)) for b in meta["x4model"]["table"]] == halves
