"""The port's data-parallel ZeRO (``runtime/zero/``) against the JAX engine
on its 8-device CPU mesh: one gloo world of 2 processes and one 2 x 2
``data`` x ``fsdp`` world of 4 (``tests/torch_dp_worker.py``, started once
for the module with ``subprocess``) run every case; the JAX engines are
``tests/test_engine.py``'s ``_make_engine`` configurations (the global
micro-batch is 8 rows there, 8 devices x micro 1; a port world of N takes
micro 8 / N). fp32 losses over 3 steps are held to 1e-5 relative and the
final parameters to 1e-5, but for the elements whose Adam steps are
noise-dominated (``_assert_params``: the key bias ``bk``, whose gradient
is 0 in exact arithmetic, to 2e-4, and at most 2 elements of any other
leaf to 1e-4); bf16 losses to 2e-2."""

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.parallel import sharding as jshd
from deepspeed_tpu_torch.checkpoint import saver
from deepspeed_tpu_torch.models import transformer as tfm
from deepspeed_tpu_torch.parallel import sharding as tshd
from deepspeed_tpu_torch.runtime.zero.stage_1_and_2 import ZERO_FALLBACK
from simple_model import base_config, random_tokens
from test_engine import _make_engine
from test_torch_comm import run_world, shared_once

MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
LAMB = {"type": "Lamb", "params": {"lr": 1e-3}}


def port_ds(micro, **over):
    ds = base_config(train_micro_batch_size_per_gpu=micro)
    ds.update(over)
    return ds


CASES = [
    *({"name": f"s{s}", "ds": {"zero_optimization": {"stage": s}}, "steps": STEPS} for s in (0, 1, 2)),
    # stage 3 saves after step 2, then takes step 3 (the JAX engine resumes from that save)
    {"name": "s3", "ds": {"zero_optimization": {"stage": 3}}, "steps": STEPS, "save_after": 2},
    {"name": "bf16", "ds": {"zero_optimization": {"stage": 2}, "bf16": {"enabled": True}}, "steps": STEPS},
    {"name": "gas1", "ds": {"zero_optimization": {"stage": 2}, "train_micro_batch_size_per_gpu": 8,
                            "gradient_accumulation_steps": 1}, "steps": STEPS},
    {"name": "fp16nan", "ds": {"zero_optimization": {"stage": 2}, "fp16": {"enabled": True}}, "steps": STEPS,
     "nan_rank1_at": 2},
    {"name": "dropout", "ds": {"zero_optimization": {"stage": 0}}, "model": {"hidden_dropout": 0.1},
     "steps": 2},
    {"name": "jaxload", "ds": {"zero_optimization": {"stage": 3}}, "steps": 1, "load_tag": "jax"},
    {"name": "interop", "ds": {"zero_optimization": {"stage": 3}}, "steps": 1},
    {"name": "s3remat", "ds": {"zero_optimization": {"stage": 3},
                               "activation_checkpointing": {"enabled": True}}, "steps": STEPS},
    {"name": "s3loop", "ds": {"zero_optimization": {"stage": 3}}, "steps": STEPS, "three_call": True},
    # an async save at world 2: committed by every rank's commit(), after each rank's files
    {"name": "async", "ds": {"zero_optimization": {"stage": 2}, "checkpoint": {"async_save": True}},
     "steps": STEPS, "save_after": 2},
    {"name": "ledger", "ds": {"zero_optimization": {"stage": 2}, "comms_logger": {"enabled": True}},
     "steps": 2, "snapshot": True},
    # ZeRO-Offload: the cpu tier holding each rank's shards of the masters and moments
    *({"name": f"off{s}", "ds": {"zero_optimization": {"stage": s, "offload_optimizer": {"device": "cpu"}}},
       "steps": STEPS, **({"save_after": 2} if s == 2 else {})} for s in (1, 2, 3)),
    # ZeRO-Infinity's parameter tier: each rank's parameter shards in host memory, gathered a layer at a time
    {"name": "offp3", "ds": {"zero_optimization": {"stage": 3, "offload_optimizer": {"device": "cpu"},
                                                   "offload_param": {"device": "cpu"}}}, "steps": STEPS},
    # LAMB: the trust ratio of each whole leaf from its shards' sums of squares
    *({"name": f"lamb{s}", "ds": {"zero_optimization": {"stage": s}, "optimizer": LAMB}, "steps": STEPS}
      for s in (2, 3)),
    # {"input_ids", "labels"} with far more labels masked on rank 0's rows than on rank 1's
    *({"name": f"masked{s}", "ds": {"zero_optimization": {"stage": s}}, "steps": STEPS, "labels": True}
      for s in (2, 3)),
]
# a world of 1 under a process group: nothing splits, so the tier runs its single-device path
CASES1 = [{"name": "w1off2", "world": 1, "ds": {"zero_optimization": {"stage": 2,
                                                                     "offload_optimizer": {"device": "cpu"}}},
           "steps": STEPS}]
CASES4 = [{"name": f"x4s{s}", "world": 4, "ds": {"zero_optimization": {"stage": s},
                                                  "mesh": {"data": 2, "fsdp": 2}}, "steps": STEPS}
          for s in (1, 3)]


def _axes_flat(tree, prefix=()):
    """{"a::b": logical-axes tuple} (the tuples are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_axes_flat(tree[k], prefix + (k,)))
        return out
    return {"::".join(prefix): tree}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in saver._flatten_with_paths(tree).items()}


def _jax_offload_engine(stage, offload_param=False):
    """``test_engine.py``'s engine with the cpu tier (``offload_optimizer``,
    and ``offload_param`` when asked)."""
    import deepspeed_tpu
    from simple_model import tiny_transformer

    cfg = base_config()
    cfg["zero_optimization"] = {"stage": stage, "offload_optimizer": {"device": "cpu"},
                                **({"offload_param": {"device": "cpu"}} if offload_param else {})}
    cfg["mesh"] = {"data": -1}
    return deepspeed_tpu.initialize(model=tiny_transformer(), config=cfg)[0]


def masked_batch(tokens):
    """{"input_ids", "labels"}: the next tokens as labels, -100 on about 80%
    of the positions of the rows that rank 0 of a world of 2 takes from
    each micro-batch of 8 rows (rows 0-3 and 8-11), on 10% of the others
    and on the whole of row 9, so the ranks' labelled counts differ."""
    rng = np.random.default_rng(1)
    labels = tokens[:, 1:].copy()
    rank0 = (np.arange(tokens.shape[0]) % 8) < 4
    p = np.where(rank0, 0.8, 0.1)[:, None]
    labels[rng.random(labels.shape) < p] = -100
    labels[9] = -100
    return {"input_ids": tokens[:, :-1], "labels": labels}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared_once(tmp_path_factory, "zero_runs", _runs)


def _runs(tmp):
    """The JAX runs, then the port's worlds of 2 and 4 on the same weights
    and batch, then the JAX stage-1 engine resumed from the port's save."""
    tokens = random_tokens(16)["tokens"]
    jax_runs = {}
    init = None
    for name, kw in (("s0", {}), ("s1", {}), ("s2", {}), ("s3", {}), ("bf16", {"dtype": "bf16"}),
                     ("x4s1", {"mesh_over": {"data": 2, "fsdp": 4}}),
                     ("x4s3", {"mesh_over": {"data": 2, "fsdp": 4}})):
        stage = int(name[-1]) if name != "bf16" else 2
        eng = _make_engine(zero_stage=stage, **kw)
        if init is None:
            init = _flat_np(_np_tree(eng.state["params"]))
        losses = []
        for step in range(STEPS):
            losses.append(float(eng.train_batch({"tokens": tokens})["loss"]))
            if name == "s3" and step == 1:
                eng.save_checkpoint(str(tmp / "jax_s3"), tag="jax")  # what the port's world 2 resumes
                np.savez(tmp / "jax_s3_state.npz", **_flat_np(_np_tree(
                    {k: eng.state[k] for k in ("params", "opt", "step")})))
        jax_runs[name] = {"losses": losses, "params": _flat_np(_np_tree(eng.state["params"])), "engine": eng}
    for name, stage, param in (("off1", 1, False), ("off2", 2, False), ("off3", 3, False), ("offp3", 3, True)):
        eng = _jax_offload_engine(stage, param)  # the JAX engine's cpu tier on its 8-device mesh
        losses = [float(eng.train_batch({"tokens": tokens})["loss"]) for _ in range(STEPS)]
        jax_runs[name] = {"losses": losses, "params": _flat_np(_np_tree(eng.state["master"])), "engine": eng}
    eng = _make_engine(zero_stage=2, optimizer=LAMB)
    jax_runs["lamb"] = {"losses": [float(eng.train_batch({"tokens": tokens})["loss"]) for _ in range(STEPS)]}
    jax_runs["lamb"]["params"] = _flat_np(_np_tree(eng.state["params"]))
    masked = masked_batch(tokens)
    eng = _make_engine(zero_stage=2)
    jax_runs["masked"] = {"losses": [float(eng.train_batch(masked)["loss"]) for _ in range(STEPS)]}
    jax_runs["masked"]["params"] = _flat_np(_np_tree(eng.state["params"]))
    np.savez(tmp / "params.npz", **init)
    np.savez(tmp / "tokens.npz", tokens=tokens, **masked)
    cases = [dict(c) for c in CASES]
    for c in cases:
        if c["name"] in ("s3", "async", "off2"):
            c["save"] = str(tmp / f"port_{c['name']}")
        if c["name"] == "jaxload":
            c["load"] = str(tmp / "jax_s3")
        if c["name"] == "interop":
            c["jax_state"] = str(tmp / "jax_s3_state.npz")
    spec = {"params": str(tmp / "params.npz"), "tokens": str(tmp / "tokens.npz"), "model": MODEL,
            "ds": port_ds(4), "cases": cases}
    for w in ("w1", "w2", "w4"):
        (tmp / w).mkdir(exist_ok=True)
    world1 = run_world("zero", {**spec, "ds": port_ds(8), "cases": CASES1}, 1, tmp / "w1")
    w2 = run_world("zero", spec, 2, tmp / "w2")
    w4 = run_world("zero", {**spec, "ds": port_ds(2), "cases": CASES4}, 4, tmp / "w4")
    # the port's world-2 stage-3 save (after step 2), resumed by the JAX stage-1 engine
    j1 = jax_runs["s1"]["engine"]
    j1.load_checkpoint(str(tmp / "port_s3"), tag="port")
    jax_runs["resumed_from_port"] = float(j1.train_batch({"tokens": tokens})["loss"])
    # the port's world-2 cpu-tier save (each rank's master and moment shards), resumed by JAX's cpu tier
    j2 = jax_runs["off2"]["engine"]
    j2.load_checkpoint(str(tmp / "port_off2"), tag="port")
    jax_runs["off2_resumed_from_port"] = float(j2.train_batch({"tokens": tokens})["loss"])
    # the async world-2 save (ZeRO 2: the optimizer state in shards), into a port world of 1
    import deepspeed_tpu_torch

    w1 = deepspeed_tpu_torch.initialize(model=tfm.Model(tfm.TransformerConfig(**MODEL, dtype=torch.float32)),
                                        config=port_ds(8, zero_optimization={"stage": 2}), device="cpu")[0]
    w1.load_checkpoint(str(tmp / "port_async"), tag="port")
    jax_runs["async_resumed_at_world1"] = float(w1.train_batch({"tokens": tokens})["loss"])
    jax_runs["async_manifest"] = saver.read_manifest(str(tmp / "port_async" / "port"))
    for r in jax_runs.values():
        if isinstance(r, dict):
            r.pop("engine", None)
    return {"jax": jax_runs, "w1": world1, "w2": w2, "w4": w4, "tokens": tokens, "init": init}


def _losses(world, name, rank=0):
    return world[0][rank][f"{name}::losses"]


def _params(world, name, rank=0):
    prefix = f"{name}::params::"
    return {k[len(prefix):]: v for k, v in world[0][rank].items() if k.startswith(prefix)}


# The elements whose Adam steps are noise-dominated: fp32 summation noise in
# a gradient at its level moves them by up to lr either way. Readings over
# worlds 2 and 4 at every stage, against JAX (CPU): at most 1 element a leaf
# beyond PARAM_ATOL (in wte, wo_mlp or wi), at most 2.41e-5 away; bk, whose
# gradient is 0 in exact arithmetic, 4.92e-5 to 9.89e-5 (masked labels).
NOISE_COUNT = 2
NOISE_ATOL = 1e-4
BK_ATOL = 2e-4


def _assert_params(got, want, atol=PARAM_ATOL):
    """Every leaf within ``atol``, but for at most ``NOISE_COUNT`` elements
    a leaf whose gradient is at the level of fp32 summation noise (Adam
    normalises that noise into a step, so a world summing its gradients in
    another order moves them differently): those within ``NOISE_ATOL``.
    ``bk``, all such elements, is held to ``BK_ATOL``."""
    assert set(got) == set(want)
    for k in want:
        d = np.abs(got[k].astype(np.float64) - want[k])
        if k.endswith("::bk"):
            assert d.max() <= BK_ATOL, (k, d.max())
            continue
        assert d.max() <= NOISE_ATOL and (d > atol).sum() <= NOISE_COUNT, (k, d.max(), int((d > atol).sum()))


def _assert_params_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_world2_losses_and_params_match_jax(runs, stage):
    want = runs["jax"][f"s{stage}"]
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], f"s{stage}", r), want["losses"], rtol=LOSS_RTOL)
        _assert_params(_params(runs["w2"], f"s{stage}", r), want["params"])


@pytest.mark.parametrize("stage", [1, 3])
def test_world4_data_by_fsdp_matches_jax(runs, stage):
    """A 2 x 2 data x fsdp world of 4 against JAX's {data: 2, fsdp: 4} mesh
    (test_engine.py's fsdp configuration): the same global batch, so the
    same losses and parameters."""
    want = runs["jax"][f"x4s{stage}"]
    for r in range(4):
        np.testing.assert_allclose(_losses(runs["w4"], f"x4s{stage}", r), want["losses"], rtol=LOSS_RTOL)
        _assert_params(_params(runs["w4"], f"x4s{stage}", r), want["params"])
        assert runs["w4"][1][r][f"x4s{stage}"]["mesh"]["data"] == 2


def test_bf16_stage2_matches_jax(runs):
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], "bf16", r), runs["jax"]["bf16"]["losses"], rtol=2e-2)


def test_gradient_accumulation_equivalence(runs):
    """micro 4 x gas 2 and micro 8 x gas 1 take the same steps."""
    np.testing.assert_allclose(_losses(runs["w2"], "gas1"), _losses(runs["w2"], "s2"), rtol=LOSS_RTOL)
    _assert_params(_params(runs["w2"], "gas1"), _params(runs["w2"], "s2"))


def test_stage3_under_remat_and_the_three_call_loop_match(runs):
    """ZeRO-3 under activation checkpointing (the recompute gathers each
    layer again) and DeepSpeed's 3-call loop on each rank's rows take stage
    3's steps bitwise."""
    for r in range(2):
        np.testing.assert_array_equal(_losses(runs["w2"], "s3remat", r), _losses(runs["w2"], "s3", r))
        _assert_params_equal(_params(runs["w2"], "s3remat", r), _params(runs["w2"], "s3", r))
        _assert_params_equal(_params(runs["w2"], "s3loop", r), _params(runs["w2"], "s3", r))


@pytest.mark.parametrize("stage", [2, 3])
def test_masked_labels_take_the_global_token_mean(runs, stage):
    """With ``labels`` masked far more on rank 0's rows than on rank 1's,
    each rank weights its token mean by its share of the micro-batch's
    labelled tokens, so world 2 takes JAX's mean over the global
    micro-batch: JAX's losses and parameters (a mean of the ranks' means
    is 1.2e-2 away, relative, by the third loss)."""
    want = runs["jax"]["masked"]
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], f"masked{stage}", r), want["losses"], rtol=LOSS_RTOL)
        _assert_params(_params(runs["w2"], f"masked{stage}", r), want["params"])


@pytest.mark.parametrize("case", ["off1", "off2", "off3", "offp3"])
def test_cpu_tier_at_world2_matches_jax(runs, case):
    """ZeRO-Offload at world 2 (``offp3``: with ZeRO-3's parameter shards
    in host memory too, ``offload_param``): each rank's host masters and
    moments are its shards of the optimizer state's split (half of every
    sharded leaf), and the steps are the JAX cpu tier's on its 8-device
    mesh (losses, and the fp32 parameters against JAX's masters)."""
    want = runs["jax"][case]
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], case, r), want["losses"], rtol=LOSS_RTOL)
        _assert_params(_params(runs["w2"], case, r), want["params"])
        meta = runs["w2"][1][r][case]
        opt = {k: v for k, v in meta["layouts"].items() if k.startswith("opt::")}
        assert meta["master_numel"] == sum(v[2] for v in opt.values()) == sum(v[3] for v in opt.values()) // 2
        assert meta["tier_streamed"] == (case == "offp3")


def test_cpu_tier_at_world1_under_a_process_group_runs_its_own_path(runs):
    """A world of 1 under a process group (gloo here; NCCL on the card)
    shards nothing: no ZeRO runtime, the cpu tier's single-device path,
    whole masters, and the JAX cpu tier's steps."""
    meta = runs["w1"][1][0]["w1off2"]
    assert meta["zero_runtime"] is False and meta["mesh"]["data"] == 1
    assert meta["master_numel"] == sum(v.size for v in runs["init"].values())
    np.testing.assert_allclose(_losses(runs["w1"], "w1off2"), runs["jax"]["off2"]["losses"], rtol=LOSS_RTOL)
    _assert_params(_params(runs["w1"], "w1off2"), runs["jax"]["off2"]["params"])


def test_offload_param_at_world2_takes_the_cpu_tiers_steps(runs):
    """Streaming the parameter shards from host memory changes where they
    live, not the arithmetic: ``offp3`` takes ``off3``'s steps bitwise."""
    for r in range(2):
        np.testing.assert_array_equal(_losses(runs["w2"], "offp3", r), _losses(runs["w2"], "off3", r))
        _assert_params_equal(_params(runs["w2"], "offp3", r), _params(runs["w2"], "off3", r))


def test_cpu_tier_world2_checkpoint_resumes_in_jax(runs):
    """The world-2 cpu tier's save (each rank's master and moment shards,
    rank 0's manifest) loads into the JAX cpu tier, whose next loss is the
    port's."""
    np.testing.assert_allclose(runs["jax"]["off2_resumed_from_port"], _losses(runs["w2"], "off2")[2],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("stage", [2, 3])
def test_lamb_with_sharded_state_matches_jax(runs, stage):
    """LAMB's trust ratio is a whole leaf's: each rank's sums of squares of
    its shard of the weights and of the update are summed over the ranks
    (one all-reduce a step), so world 2 takes the JAX engine's LAMB steps."""
    want = runs["jax"]["lamb"]
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], f"lamb{stage}", r), want["losses"], rtol=LOSS_RTOL)
        _assert_params(_params(runs["w2"], f"lamb{stage}", r), want["params"])


def test_fp16_nan_on_one_rank_skips_on_every_rank(runs):
    """A NaN gradient injected on rank 1 only, at step 2: the non-finite
    count is reduced over the ranks, so both skip that step (and only it)
    and keep the same parameters."""
    for r in range(2):
        assert runs["w2"][0][r]["fp16nan::overflow"].tolist() == [False, True, False]
        assert runs["w2"][1][r]["fp16nan"]["skipped"] == 1
    _assert_params_equal(_params(runs["w2"], "fp16nan", 1), _params(runs["w2"], "fp16nan", 0))


SPEC_MESHES = [{"data": 2}, {"data": 2, "fsdp": 2}, {"fsdp": 4}, {"data": 8}, {"data": 2, "fsdp": 4}]


class _ShapeMesh:
    def __init__(self, shape):
        self.shape = {"pipe": 1, "data": 1, "fsdp": 1, "context": 1, "model": 1, **shape}


@pytest.mark.parametrize("stage", [1, 2, 3])
@pytest.mark.parametrize("mesh", range(len(SPEC_MESHES)))
def test_shard_dims_match_jax_spec_from_logical(stage, mesh):
    """Every leaf's spec (hence its shard dimension) is JAX's for the same
    mesh shape, params and optimizer state alike."""
    m = _ShapeMesh(SPEC_MESHES[mesh])
    cfg = tfm.TransformerConfig(**MODEL, use_bias=True)
    axes = tfm.logical_axes(cfg)
    shapes = tfm.init(cfg, torch.Generator().manual_seed(0))
    tp, to = tshd.zero_stage_rules(stage)
    jp, jo = jshd.zero_stage_rules(stage)
    for key, ax in _axes_flat(axes).items():
        shape = tuple(saver._flatten_with_paths(shapes)[key].shape)
        for tr, jr, fb in ((tp, jp, ZERO_FALLBACK if stage == 3 else None), (to, jo, ZERO_FALLBACK)):
            want = tuple(jshd.spec_from_logical(ax, shape, jr, m, zero_fallback=fb))
            assert tshd.spec_from_logical(ax, shape, tr, m, zero_fallback=fb) == want, (key, stage)


@pytest.mark.parametrize("case", ["s1", "s2", "s3", "x4s1", "x4s3"])
def test_each_rank_holds_its_share_on_jax_dims(runs, case):
    """Each rank holds 1/N of every sharded leaf's optimizer state (and of
    its parameters at stage 3), split on the dimension JAX's spec names for
    the engine's mesh."""
    world = runs["w4"] if case.startswith("x4") else runs["w2"]
    n = len(world[0])
    stage = int(case[-1])
    meta = world[1][0][case]
    m = _ShapeMesh({k: v for k, v in meta["mesh"].items() if v > 1})
    cfg = tfm.TransformerConfig(**MODEL)
    axes = _axes_flat(tfm.logical_axes(cfg))
    _, jo = jshd.zero_stage_rules(stage)
    jp = jshd.zero_stage_rules(stage)[0]
    for key, (dim, parts, held, full) in meta["layouts"].items():
        tag, leaf = key.split("::", 1)
        rules, fb = (jo, ZERO_FALLBACK) if tag == "opt" else (jp, ZERO_FALLBACK if stage == 3 else None)
        spec = tuple(jshd.spec_from_logical(axes[leaf], runs["init"][leaf].shape, rules, m, zero_fallback=fb))
        want_dim = next((i for i, a in enumerate(spec) if a is not None), -1)
        assert dim == want_dim, (case, key, spec)
        if tag == "params" and stage < 3:
            assert held == full, key
        else:
            assert parts == (n if want_dim >= 0 else 1) and held * parts == full, key


def test_port_world2_stage3_checkpoint_resumes_in_jax(runs):
    """The port's world-2 ZeRO-3 save (each rank's shards, rank 0's manifest)
    loads into the JAX stage-1 engine, whose next loss is the port's."""
    np.testing.assert_allclose(runs["jax"]["resumed_from_port"], _losses(runs["w2"], "s3")[2], rtol=LOSS_RTOL)


def test_async_save_at_world2_commits_every_ranks_shards(runs):
    """An async save at world 2 (ZeRO 2) commits once every rank's shards
    are written: the manifest lists each moment's two shards with their
    crc32s, and a world of 1 resumes from it with world 2's next loss."""
    manifest = runs["jax"]["async_manifest"]
    shards = [e["shards"] for k, e in manifest["leaves"].items() if k.startswith("opt::") and "shards" in e]
    assert shards and all(len(sh) == 2 for sh in shards)
    assert all(sh["file"] in manifest["checksums"] for leaf in shards for sh in leaf)
    np.testing.assert_allclose(runs["jax"]["async_resumed_at_world1"], _losses(runs["w2"], "async")[2],
                               rtol=LOSS_RTOL)


def test_jax_8_device_stage3_checkpoint_resumes_in_port_world2(runs):
    """JAX's 8-device ZeRO-3 save (its shards) loads into a port world of 2
    at stage 3, each rank reading its slices; the next loss is JAX's."""
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], "jaxload", r)[0], runs["jax"]["s3"]["losses"][2],
                                   rtol=LOSS_RTOL)


def test_interop_shards_the_jax_state_for_each_rank(runs):
    """``interop.shard_state_from_jax`` gives each rank of a world-2 stage-3
    engine its part of the JAX engine's state after 2 steps: the next loss
    is JAX's third."""
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], "interop", r)[0], runs["jax"]["s3"]["losses"][2],
                                   rtol=LOSS_RTOL)


def test_dropout_world2_equals_world1(runs):
    """Each rank hashes its rows' global indices (``row_offset``), so a world
    of 2 draws exactly the masks a world of 1 draws on the same global
    micro-batch: the masks bitwise, the losses to fp32 summation order."""
    key = tfm.dropout_key(0, torch.tensor(1), 0)
    whole = tfm._uniform(key, (8, 32, 64))
    for r in range(2):
        assert torch.equal(tfm._uniform(key, (4, 32, 64), row_offset=4 * r), whole[4 * r:4 * r + 4])
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import interop

    cfg = tfm.TransformerConfig(**MODEL, hidden_dropout=0.1, dtype=torch.float32)
    params = interop.params_from_jax({k: v for k, v in _unflatten(runs["init"]).items()})
    eng = deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=port_ds(8, zero_optimization={"stage": 0}),
                                         model_parameters=params, device="cpu")[0]
    w1 = [float(eng.train_batch({"tokens": runs["tokens"]})["loss"]) for _ in range(2)]
    for r in range(2):
        np.testing.assert_allclose(_losses(runs["w2"], "dropout", r), w1, rtol=1e-6)


def _unflatten(flat):
    out = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("::")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def test_snapshot_carries_the_collective_ledger_and_reconcile(runs):
    """With the comms logger on, the train step's measured call recorded its
    collectives (the step anatomy's bytes by axis, comm times labeled nulls
    on the CPU) and the snapshot reconciles them with the logger's."""
    snap = runs["w2"][1][0]["ledger"]["snapshot"]
    row = next(r for r in snap["step_anatomy"] if r["name"].startswith("train/train_step"))
    assert row["comm_bytes_by_axis"] and row["comm_time_s"] is None and row["overlap_verdict"] == "serialized"
    verdicts = {r["axis"]: r["verdict"] for r in snap["comm_reconcile"]}
    assert verdicts and set(verdicts.values()) == {"ok"}, verdicts
    # the pools are this rank's own bytes: two fp32 moments of the shards it holds
    held = sum(v[2] for k, v in runs["w2"][1][0]["ledger"]["layouts"].items() if k.startswith("opt::"))
    assert runs["w2"][1][0]["ledger"]["pools"]["opt_state"] == 2 * 4 * held
