"""One rank of a gloo world for the port's data- and tensor-parallel CPU
tests (``test_torch_comm.py``, ``test_torch_zero.py``,
``test_torch_zero_init.py``, ``test_torch_tensor_parallel.py``,
``test_torch_tp_serving.py``, ``test_torch_tp_training.py``,
``test_torch_tp_checkpoint.py``, ``test_torch_ckpt_agreement.py``,
``test_torch_pipe.py``).

    python tests/torch_dp_worker.py JOB SPEC.json RANK WORLD

joins the world through the FileStore named in the spec, runs JOB
(``comm``, ``zero``, ``zero_init``, ``tp_engine``, ``tp_serving``,
``tp_ops``, ``tp_train``, ``ckpt_retry`` or ``pipe``) and
writes ``<out>/rank<RANK>.npz``
(and a JSON sidecar). It imports the port only: never jax or the JAX
package. The tests start the ranks with ``subprocess`` (never ``fork``: the
test workers have JAX's threads running), once per test module.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import deepspeed_tpu_torch  # noqa: E402
from deepspeed_tpu_torch import comm  # noqa: E402
from deepspeed_tpu_torch.checkpoint import saver  # noqa: E402
from deepspeed_tpu_torch.models import transformer as tfm  # noqa: E402
from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map  # noqa: E402

COMM_AXES = {"data": "data", "fsdp": "fsdp", "data+fsdp": ("data", "fsdp"), "fsdp+data": ("fsdp", "data")}


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("::")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(arr))
    return out


def comm_job(spec, rank, world) -> dict:
    """Every collective of ``comm/`` on this rank's rows of the spec's inputs,
    over each axis spelling."""
    comm.build_mesh(comm.MeshConfig(data=2, fsdp=2))
    x = torch.from_numpy(np.load(spec["inputs"])["x"][rank])  # [8, 6]
    out = {}
    for label, axes in COMM_AXES.items():
        for op in ("sum", "mean", "max", "min"):
            out[f"all_reduce_{op}@{label}"] = comm.all_reduce(x, axes, op)
        out[f"reduce_scatter@{label}"] = comm.reduce_scatter(x, axes, scatter_dimension=0)
        out[f"all_gather@{label}"] = comm.all_gather(x, axes, gather_dimension=1)
        out[f"all_to_all@{label}"] = comm.all_to_all(x, axes, split_axis=0, concat_axis=1)
        out[f"ring_shift@{label}"] = comm.ring_shift(x, axes, shift=1)
        out[f"broadcast@{label}"] = comm.broadcast_in_axis(x, axes, src_index=1)
    return {k: v.numpy() for k, v in out.items()}


def _engine(case, params, spec):
    cfg = tfm.TransformerConfig(**{**spec["model"], **case.get("model", {})}, dtype=torch.float32)
    ds = dict(spec["ds"], **case.get("ds", {}))
    return deepspeed_tpu_torch.initialize(model=tfm.Model(cfg), config=ds,
                                          model_parameters=tree_map(lambda t: t.clone(), params),
                                          device="cpu")[0]


def _layout_record(engine) -> dict:
    """{leaf: [dim or -1, n, held numel, full numel]} of the params (stage 3)
    and the optimizer's first moment-like subtree."""
    z = engine.zero
    rec = {}
    first_opt = next(k for k, v in engine.state["opt"].items() if isinstance(v, dict))
    for tag, lays, held in (("params", z.param_layouts, engine.state["params"]),
                            ("opt", z.opt_layouts, engine.state["opt"][first_opt])):
        for (key, lay), t in zip(saver._flatten_with_paths(lays).items(), saver._flatten_with_paths(held).values()):
            rec[f"{tag}::{key}"] = [-1 if lay.dim is None else lay.dim, lay.n, t.numel(), int(np.prod(lay.shape))]
    return rec


def zero_job(spec, rank, world) -> tuple[dict, dict]:
    data = np.load(spec["tokens"])
    tokens = data["tokens"]
    arrays, meta = {}, {}
    for case in spec["cases"]:
        name = case["name"]
        if case.get("world", world) != world:
            continue
        if case.get("nan_rank1_at"):  # every rank has an injector; rank 1's fires
            case = dict(case, ds={**case.get("ds", {}), "resilience": {"fault_injection": {
                "enabled": True, "nan_grad_steps": [case["nan_rank1_at"]] if rank == 1 else []}}})
        params = _unflatten(dict(np.load(case.get("params", spec["params"]))))
        engine = _engine(case, params, spec)
        if case.get("jax_state"):  # the JAX engine's state, this rank's part by the port's layouts
            from deepspeed_tpu_torch import interop

            jstate = _unflatten(dict(np.load(case["jax_state"])))
            engine.state.update(interop.shard_state_from_jax(engine, jstate), step=jstate["step"].to(torch.int32))
        if case.get("load"):
            engine.load_checkpoint(case["load"], tag=case.get("load_tag"))
            if case.get("loaded_state"):  # the state as loaded, before any step
                for what, tree in (("params", engine.full_params()), ("opt", full_opt(engine))):
                    arrays.update({f"{name}::loaded::{what}::{k}": t.numpy()
                                   for k, t in saver._flatten_with_paths(tree).items()})
        losses, norms, overflow = [], [], []
        for step in range(case["steps"]):
            if case.get("three_call"):  # DeepSpeed's loop on this rank's rows of each micro-batch
                gas, b = engine.gradient_accumulation_steps, engine.micro_batch_size
                micro = tokens.reshape(gas, -1, tokens.shape[1])[:, engine.dp_rank * b:(engine.dp_rank + 1) * b]
                for i in range(gas):
                    engine({"tokens": micro[i]})
                    engine.backward()
                    engine.step()
                losses.append(float("nan"))
                norms.append(float("nan"))
                overflow.append(False)
                continue
            batch = {"input_ids": data["input_ids"], "labels": data["labels"]} if case.get("labels") else \
                {"tokens": tokens}
            m = engine.train_batch(batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            overflow.append(bool(m["overflow"]))
            if case.get("save") and step + 1 == case["save_after"]:
                engine.save_checkpoint(case["save"], tag="port")
        engine.checkpoint_engine.commit()  # an async save is finished here, on every rank
        if case.get("save16"):
            engine.save_16bit_model(case["save16"])
        arrays[f"{name}::losses"] = np.asarray(losses)
        arrays[f"{name}::norms"] = np.asarray(norms)
        arrays[f"{name}::overflow"] = np.asarray(overflow)
        full = engine.full_params()
        for key, t in saver._flatten_with_paths(full).items():
            arrays[f"{name}::params::{key}"] = t.numpy()
        if case.get("full_opt"):
            for key, t in saver._flatten_with_paths(full_opt(engine)).items():
                arrays[f"{name}::opt::{key}"] = t.numpy()
        meta[name] = {"layouts": _layout_record(engine) if engine.zero else {}, "skipped": engine.skipped_steps,
                      "mesh": engine.mesh.shape, "dp_rank": engine.dp_rank, "zero_runtime": engine.zero is not None,
                      "held": engine.zero.fraction_held() if engine.zero else {},
                      "heads": None if engine.tp is None else engine.tp.heads(engine.model.config.num_heads),
                      "param_numel": sum(t.numel() for t in tree_leaves(engine.state["params"]))}
        if "master" in engine.state:  # the cpu tier: this rank's host masters
            meta[name]["master_numel"] = sum(t.numel() for t in tree_leaves(engine.state["master"]))
            meta[name]["tier_streamed"] = engine.tier.streamed
        if case.get("snapshot"):
            snap = engine.telemetry_snapshot()
            meta[name]["snapshot"] = {k: snap.get(k) for k in ("comm_reconcile", "step_anatomy")}
            meta[name]["pools"] = snap["hbm"]["pools"]
    return arrays, meta


def ckpt_retry_job(spec, rank, world) -> tuple[dict, dict]:
    """A synchronous save under ``resilience`` at this world, once per case
    of the spec (``clean``; ``flaky``/``permanent``: rank 1's first guarded
    write fails transiently / permanently): per rank, the error it raised
    (type and the failing ranks it names), its ``resilience/ckpt_retries``
    and the save's seconds."""
    import time

    from deepspeed_tpu_torch.resilience import clear_injector

    params = _unflatten(dict(np.load(spec["params"])))
    tokens = np.load(spec["tokens"])["tokens"]
    meta = {}
    for case in spec["cases"]:
        name = case["name"]
        fi = {"enabled": True, **(case.get("fault", {}) if rank == 1 else {})}
        ds = dict(spec["ds"], resilience={"enabled": True, "retry": spec["retry"], "fault_injection": fi})
        engine = _engine({"ds": ds}, params, spec)
        engine.train_batch({"tokens": tokens})
        t0 = time.monotonic()
        err = None
        try:
            engine.save_checkpoint(os.path.join(spec["dir"], name), tag="t")
        except OSError as e:
            err = e
        meta[name] = {"error": None if err is None else type(err).__name__,
                      "ranks": getattr(err, "ranks", None), "seconds": time.monotonic() - t0,
                      "retries": engine.telemetry.registry.snapshot()["counters"].get("resilience/ckpt_retries", 0)}
        clear_injector()
    return {}, meta


def pipe_job(spec, rank, world) -> tuple[dict, dict]:
    """``PipelineEngine`` over a ``PipelinedTransformer`` for each case of
    this world: ``steps`` train_batch calls on the spec's global batch (a
    save after ``save_after``, or first a load of ``load``), then the
    losses, the full parameters (gathered over ``pipe`` and ``model``), the
    executed 1F1B trace, the bubble gauge and the train step's pipeline
    anatomy row."""
    from deepspeed_tpu_torch.pipe import PipelineEngine, PipelinedTransformer

    tokens = np.load(spec["tokens"])["tokens"]
    arrays, meta = {}, {}
    for case in spec["cases"]:
        if case.get("world", 2) != world:
            continue
        name = case["name"]
        cfg = tfm.TransformerConfig(**spec["model"], dtype=torch.float32)
        model = PipelinedTransformer(cfg, spec["stages"])
        ds = dict(spec["ds"], **case["ds"])
        params = _unflatten(dict(np.load(spec["params"])))
        if case.get("interop"):  # the JAX tree's numpy leaves, cut to this rank's stage by interop
            from deepspeed_tpu_torch import interop
            from deepspeed_tpu_torch.comm.mesh import train_axes

            sizes = comm.MeshConfig(**{"data": -1, **ds["mesh"]}).sizes(world)
            mesh = comm.build_mesh(comm.MeshConfig(**sizes), axes_list=train_axes(sizes))
            params = interop.tp_params_from_jax(tree_map(lambda t: t.numpy(), params), model, mesh)
        engine = PipelineEngine(model, ds, params=params, device="cpu")
        if case.get("load"):
            engine.load_checkpoint(case["load"], tag=case["load_tag"])
        losses = []
        for step in range(case["steps"]):
            losses.append(float(engine.train_batch({"tokens": tokens})["loss"]))
            if case.get("save") and step + 1 == case["save_after"]:
                engine.save_checkpoint(case["save"], tag="port")
        arrays[f"{name}::losses"] = np.asarray(losses)
        for key, t in saver._flatten_with_paths(engine.full_params()).items():
            arrays[f"{name}::params::{key}"] = t.numpy()
        snap = engine.telemetry_snapshot()
        meta[name] = {"trace": engine.last_trace, "mesh": engine.mesh.shape, "stage": engine.stage_id,
                      "bubble": snap["metrics"]["gauges"].get("train/pipe/bubble_fraction"),
                      "pipeline_row": next((r.get("pipeline") for r in snap.get("step_anatomy", [])
                                            if r["name"].startswith("train/")), None),
                      "stage_shape": list(engine.state["params"]["layers"]["wq"].shape),
                      "table": saver._flatten_with_paths(engine._state_layouts())["params::layers::wq"].table
                      if engine._state_layouts() else None}
    return arrays, meta


def full_opt(engine) -> dict:
    """The optimizer state's params-shaped subtrees at full shape on every
    rank: the ZeRO shards gathered over the data axes, then the tensor-
    parallel slices over ``model`` (collective)."""
    from deepspeed_tpu_torch.runtime.zero.stage_1_and_2 import all_gather_rows

    out = {}
    for k, sub in engine.state["opt"].items():
        if not isinstance(sub, dict):
            continue
        if engine.zero is not None and engine.zero.stage:
            lays, leaves = tree_leaves(engine.zero.opt_layouts), tree_leaves(sub)
            idx = [i for i, lay in enumerate(lays) if lay.sharded]
            for i, f in zip(idx, all_gather_rows([leaves[i] for i in idx], [lays[i] for i in idx], 5e8)):
                leaves[i] = f
            it = iter(leaves)
            sub = tree_map(lambda _: next(it), sub)
        out[k] = sub if engine.tp is None else engine.tp.gather(sub)
    return out


def tp_ops_job(spec, rank, world) -> tuple[dict, dict]:
    """At tp = WORLD: the four conjugate collectives over ``model``, each
    one's forward on this rank's input and its backward of this rank's
    upstream gradient (integer-valued fp32, so every sum is exact); then
    the vocab-parallel loss (``_vocab_parallel_losses``)."""
    mesh = comm.build_mesh(comm.MeshConfig(data=-1, model=world), axes_list=comm.mesh.SERVING_AXES)
    data = np.load(spec["inputs"])
    out = {}
    for name, fn, x_key, g_key in (("copy", comm.copy_to_model, "x", "g"),
                                   ("reduce", comm.reduce_from_model, "x", "g"),
                                   ("gather", lambda t: comm.gather_from_model(t, dim=-1), "x", "g_wide"),
                                   ("scatter", lambda t: comm.scatter_to_model(t, dim=1), "x_wide", "g_narrow")):
        x = torch.from_numpy(data[x_key][rank]).requires_grad_()
        y = fn(x)
        y.backward(torch.from_numpy(data[g_key][rank]))
        out[f"{name}::fwd"] = y.detach().numpy()
        out[f"{name}::bwd"] = x.grad.numpy()
    out.update(_vocab_parallel_losses(spec, mesh, data))
    return out, {}


def _vocab_parallel_losses(spec, mesh, data) -> dict:
    """The vocab-parallel ``lm_loss_from_hidden`` for each case: the loss,
    the gradient of ``hidden`` and this rank's gradient of the head (the
    tied ``wte`` rows or the untied ``lm_head`` columns) gathered to full
    shape."""
    from deepspeed_tpu_torch.module_inject.layers import TensorParallel, TPParams

    out = {}
    for case in spec["cases"]:
        name = case["name"]
        cfg = tfm.TransformerConfig(**case["model"], dtype=torch.float32)
        head = "lm_head" if f"{name}::lm_head" in data else "wte"  # (an untied wte has no part in the loss)
        full = {head: torch.from_numpy(data[f"{name}::{head}"])}
        shapes = {k: tuple(v.shape) for k, v in full.items()}
        axes = {k: v for k, v in tfm.logical_axes(cfg).items() if k in full}
        tp = TensorParallel(mesh, axes, shapes)
        local = {k: tp.shard_leaf(v, k).requires_grad_() for k, v in full.items()}
        hidden = torch.from_numpy(data[f"{name}::hidden"]).requires_grad_()
        loss = tfm.lm_loss_from_hidden(cfg, TPParams(dict(local), tp), hidden,
                                       torch.from_numpy(data[f"{name}::labels"]).long())
        loss.backward()
        out[f"{name}::loss"] = loss.detach().numpy()
        out[f"{name}::d_hidden"] = hidden.grad.numpy()
        for k, t in local.items():
            out[f"{name}::d_{k}"] = tp.gather({k: t.grad})[k].numpy()
    return out


def zero_init_job(spec, rank, world) -> tuple[dict, dict]:
    """``zero.Init`` and ``GatheredParameters`` over a gloo world."""
    from deepspeed_tpu_torch.runtime.zero import GatheredParameters, Init

    mesh = comm.build_mesh(comm.MeshConfig(data=-1))
    cfg = tfm.TransformerConfig(**spec["model"], dtype=torch.float32)
    model = tfm.Model(cfg)
    out, meta = {}, {}
    with Init(mesh=mesh) as zi:
        params = zi.materialize(model.init, torch.Generator().manual_seed(0), model.logical_axes())
    meta["wq_layout"] = list(zi.layouts["layers"]["wq"].spec)
    out["wq_shard"] = params["layers"]["wq"].numpy()
    with GatheredParameters(params["layers"]) as full:
        out["wq_full"] = full["wq"].numpy()
    out["wq_shard_after"] = params["layers"]["wq"].numpy()
    with Init(mesh=mesh, dtype=torch.bfloat16) as zi:
        half = zi.materialize(model.init, torch.Generator().manual_seed(0), model.logical_axes())
    meta["bf16_dtype"] = str(half["wte"].dtype)
    with Init(mesh=mesh, enabled=False) as zi:
        plain = zi.materialize(model.init, torch.Generator().manual_seed(0))
    out["plain_wq"] = plain["layers"]["wq"].numpy()
    with GatheredParameters(params, modifier_rank=0) as full:
        full["wte"] = torch.zeros_like(full["wte"]) if rank == 0 else full["wte"]
    out["wte_after_modify"] = params["wte"].numpy()
    meta["wte_shape_after_modify"] = list(params["wte"].shape)
    # the sparse all-reduce of this rank's embedding-gradient rows
    from deepspeed_tpu_torch.runtime.sparse_tensor import SparseTensor, sparse_all_reduce

    sp = np.load(spec["sparse"])
    st = SparseTensor(torch.from_numpy(sp["ids"][rank]), torch.from_numpy(sp["vals"][rank]),
                      torch.tensor(int(sp["counts"][rank]), dtype=torch.int32), tuple(int(x) for x in sp["shape"]))
    out["sparse_dense"] = sparse_all_reduce(st, "data").to_dense().numpy()
    return out, meta


def tp_engine_job(spec, rank, world) -> tuple[dict, dict]:
    """Tensor parallelism at tp = WORLD: the TP layers against the dense
    product, then for each case an engine over the JAX weights (the full
    tree, sliced by the engine): forward logits, greedy generate, and the
    rank's shards of ``wq``, ``wo`` and ``wte``."""
    from deepspeed_tpu_torch import init_inference, interop
    from deepspeed_tpu_torch.module_inject import LinearAllreduce, LinearLayer

    lay = dict(np.load(spec["layers"]))
    mesh = comm.build_mesh(comm.MeshConfig(data=-1, model=world), axes_list=comm.mesh.SERVING_AXES)
    col, row = LinearLayer(mesh=mesh), LinearAllreduce(mesh=mesh)
    p1 = col.shard(torch.from_numpy(lay["w1"]), torch.from_numpy(lay["b1"]))
    p2 = row.shard(torch.from_numpy(lay["w2"]), torch.from_numpy(lay["b2"]))
    out = {"layers::y": row.apply(p2, col.apply(p1, torch.from_numpy(lay["x"]))).numpy(),
           "layers::w1_shard": p1["w"].numpy(), "layers::w2_shard": p2["w"].numpy()}
    meta = {}
    for case in spec["cases"]:
        name = case["name"]
        params = _unflatten(dict(np.load(case["params"])))
        cfg = tfm.TransformerConfig(**case["model"], dtype=torch.float32)
        eng = init_inference(tfm.Model(cfg), config={"dtype": "fp32", "tensor_parallel": {"tp_size": world}},
                             params=params, device="cpu")
        tokens = np.asarray(case["tokens"], np.int32)
        out[f"{name}::logits"] = eng.forward(tokens).numpy()
        out[f"{name}::generate"] = eng.generate(tokens, max_new_tokens=case["max_new"])
        out[f"{name}::sampled"] = eng.generate(tokens, max_new_tokens=case["max_new"], temperature=0.9, top_k=20)
        # the same weights handed over as this rank's slices (interop), never whole
        flat = dict(np.load(case["params"]))
        tree: dict = {}
        for key, arr in flat.items():
            node = tree
            *parents, leaf = key.split("::")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = arr
        shards = interop.tp_params_from_jax(tree, tfm.Model(cfg), comm.current_mesh())
        from_shards = init_inference(tfm.Model(cfg), config={"dtype": "fp32", "tensor_parallel": {"tp_size": world}},
                                     params=shards, device="cpu")
        out[f"{name}::logits_from_shards"] = from_shards.forward(tokens).numpy()
        for leaf in ("wq", "wo"):
            out[f"{name}::shard::{leaf}"] = eng.params["layers"][leaf].numpy()
        out[f"{name}::shard::wte"] = eng.params["wte"].numpy()
        meta[name] = {"heads": eng.heads, "split": {k: eng.tp.split(*k.split("/")) for k in
                                                    ("wte", "layers/wq", "layers/wo", "layers/wi", "layers/wo_mlp")}}
    return out, meta


def _tp_results(res: dict) -> dict:
    return {int(u): {"tokens": np.asarray(r.tokens).tolist(), "status": r.status,
                     "prefix_hit_tokens": int(r.prefix_hit_tokens), "requeues": int(r.requeues),
                     "prompt_len": int(r.prompt_len), "slot": int(r.slot)} for u, r in res.items()}


def tp_serving_job(spec, rank, world) -> tuple[dict, dict]:
    """The ``ServingEngine`` at tp = WORLD over the JAX weights: the
    driver (rank 0) serves the requests, every rank returns its results;
    then a driver that raises inside ``serve`` (its followers must raise),
    then a follower left waiting by a driver that has gone."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import Request, ServingEngine

    params = _unflatten(dict(np.load(spec["params"])))
    cfg = tfm.TransformerConfig(**spec["model"], dtype=torch.float32)
    eng = init_inference(tfm.Model(cfg), config={"dtype": "fp32", "tensor_parallel": {"tp_size": world}},
                         params=params, device="cpu")
    srv = ServingEngine(eng, config=spec["serving"])
    reqs = [Request(**{**r, "prompt": np.asarray(r["prompt"], np.int32)}) for r in spec["requests"]]
    srv.warm_decode()
    depths = srv.warm_verify()
    res = srv.serve(reqs)
    snap = srv.telemetry_snapshot()
    meta = {"results": _tp_results(res), "depths": depths, "decode_route": snap["decode_route"],
            "tensor_parallel": snap["tensor_parallel"], "compiles": srv.compile_counts()["decode"],
            "cache_heads": int(srv.worker._cache["k"].shape[3]), "pool_heads": int(srv.worker._pool["k"].shape[3]),
            "spec": list(srv.worker.spec), "comm": comm.comms_logger.prof_ops if comm.comms_logger.enabled else {}}
    if rank == 0:  # a driver that raises mid-serve still sends its closing message
        def planted(*a, **k):
            raise RuntimeError("planted driver fault")
        srv._step = planted
    try:
        srv.serve([Request(uid=100, prompt=reqs[0].prompt, max_new_tokens=2)])
        meta["raised"] = ""
    except RuntimeError as e:
        meta["raised"] = str(e)
    _write(spec, rank, {}, meta)
    # the driver leaves without a closing message: a follower's wait for
    # its next call must raise, not hang
    if rank > 0:
        try:
            srv.follow()
            left = "returned"
        except RuntimeError as e:
            left = str(e)
        with open(os.path.join(spec["out"], f"rank{rank}.left.txt"), "w") as f:
            f.write(left)
    os._exit(0)


def _write(spec, rank, arrays, meta) -> None:
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **arrays)
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(meta, f)


def main() -> int:
    job, spec_path, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    with open(spec_path) as f:
        spec = json.load(f)
    comm.init_distributed(init_method=f"file://{spec['store']}", world_size=world, rank=rank, backend="gloo",
                          timeout_s=float(spec.get("timeout_s", 300.0)))
    if job == "comm":
        arrays, meta = comm_job(spec, rank, world), {}
    elif job == "zero":
        arrays, meta = zero_job(spec, rank, world)
    elif job == "zero_init":
        arrays, meta = zero_init_job(spec, rank, world)
    elif job == "tp_engine":
        arrays, meta = tp_engine_job(spec, rank, world)
    elif job == "tp_serving":
        arrays, meta = tp_serving_job(spec, rank, world)
    elif job == "tp_ops":
        arrays, meta = tp_ops_job(spec, rank, world)
    elif job == "pipe":
        arrays, meta = pipe_job(spec, rank, world)
    elif job == "ckpt_retry":
        arrays, meta = ckpt_retry_job(spec, rank, world)
    elif job == "tp_train":  # the engine's cases (zero_job) over a mesh with a model axis
        arrays, meta = zero_job(spec, rank, world)
    else:
        raise SystemExit(f"unknown job {job!r}")
    _write(spec, rank, arrays, meta)
    comm.barrier()
    comm.destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
