"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX package,
it runs on CUDA unless asked for the CPU, and its kernel wrappers take the
plain path only for CPU tensors. The no-JAX subprocess imports every module
and runs a serving step, a two-replica Router with a journal through a
replica's death, a disaggregated Router with the flight recorder on, a bf16
KV window through the int8 codec with no ``ml_dtypes``, a flash training step and a block-sparse training step
fed by the curriculum and the dataloader, a pipelined model's loss with both stages in process, and an MoE
model's training step and generate; two such processes take a
data-parallel ZeRO-3 step in a gloo world, and two serve at tp_size 2
(generate and the ServingEngine's driver and follower); the serving
worker's, the
launchers', the elastic inspector's, the chaos conductor's, the report
CLI's and env_report's ``python -m`` entry points run with JAX blocked
too; the training step there carries the program ledger, the timers and
the flops profiler."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "deepspeed_tpu_torch"
TINY = dict(vocab_size=97, max_seq_len=128, num_layers=2, num_heads=4, hidden_size=32)

_NO_JAX = f"""
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["deepspeed_tpu"] = None
import importlib, pkgutil
import numpy as np
import deepspeed_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "deepspeed_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
eng = pkg.init_inference(Model(TransformerConfig(**{TINY!r})), config={{"dtype": "fp32"}}, device="cpu")
out = eng.generate(np.zeros((2, 5), np.int32), max_new_tokens=4)
assert out.shape == (2, 4)
from deepspeed_tpu_torch.inference import Request, ServingEngine
srv = ServingEngine(eng, config={{"n_slots": 2, "prefix_cache": {{"enabled": True}},
                                 "chunked_prefill": {{"enabled": True}}, "speculation": {{"enabled": True}}}})
res = srv.serve([Request(uid=i, prompt=np.arange(5 + i, dtype=np.int32), max_new_tokens=3) for i in range(3)])
assert all(r.ok for r in res.values()) and srv.compile_counts()["decode"] == 1
import tempfile, os
from deepspeed_tpu_torch.inference import Router, RequestJournal
with tempfile.TemporaryDirectory() as d:
    router = Router(eng, config={{"n_slots": 2, "router": {{"replicas": 2, "journal": {{"enabled": True,
                                 "path": os.path.join(d, "j")}}}},
                                 "fault_injection": {{"enabled": True, "replica_dead_at": [[0, 2]]}}}})
    res = router.serve([Request(uid=i, prompt=np.arange(5 + i, dtype=np.int32), max_new_tokens=3)
                        for i in range(3)])
    assert all(r.ok for r in res.values()) and router.replica_states()[0] == "dead"
    assert sorted(RequestJournal(os.path.join(d, "j")).state.terminals) == [0, 1, 2]
    router = Router(eng, config={{"n_slots": 2, "router": {{"disagg": {{"enabled": True}}}},
                                 "incidents": {{"enabled": True, "dir": os.path.join(d, "inc")}},
                                 "slo": {{"enabled": True}}}})
    res = router.serve([Request(uid=i, prompt=np.arange(5 + i, dtype=np.int32), max_new_tokens=3)
                        for i in range(3)])
    assert all(r.ok for r in res.values()) and router.router_stats()["disagg"]["handoffs"] == 3
import torch
from deepspeed_tpu_torch.inference import rpc
k = torch.ones((2, 1, 8, 4, 8), dtype=torch.bfloat16)
assert rpc.decode_kv_window(rpc._dec_value(rpc.encode_kv_window(k, k, "int8")))[0].dtype == torch.bfloat16
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m] is not None]
model = Model(TransformerConfig(**{TINY!r}, attn_impl="flash"))
trainer, _, _, _ = pkg.initialize(model=model, config={{"train_batch_size": 2, "wall_clock_breakdown": True,
                                  "flops_profiler": {{"enabled": True}}}}, device="cpu")
metrics = trainer.train_batch({{"tokens": np.zeros((2, 9), np.int32)}})
assert np.isfinite(float(metrics["loss"]))
snap = trainer.telemetry_snapshot()  # the program ledger, on by default
assert snap["program_ledger"][0]["kernels"]["flash_forward"]["calls"] == 2
assert snap["platform"]["label"] == "cpu (unrated)" and "timer/train_batch_sec" in snap["metrics"]["histograms"]
sparse = Model(TransformerConfig(**{TINY!r}))
ds = {{"train_batch_size": 2, "sparse_attention": {{"mode": "bigbird", "block": 16, "num_random_blocks": 1}},
      "curriculum_learning": {{"enabled": True, "min_difficulty": 16, "max_difficulty": 32,
                              "schedule_type": "fixed_discrete",
                              "schedule_config": {{"difficulty": [16, 32], "max_step": [1]}}}}}}
data = [{{"tokens": np.full(33, i, np.int32)}} for i in range(4)]
trainer, _, loader, _ = pkg.initialize(model=sparse, config=ds, training_data=data, device="cpu")
assert trainer.model.config.attn_impl == "sparse"
metrics = trainer.train_batch(next(iter(loader)))
assert np.isfinite(float(metrics["loss"])) and trainer.curriculum_scheduler.get_current_difficulty() == 16
with tempfile.TemporaryDirectory() as d:
    tiers = {{"train_batch_size": 2, "zero_optimization": {{"stage": 1, "sub_group_size": 20000,
             "offload_optimizer": {{"device": "nvme", "nvme_path": d}}, "offload_param": {{"device": "nvme"}}}}}}
    trainer, _, _, _ = pkg.initialize(model=Model(TransformerConfig(**{TINY!r})), config=tiers, device="cpu")
    metrics = trainer.train_batch({{"tokens": np.zeros((2, 9), np.int32)}})
    assert np.isfinite(float(metrics["loss"])) and trainer.tier.nvme.step_count == 1
    trainer.close()
from deepspeed_tpu_torch.pipe import PipelinedTransformer, TrainSchedule
piped = PipelinedTransformer(TransformerConfig(**{TINY!r}), num_stages=2, num_micro_batches=2)
loss = piped.loss(piped.init(torch.Generator().manual_seed(0)), {{"tokens": torch.zeros((4, 9), dtype=torch.long)}})
assert np.isfinite(float(loss)) and len(TrainSchedule(2, 2, 0).steps()) == 7
moe_cfg = TransformerConfig(**{TINY!r}, moe_every=1, num_experts=4, moe_top_k=2)
trainer, _, _, _ = pkg.initialize(model=Model(moe_cfg), config={{"train_batch_size": 2}}, device="cpu")
assert np.isfinite(float(trainer.train_batch({{"tokens": np.zeros((2, 9), np.int32)}})["loss"]))
moe_eng = pkg.init_inference(Model(moe_cfg), config={{"dtype": "fp32"}}, device="cpu")
assert moe_eng.generate(np.zeros((2, 5), np.int32), max_new_tokens=3).shape == (2, 3)
assert not any(m == "jax" or m.startswith(("jax.", "deepspeed_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("imported", len(names), "modules")
"""


def test_package_imports_and_generates_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


_DP_RANK = """
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["deepspeed_tpu"] = None
import numpy as np
import deepspeed_tpu_torch as pkg
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
rank, store = int(sys.argv[1]), sys.argv[2]
comm.init_distributed(init_method="file://" + store, world_size=2, rank=rank, backend="gloo", timeout_s=60.0)
eng = pkg.initialize(model=Model(TransformerConfig(**TINY)), device="cpu",
                     config={"train_batch_size": 4, "zero_optimization": {"stage": 3}})[0]
assert eng.z3 is not None and eng.zero.fraction_held() == {"params": 0.5, "opt_state": 0.5}
loss = float(eng.train_batch({"tokens": np.arange(4 * 9, dtype=np.int32).reshape(4, 9) % 97})["loss"])
assert np.isfinite(loss)
assert not any(m == "jax" or m.startswith(("jax.", "deepspeed_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("LOSS", repr(loss))
comm.destroy_distributed()
"""


def test_data_parallel_world2_stage3_step_without_jax(tmp_path):
    """Two ranks, each a process with jax and the JAX package blocked, join a
    gloo world and take one ZeRO-3 train_batch; they agree on the loss."""
    script = "TINY = " + repr(TINY) + "\n" + _DP_RANK
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(tmp_path / "store")], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-2000:] for o in outs)
    losses = {next(line for line in o.splitlines() if line.startswith("LOSS")) for o in outs}
    assert len(losses) == 1, losses


_TP_RANK = """
import sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["deepspeed_tpu"] = None
import numpy as np
import deepspeed_tpu_torch as pkg
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference import Request, ServingEngine
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
rank, store = int(sys.argv[1]), sys.argv[2]
comm.init_distributed(init_method="file://" + store, world_size=2, rank=rank, backend="gloo", timeout_s=60.0)
eng = pkg.init_inference(Model(TransformerConfig(**TINY)), config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
                         device="cpu")
assert eng.heads == 2 and eng.params["layers"]["wq"].shape[2] == 2
out = eng.generate(np.arange(10, dtype=np.int32).reshape(2, 5), max_new_tokens=4)
srv = ServingEngine(eng, config={"n_slots": 2, "prefix_cache": {"enabled": True}, "speculation": {"enabled": True}})
res = srv.serve([Request(uid=i, prompt=np.arange(5 + i, dtype=np.int32), max_new_tokens=3) for i in range(3)])
assert all(r.ok for r in res.values())
assert not any(m == "jax" or m.startswith(("jax.", "deepspeed_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("OUT", out.tolist(), sorted((u, r.tokens.tolist()) for u, r in res.items()))
srv.close()
comm.destroy_distributed()
"""


def test_tensor_parallel_world2_generate_and_serve_without_jax(tmp_path):
    """Two ranks, each a process with jax and the JAX package blocked, serve
    at tp_size 2 over gloo: generate, then the ServingEngine (the driver
    and its follower); both return the same tokens."""
    script = "TINY = " + repr(TINY) + "\n" + _TP_RANK
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(tmp_path / "store")], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-2000:] for o in outs)
    got = {next(line for line in o.splitlines() if line.startswith("OUT")) for o in outs}
    assert len(got) == 1, got


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                yield node.args[0].value


_WORKER_HELP = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["deepspeed_tpu"] = None
sys.argv = ["serving_worker", "--help"]
try:
    runpy.run_module("deepspeed_tpu_torch.launcher.serving_worker", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
assert not any(m == "jax" or m.startswith(("jax.", "deepspeed_tpu.")) for m in sys.modules if sys.modules[m] is not None)
"""


def test_serving_worker_entry_point_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _WORKER_HELP], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--socket" in proc.stdout


_TP_TRAIN_WORKER = """
import sys
sys.modules["jax"] = None
sys.modules["deepspeed_tpu"] = None
sys.argv = ["chip_smoke.py", "--tp-train-worker", "--tpt-case", "b", "--model", "tiny", "--device", "cpu"]
import chip_smoke
seen = []
chip_smoke.tp_train_worker = lambda args: seen.append((args.tpt_case, args.model, args.device)) or 0
assert chip_smoke.main() == 0 and seen == [("b", "tiny", "cpu")], seen
assert chip_smoke.tpt_config("b", "tiny")["mesh"] == {"data": 2, "model": 2}
assert chip_smoke.tpt_config("b", "tiny")["activation_checkpointing"]["partition_activations"]
assert "mesh" not in chip_smoke.tpt_config("b", "tiny", reference=True)
assert not any(m == "jax" or m.startswith(("jax.", "deepspeed_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("tp train worker ok")
"""


_PIPE_WORKER = """
import sys
sys.modules["jax"] = None
sys.modules["deepspeed_tpu"] = None
sys.argv = ["chip_smoke.py", "--pipe-worker", "--model", "tiny", "--device", "cpu"]
import chip_smoke
seen = []
chip_smoke.pipe_worker = lambda args: seen.append((args.model, args.device)) or 0
assert chip_smoke.main() == 0 and seen == [("tiny", "cpu")], seen
assert chip_smoke.pipe_config("tiny", "1f1b")["mesh"] == {"pipe": 2}
assert "mesh" not in chip_smoke.pipe_config("tiny", None, reference=True)
assert not any(m == "jax" or m.startswith(("jax.", "deepspeed_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("pipe worker ok")
"""


def test_chip_smoke_pipe_worker_mode_runs_without_jax():
    """Phase 29's rank mode (``chip_smoke.py --pipe-worker``) parses and
    dispatches with jax and the JAX package blocked."""
    proc = subprocess.run([sys.executable, "-c", _PIPE_WORKER], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "pipe worker ok" in proc.stdout


def test_chip_smoke_tp_train_worker_mode_runs_without_jax():
    """Phase 28's rank mode (``chip_smoke.py --tp-train-worker``) parses and
    dispatches with jax and the JAX package blocked."""
    proc = subprocess.run([sys.executable, "-c", _TP_TRAIN_WORKER], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "tp train worker ok" in proc.stdout


_CLIS = """
import json, os, runpy, sys, tempfile
sys.modules["jax"] = None
sys.modules["deepspeed_tpu"] = None


def run(module, *argv):
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__")
    except SystemExit as e:
        return e.code
    return 0


with tempfile.TemporaryDirectory() as d:
    cfg = os.path.join(d, "ds.json")
    with open(cfg, "w") as f:
        json.dump({"elasticity": {"enabled": True, "max_train_batch_size": 64, "micro_batch_sizes": [8, 16]}}, f)
    assert run("deepspeed_tpu_torch.elasticity", "-c", cfg, "-w", "4") == 0
    assert run("deepspeed_tpu_torch.elasticity", "-c", cfg, "-w", "3") == 3
    assert run("deepspeed_tpu_torch.resilience.chaos", "--search", "2", "--artifact-dir", d) == 0
    assert run("deepspeed_tpu_torch.launcher.runner", "--help") == 0
    assert run("deepspeed_tpu_torch.launcher.launch", "--help") == 0
    with open(os.path.join(d, "t.jsonl"), "w") as f:
        f.write(json.dumps({"type": "snapshot", "metrics": {}, "program_ledger": [
            {"name": "p", "flops": 1e9, "bytes_accessed": 1e8, "roofline": "unrated:cpu"}]}) + "\\n")
    assert run("deepspeed_tpu_torch.telemetry.report", os.path.join(d, "t.jsonl")) == 0
    assert run("deepspeed_tpu_torch.env_report") == 0
assert not any(m == "jax" or m.startswith(("jax.", "deepspeed_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("entry points ok")
"""


def test_launch_elastic_and_chaos_entry_points_run_without_jax():
    proc = subprocess.run([sys.executable, "-c", _CLIS], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "entry points ok" in proc.stdout
    assert "micro_batch_per_chip=16" in proc.stdout and '"schedules_run": 2' in proc.stdout


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "tests" / "torch_dp_worker.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imported_modules(path)
           if m == "jax" or m.startswith("jax.") or m == "deepspeed_tpu" or m.startswith("deepspeed_tpu.")]
    assert not bad, f"{path} imports {bad}"


def test_entry_point_needs_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(Model(TransformerConfig(**TINY)), config={"dtype": "fp32"})
    eng = deepspeed_tpu_torch.init_inference(Model(TransformerConfig(**TINY)),
                                             config={"dtype": "fp32"}, device="cpu")
    assert eng.params["wte"].device.type == "cpu"
    assert eng.generate([[1, 2, 3]], max_new_tokens=3).shape == (1, 3)
    ds = {"train_batch_size": 1}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=Model(TransformerConfig(**TINY)), config=ds)
    trainer, _, _, _ = deepspeed_tpu_torch.initialize(model=Model(TransformerConfig(**TINY)), config=ds,
                                                      device="cpu")
    assert trainer.state["params"]["wte"].device.type == "cpu"


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 8, generator=g)
    k, v = torch.randn(2, 2, 16, 3, 8, generator=g)
    before = decode_attention.launches
    out = decode_attention(q, k, v, torch.tensor([4, 15]))
    assert decode_attention.launches == before
    torch.testing.assert_close(out, decode_attention_reference(q, k, v, torch.tensor([4, 15])),
                               rtol=0, atol=0)


# dstpu-lint's code rules (bin/dstpu_lint --list-rules, file scope); the
# doc-drift rules are left out: they hold docs/, which catalogs the JAX
# package's config keys and metrics, against the tree given
LINT_CODE_RULES = ("append-durability", "blocking-under-lock", "broad-except", "parse-error", "pragma",
                   "rename-durability", "secret-hygiene", "socket-discipline", "unguarded-donation",
                   "unlogged-collective", "wall-clock-verdict")


def test_port_passes_the_code_lint_rules():
    proc = subprocess.run([sys.executable, str(REPO / "bin" / "dstpu_lint"), str(PKG), "--rule",
                           ",".join(LINT_CODE_RULES)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout


def test_aio_engine_builds_under_the_ignored_build_dir():
    """The NVMe tier's host library is built by g++ into
    build/deepspeed_tpu_torch/, which .gitignore's build/ covers."""
    from deepspeed_tpu_torch.ops import op_builder

    lib = op_builder.build_host("aio/dstpu_aio.cpp")
    assert lib.parent == REPO / "build" / "deepspeed_tpu_torch" and lib.name.startswith("libdstpu_aio_")
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert (PKG / "csrc" / "aio" / "dstpu_aio.cpp").exists()
