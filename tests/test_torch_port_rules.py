"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX package,
it runs on CUDA unless asked for the CPU, and its kernel wrappers take the
plain path only for CPU tensors. The no-JAX subprocess imports every module
and runs a serving step, a flash training step and a block-sparse training
step fed by the curriculum and the dataloader."""

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
model = Model(TransformerConfig(**{TINY!r}, attn_impl="flash"))
trainer, _, _, _ = pkg.initialize(model=model, config={{"train_batch_size": 2}}, device="cpu")
metrics = trainer.train_batch({{"tokens": np.zeros((2, 9), np.int32)}})
assert np.isfinite(float(metrics["loss"]))
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
assert not any(m == "jax" or m.startswith(("jax.", "deepspeed_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("imported", len(names), "modules")
"""


def test_package_imports_and_generates_without_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


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


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
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
