"""Port parity: the NVMe tier (the async-I/O engine, the tensor swapper, the
NVMe-tiered optimizer and the engine's NVMe mode) against the JAX package.

``tests/test_aio.py``'s cases on the port's handle and swapper, whose swap
file is byte for byte the JAX swapper's; ``tests/test_nvme_optimizer.py``'s
cases, with the port's optimizer held to the JAX numpy tier BIT FOR BIT
over the same groups (AdamW and Adam), its saved state loaded by JAX's and
JAX's by it; and the engines: the port's NVMe engine tracks the JAX one
from the same weights, and a checkpoint of the tier crosses both ways.
"""

import glob
import logging
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu.runtime.swap_tensor import TensorSwapper as JSwapper
from deepspeed_tpu.runtime.zero.nvme_optimizer import NvmeTieredOptimizer as JNvme
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops import native
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, aio_available
from deepspeed_tpu_torch.runtime import swap_tensor
from deepspeed_tpu_torch.runtime.swap_tensor import TensorSwapper, flatten
from deepspeed_tpu_torch.runtime.zero.nvme_optimizer import NvmeTieredOptimizer
from deepspeed_tpu_torch.utils.logging import logger as port_logger


def test_the_native_probes():
    assert aio_available() and native.aio_available() and native.cpu_adam_available()


# -- the async-I/O handle (tests/test_aio.py) ---------------------------------

@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_sync_roundtrip(tmp_path, kind):
    h = AsyncIOHandle(n_threads=2)
    data = np.random.default_rng(0).normal(size=(1024, 64)).astype(np.float32)
    src = torch.from_numpy(data) if kind == "tensor" else data
    path = str(tmp_path / "t.bin")
    h.pwrite(path, src)
    out = torch.empty(1024, 64) if kind == "tensor" else np.empty_like(data)
    h.pread(path, out)
    np.testing.assert_array_equal(np.asarray(out), data)
    assert h.bytes_read == h.bytes_written == data.nbytes
    h.close()


def test_async_overlap_and_offsets(tmp_path):
    h = AsyncIOHandle(n_threads=4)
    path = str(tmp_path / "t.bin")
    parts = [torch.full((256,), i, dtype=torch.int32) for i in range(8)]
    for t in [h.async_pwrite(path, p, offset=i * 1024) for i, p in enumerate(parts)]:
        h.wait(t)
    out = torch.empty(8 * 256, dtype=torch.int32)
    h.pread(path, out)
    assert torch.equal(out.view(8, 256), torch.stack(parts))
    bufs = [torch.empty(256, dtype=torch.int32) for _ in range(8)]
    for i, b in enumerate(bufs):
        h.async_pread(path, b, offset=i * 1024)
    h.wait()  # all
    assert torch.equal(torch.stack(bufs), torch.stack(parts))
    h.close()


def test_short_read_is_an_error(tmp_path):
    h = AsyncIOHandle()
    path = str(tmp_path / "small.bin")
    h.pwrite(path, torch.arange(16, dtype=torch.float32))
    with pytest.raises(OSError):
        h.pread(path, torch.empty(64))
    h.close()


@pytest.mark.parametrize("buf", ["view", "strided_numpy", "list"])
def test_noncontiguous_or_foreign_buffer_rejected(tmp_path, buf):
    h = AsyncIOHandle()
    arr = {"view": torch.zeros(8, 8)[:, ::2], "strided_numpy": np.zeros((8, 8), np.float32)[:, ::2],
           "list": [0.0] * 4}[buf]
    with pytest.raises(ValueError):
        h.pwrite(str(tmp_path / "x.bin"), arr)
    h.close()


def test_read_error_raises(tmp_path):
    h = AsyncIOHandle()
    with pytest.raises(OSError):
        h.pread(str(tmp_path / "missing.bin"), torch.empty(16))
    h.close()


def test_tensor_swapper_reclaims_stale_runs(tmp_path):
    base = tmp_path / "swap"
    base.mkdir()
    dead = subprocess.Popen(["true"])
    dead.wait()
    stale = base / f"run-{dead.pid}-deadbeef"
    stale.mkdir()
    (stale / "swap000000.bin").write_bytes(b"x" * 64)
    live = base / f"run-{os.getpid()}-cafecafe"
    live.mkdir()
    (live / "swap000000.bin").write_bytes(b"y" * 64)
    sw = TensorSwapper(str(base))
    assert not stale.exists() and live.exists()
    sw.close()


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"m": {"w": rng.normal(size=(64, 32)).astype(np.float32)},
            "v": {"w": rng.normal(size=(64, 32)).astype(np.float32)},
            "step": np.asarray(7, np.int32)}


@pytest.mark.parametrize("async_op", [False, True])
def test_tensor_swapper_roundtrip_and_the_jax_file(tmp_path, async_op, monkeypatch):
    """A swap file is byte for byte the JAX swapper's; each reads the other's."""
    monkeypatch.setattr(swap_tensor, "PIECE_BYTES", 1000)  # leaves split over the threads
    tree = _tree()
    sw = TensorSwapper(str(tmp_path / "swap"))
    man = sw.swap_out(tree, async_op=async_op)
    sw.synchronize()
    back = sw.swap_in(man)
    np.testing.assert_array_equal(back["m"]["w"].numpy(), tree["m"]["w"])
    assert int(back["step"]) == 7 and back["step"].dtype == torch.int32
    js = JSwapper(str(tmp_path / "jswap"))
    jman = js.swap_out(tree)
    with open(man["path"], "rb") as a, open(jman["path"], "rb") as b:
        assert a.read() == b.read()
    assert man["entries"] == jman["entries"]
    port_reads_jax = sw.swap_in({**man, "path": jman["path"]})
    np.testing.assert_array_equal(port_reads_jax["v"]["w"].numpy(), tree["v"]["w"])
    jax_reads_port = js.swap_in({**jman, "path": man["path"]})
    np.testing.assert_array_equal(jax_reads_port["m"]["w"], tree["m"]["w"])
    sw.release(man)
    assert not os.path.exists(man["path"])
    sw.close()
    js.close()


def test_swap_in_into_given_buffers_checks_them(tmp_path):
    sw = TensorSwapper(str(tmp_path / "swap"))
    man = sw.swap_out({"a": torch.arange(10.0)})
    out = {"a": torch.empty(10)}
    assert sw.swap_in(man, out=out) is out and torch.equal(out["a"], torch.arange(10.0))
    with pytest.raises(ValueError):
        sw.swap_in(man, out={"a": torch.empty(10, dtype=torch.float64)})
    sw.close()


# -- the NVMe-tiered optimizer (tests/test_nvme_optimizer.py) ------------------

def _params(rng):
    return {"a": rng.standard_normal((8, 16)).astype(np.float32), "b": rng.standard_normal((4,)).astype(np.float32),
            "c": rng.standard_normal((3000,)).astype(np.float32)}


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_nvme_optimizer_equals_the_jax_tier_bitwise(tmp_path, adam_w_mode):
    rng = np.random.default_rng(0)
    params = _params(rng)
    kw = dict(lr=1e-2, weight_decay=0.01, adam_w_mode=adam_w_mode, sub_group_bytes=300)
    j = JNvme(dict(params), swap_dir=str(tmp_path / "j"), **kw)
    t = NvmeTieredOptimizer(dict(params), swap_dir=str(tmp_path / "t"), **kw)
    assert t.groups == j.groups and t.num_groups >= 2
    for step in range(1, 4):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        a, b = j.step(grads, lr=1e-2 * step), t.step(grads, lr=1e-2 * step)
        for k in params:
            np.testing.assert_array_equal(b[k].numpy(), a[k])
    assert glob.glob(os.path.join(str(tmp_path / "t"), "run-*", "swap*.bin"))
    assert t.state_bytes() == 12 * sum(v.size for v in params.values())
    j.close()
    t.close()


def test_nvme_optimizer_writes_into_given_tensors(tmp_path):
    rng = np.random.default_rng(1)
    params = _params(rng)
    t = NvmeTieredOptimizer(dict(params), swap_dir=str(tmp_path), sub_group_bytes=300)
    ref = NvmeTieredOptimizer(dict(params), swap_dir=str(tmp_path), sub_group_bytes=300)
    out = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in params.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)) for k, v in params.items()}
    assert t.step(grads, out=out) is out
    want = ref.step(grads)
    for k in params:
        assert torch.equal(out[k], want[k].to(torch.bfloat16))
    t.close()
    ref.close()


def test_nvme_optimizer_skip_leaves_states(tmp_path):
    params = {"w": np.ones((4, 4), np.float32)}
    opt = NvmeTieredOptimizer(dict(params), lr=0.1, swap_dir=str(tmp_path))
    read = opt.swapper.bytes_read
    assert opt.step({"w": np.ones((4, 4), np.float32)}, skip=True) is None
    assert opt.step_count == 0 and opt.swapper.bytes_read == read  # no disk I/O
    out2 = opt.step({"w": np.zeros((4, 4), np.float32)})
    np.testing.assert_allclose(out2["w"].numpy(), params["w"])
    opt.close()


def test_nvme_tier_save_load_state_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((8, 8)).astype(np.float32)}
    g = {"w": rng.standard_normal((8, 8)).astype(np.float32)}
    a = NvmeTieredOptimizer(dict(p), lr=1e-2, swap_dir=str(tmp_path / "a"))
    for _ in range(3):
        a.step(g)
    a.save_state(str(tmp_path / "state"))
    b = NvmeTieredOptimizer(dict(p), lr=1e-2, swap_dir=str(tmp_path / "b"))
    assert b.load_state(str(tmp_path / "state"))
    assert b.step_count == a.step_count == 3
    assert torch.equal(a.step(g)["w"], b.step(g)["w"])
    c = NvmeTieredOptimizer(dict(p), lr=1e-2, swap_dir=str(tmp_path / "c"))
    assert not c.load_state(str(tmp_path / "nope"))
    for o in (a, b, c):
        o.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_saved_tier_state_crosses_both_ways(tmp_path, direction):
    """save_state's npz members (names, order, bytes) equal JAX's, and a
    saved tier continues bitwise in the other package."""
    rng = np.random.default_rng(2)
    params = _params(rng)
    g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    kw = dict(lr=1e-2, weight_decay=0.1, sub_group_bytes=300)
    j = JNvme(dict(params), swap_dir=str(tmp_path / "j"), **kw)
    t = NvmeTieredOptimizer(dict(params), swap_dir=str(tmp_path / "t"), **kw)
    for _ in range(2):
        j.step(g)
        t.step(g)
    j.save_state(str(tmp_path / "js"))
    t.save_state(str(tmp_path / "ts"))
    for gi in range(t.num_groups):
        with np.load(tmp_path / "js" / f"group{gi:04d}.npz") as a, np.load(tmp_path / "ts" / f"group{gi:04d}.npz") as b:
            assert a.files == b.files
            for f in a.files[1:]:  # after the generation stamp
                assert a[f].tobytes() == b[f].tobytes()
    if direction == "jax_to_port":
        fresh = NvmeTieredOptimizer(dict(params), swap_dir=str(tmp_path / "f"), **kw)
        assert fresh.load_state(str(tmp_path / "js"))
        np.testing.assert_array_equal(fresh.step(g)["c"].numpy(), j.step(g)["c"])
    else:
        fresh = JNvme(dict(params), swap_dir=str(tmp_path / "f"), **kw)
        assert fresh.load_state(str(tmp_path / "ts"))
        np.testing.assert_array_equal(t.step(g)["c"].numpy(), fresh.step(g)["c"])
    for o in (j, t, fresh):
        o.close()


def test_nvme_tier_rejects_partial_or_corrupt_state(tmp_path):
    rng = np.random.default_rng(2)
    p = {"w1": rng.standard_normal((64,)).astype(np.float32), "w2": rng.standard_normal((64,)).astype(np.float32)}
    g = {k: np.ones_like(v) for k, v in p.items()}
    a = NvmeTieredOptimizer(dict(p), lr=1e-2, swap_dir=str(tmp_path / "a"), sub_group_bytes=64 * 4)
    assert a.num_groups == 2
    a.step(g)
    a.save_state(str(tmp_path / "s1"))
    a.step(g)
    a.save_state(str(tmp_path / "s2"))
    mixed = tmp_path / "mixed"
    shutil.copytree(str(tmp_path / "s2"), str(mixed))
    shutil.copyfile(str(tmp_path / "s1" / "group0001.npz"), str(mixed / "group0001.npz"))
    b = NvmeTieredOptimizer(dict(p), lr=1e-2, swap_dir=str(tmp_path / "b"), sub_group_bytes=64 * 4)
    manifests = list(b.manifests)
    assert not b.load_state(str(mixed))
    assert b.step_count == 0 and b.manifests == manifests  # untouched
    trunc = tmp_path / "trunc"
    shutil.copytree(str(tmp_path / "s2"), str(trunc))
    with open(trunc / "group0000.npz", "r+b") as f:
        f.truncate(40)
    assert not b.load_state(str(trunc))
    assert np.all(np.isfinite(b.step(g)["w1"].numpy()))
    a.close()
    b.close()


def test_nvme_adam_vs_adamw_decay_semantics(tmp_path):
    p = {"w": np.ones((4,), np.float32)}
    g = {"w": np.zeros((4,), np.float32)}
    adamw = NvmeTieredOptimizer(dict(p), lr=0.1, weight_decay=0.5, adam_w_mode=True, swap_dir=str(tmp_path / "a"))
    adam = NvmeTieredOptimizer(dict(p), lr=0.1, weight_decay=0.5, adam_w_mode=False, swap_dir=str(tmp_path / "b"))
    assert not torch.allclose(adamw.step(g)["w"], adam.step(g)["w"])
    adamw.close()
    adam.close()


# -- the engines ----------------------------------------------------------------

MODEL = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=2, hidden_size=32, loss_chunk_size=0)


def _cfg(nvme_path, off_param=False):
    z = {"stage": 1, "offload_optimizer": {"device": "nvme", "nvme_path": str(nvme_path)}, "sub_group_size": 20_000}
    if off_param:
        z["offload_param"] = {"device": "nvme", "nvme_path": str(nvme_path)}
    return {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}, "zero_optimization": z,
            "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 10**9}


def _batch():
    return {"tokens": np.random.default_rng(0).integers(0, 128, size=(8, 33)).astype(np.int32)}


def _jax_engine(cfg):
    return deepspeed_tpu.initialize(model=jtfm.Model(jtfm.TransformerConfig(dtype=jnp.bfloat16, **MODEL)), config=cfg,
                                    mesh=single_device_mesh())[0]


def _port_engine(cfg, params):
    return deepspeed_tpu_torch.initialize(model=ttfm.Model(ttfm.TransformerConfig(dtype=torch.bfloat16, **MODEL)),
                                          config=cfg, model_parameters=params, device="cpu")[0]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX NVMe engine and the port's (with and without the parameter
    tier) from the same weights, 3 steps each; closed at the end."""
    root = tmp_path_factory.mktemp("nvme_engines")
    je = _jax_engine(_cfg(root / "j"))
    init = interop.params_from_jax(jax.tree.map(np.asarray, _jax_engine_params()))
    out = {"root": root, "jax": (je, [float(je.train_batch(_batch())["loss"]) for _ in range(3)])}
    for name, off_param in (("port", False), ("port_param", True)):
        e = _port_engine(_cfg(root / name, off_param), {k: v for k, v in init.items()})
        out[name] = (e, [float(e.train_batch(_batch())["loss"]) for _ in range(3)])
    yield out
    je.nvme_opt.close()
    out["port"][0].close()
    out["port_param"][0].close()


def _jax_engine_params():
    plain = {**_cfg("unused"), "zero_optimization": {"stage": 1}}
    return _jax_engine(plain).state["params"]


def test_engine_nvme_offload_trains_like_jax(engines):
    """grads-only step + host Adam over swapped groups: the port's losses
    track the JAX NVMe engine's; nothing of the optimizer is on the device;
    the parameter tier over it is the same arithmetic."""
    je, jl = engines["jax"]
    te, tl = engines["port"]
    _, pl = engines["port_param"]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert pl == tl and tl[-1] < tl[0]
    assert te.state["opt"] == {} and "master" not in te.state
    assert te.tier.nvme.num_groups == je.nvme_opt.num_groups and te.tier.nvme.groups == je.nvme_opt.groups
    assert te.tier.nvme.step_count == 3
    assert glob.glob(os.path.join(str(engines["root"] / "port"), "run-*", "swap*.bin"))


def test_engine_nvme_checkpoint_crosses_both_ways(engines, tmp_path):
    """The JAX engine's checkpoint (with its nvme_optimizer/ directory) into
    a fresh port engine, and the port's into a fresh JAX engine: each
    continues as the engine that saved it does."""
    je, _ = engines["jax"]
    te, _ = engines["port"]
    je.save_checkpoint(str(tmp_path / "j"), tag="t")
    te.save_checkpoint(str(tmp_path / "p"), tag="t")
    assert os.path.exists(tmp_path / "p" / "t" / "nvme_optimizer" / "meta.json")
    fresh = _port_engine(_cfg(tmp_path / "fs"), None)
    fresh.load_checkpoint(str(tmp_path / "j"))
    assert fresh.tier.nvme.step_count == je.nvme_opt.step_count == 3
    np.testing.assert_allclose(float(fresh.train_batch(_batch())["loss"]), float(je.train_batch(_batch())["loss"]),
                               rtol=1e-4)
    jfresh = _jax_engine(_cfg(tmp_path / "jf"))
    jfresh.load_checkpoint(str(tmp_path / "p"))
    assert jfresh.nvme_opt.step_count == 3
    np.testing.assert_allclose(float(jfresh.train_batch(_batch())["loss"]), float(te.train_batch(_batch())["loss"]),
                               rtol=1e-4)
    fresh.close()
    jfresh.nvme_opt.close()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.text = ""

    def emit(self, record):
        self.text += record.getMessage() + "\n"


def test_engine_nvme_resume_is_bitwise_and_a_missing_tier_rewarms(engines, tmp_path):
    _, tl = engines["port"]
    init = interop.params_from_jax(jax.tree.map(np.asarray, _jax_engine_params()))
    a = _port_engine(_cfg(tmp_path / "a"), init)
    for _ in range(2):
        a.train_batch(_batch())
    a.save_checkpoint(str(tmp_path / "ck"), tag="t")
    want = float(a.train_batch(_batch())["loss"])
    b = _port_engine(_cfg(tmp_path / "b"), None)
    b.load_checkpoint(str(tmp_path / "ck"))
    assert float(b.train_batch(_batch())["loss"]) == want
    shutil.rmtree(tmp_path / "ck" / "t" / "nvme_optimizer")
    c = _port_engine(_cfg(tmp_path / "c"), None)
    records = _Records()
    port_logger.addHandler(records)
    try:
        c.load_checkpoint(str(tmp_path / "ck"))
    finally:
        port_logger.removeHandler(records)
    assert "no nvme_optimizer state" in records.text
    assert c.tier.nvme.step_count == 0  # the bias-correction clock re-warms
    assert np.isfinite(float(c.train_batch(_batch())["loss"]))
    for e in (a, b, c):
        e.close()


def test_flatten_orders_keys_as_jax():
    tree = {"b": {"y": 1, "x": 2}, "a": 3}
    assert [p for p, _ in flatten(tree)] == [p for p, _ in
                                              [(tuple(k.key for k in path), v) for path, v in
                                               jax.tree_util.tree_flatten_with_path(tree)[0]]]
