"""Port parity: the training engine's elastic contract against the JAX
engine's, and the launcher's world.

``_enforce_elasticity`` at world 1: with ``ignore_non_elastic_batch_info``
the elastic solution replaces the configured batch sizes as in the JAX
engine; without it a mismatch raises JAX's ``ElasticityError`` message.
``save_checkpoint`` records ``dp_world`` in the client state, and a
checkpoint saved at another data-parallel world (the JAX engine's over the
8-device CPU mesh) counts one ``resilience/topology_changes`` on load, as
the JAX engine counts one loading the port's. A launcher world above 1
(``WORLD_SIZE`` or ``DSTPU_NUM_PROCESSES``) is refused by ``initialize``
and ``init_inference``, naming data parallelism over ``torch.distributed``.
"""

import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import MeshConfig, build_mesh, single_device_mesh
from deepspeed_tpu.elasticity import ElasticityError as JaxElasticityError
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.elasticity import ElasticityError
from deepspeed_tpu_torch.models import transformer as ttfm
from simple_model import base_config, tiny_transformer

TCFG = dict(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64)
TOKENS = np.random.default_rng(0).integers(0, 128, size=(8, 33)).astype(np.int32)


def _engines(ds, mesh=None):
    jeng = deepspeed_tpu.initialize(model=tiny_transformer(), config=ds, mesh=mesh or single_device_mesh())[0]
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.state["params"]))
    teng = deepspeed_tpu_torch.initialize(model=ttfm.Model(ttfm.TransformerConfig(**TCFG)), config=ds,
                                          model_parameters=params, device="cpu")[0]
    return jeng, teng


def _sizes(eng):
    c = eng.config
    return (eng.train_batch_size, eng.micro_batch_size, eng.gradient_accumulation_steps,
            c.train_batch_size, c.train_micro_batch_size_per_gpu, c.gradient_accumulation_steps)


ELASTIC = [
    {"max_train_batch_size": 8, "micro_batch_sizes": [2, 4]},
    {"max_train_batch_size": 16, "micro_batch_sizes": [1, 2, 4], "max_gpus": 8},
    {"max_train_batch_size": 12, "micro_batch_sizes": [3], "version": 0.2, "max_gpus": 4},
]


@pytest.mark.parametrize("case", range(len(ELASTIC)))
def test_elastic_solution_replaces_batch_sizes_as_jax(case):
    block = {"enabled": True, "ignore_non_elastic_batch_info": True, **ELASTIC[case]}
    ds = base_config(train_batch_size=2, train_micro_batch_size_per_gpu=1, gradient_accumulation_steps=2,
                     elasticity=block)
    jeng, teng = _engines(ds)
    assert jeng.dp_world == teng.dp_world == 1
    assert _sizes(teng) == _sizes(jeng)
    assert _sizes(teng) != (2, 1, 2, 2, 1, 2)  # the solution, not the configured sizes
    batch = {"tokens": TOKENS[:teng.train_batch_size] if teng.train_batch_size <= 8
             else np.concatenate([TOKENS, TOKENS])[:teng.train_batch_size]}
    jm, tm = jax.device_get(jeng.train_batch(batch)), teng.train_batch(batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)


def test_elastic_mismatch_raises_jax_error():
    block = {"enabled": True, "max_train_batch_size": 8, "micro_batch_sizes": [2, 4]}
    ds = base_config(train_batch_size=4, train_micro_batch_size_per_gpu=2, gradient_accumulation_steps=2,
                     elasticity=block)
    with pytest.raises(JaxElasticityError) as want:
        deepspeed_tpu.initialize(model=tiny_transformer(), config=ds, mesh=single_device_mesh())
    with pytest.raises(ElasticityError) as got:
        deepspeed_tpu_torch.initialize(model=ttfm.Model(ttfm.TransformerConfig(**TCFG)), config=ds, device="cpu")
    assert str(got.value) == str(want.value)
    assert "requires train_batch_size=8 at world size 1" in str(got.value)
    # the solution itself is accepted as configured
    ok = base_config(train_batch_size=8, train_micro_batch_size_per_gpu=4, gradient_accumulation_steps=2,
                     elasticity=block)
    jeng, teng = _engines(ok)
    assert _sizes(teng) == _sizes(jeng) == (8, 4, 2, 8, 4, 2)
    disabled = base_config(train_batch_size=2, train_micro_batch_size_per_gpu=1, gradient_accumulation_steps=2,
                           elasticity=dict(block, enabled=False))
    assert _sizes(_engines(disabled)[1]) == (2, 1, 2, 2, 1, 2)


DS = base_config(train_batch_size=8, train_micro_batch_size_per_gpu=8, gradient_accumulation_steps=1,
                 optimizer={"type": "AdamW", "params": {"lr": 1e-3}})
DS8 = dict(DS, train_micro_batch_size_per_gpu=1)  # the same batch over the 8-device mesh


def _counter(eng, name):
    return eng.telemetry.registry.snapshot()["counters"].get(name, 0)


def test_dp_world_rides_the_client_state_and_topology_changes_count(tmp_path):
    jeng = deepspeed_tpu.initialize(model=tiny_transformer(), config=DS8, mesh=build_mesh(MeshConfig(data=8)))[0]
    teng = deepspeed_tpu_torch.initialize(model=ttfm.Model(ttfm.TransformerConfig(**TCFG)), config=DS,
                                          device="cpu")[0]
    assert (jeng.dp_world, teng.dp_world) == (8, 1)
    jeng.train_batch({"tokens": TOKENS})
    teng.train_batch({"tokens": TOKENS})
    jeng.save_checkpoint(str(tmp_path / "jax"))
    teng.save_checkpoint(str(tmp_path / "port"))

    fresh = deepspeed_tpu_torch.initialize(model=ttfm.Model(ttfm.TransformerConfig(**TCFG)), config=DS,
                                           device="cpu")[0]
    _, own = fresh.load_checkpoint(str(tmp_path / "port"))
    assert own["dp_world"] == 1 and _counter(fresh, "resilience/topology_changes") == 0
    _, theirs = fresh.load_checkpoint(str(tmp_path / "jax"))
    assert theirs["dp_world"] == 8 and _counter(fresh, "resilience/topology_changes") == 1

    jfresh = deepspeed_tpu.initialize(model=tiny_transformer(), config=DS8,
                                      mesh=build_mesh(MeshConfig(data=8)))[0]
    jfresh.load_checkpoint(str(tmp_path / "port"))
    assert _counter(jfresh, "resilience/topology_changes") == 1  # the JAX engine counts the port's the same way
    assert set(own) >= {"global_steps", "global_samples", "skipped_steps", "rng_seed", "dp_world",
                        "micro_batch_size", "train_batch_size"}


_PARTNER = """
import sys
import numpy as np
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as ttfm
eng = deepspeed_tpu_torch.initialize(model=ttfm.Model(ttfm.TransformerConfig(**{tcfg!r})), config={ds!r},
                                     device="cpu")[0]
loss = float(eng.train_batch({{"tokens": np.asarray({tokens!r}, dtype=np.int32)}})["loss"])
print("LOSS", repr(loss), eng.dp_world, eng.dp_rank)
from deepspeed_tpu_torch import comm
comm.destroy_distributed()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("var", ["WORLD_SIZE", "DSTPU_NUM_PROCESSES"])
def test_launcher_world_above_one_is_refused(monkeypatch, var):
    """``initialize`` takes the launcher's world: under either spelling of
    the launcher's variables (torch's env:// ones, or the ``DSTPU_*`` ones
    launcher/launch.py also sets) two processes rendezvous, train one
    data-parallel step and agree on its loss. ``init_inference`` still
    refuses such a world, naming tensor-parallel serving."""
    import subprocess
    import sys

    from deepspeed_tpu_torch import comm

    model = ttfm.Model(ttfm.TransformerConfig(**TCFG))
    monkeypatch.setenv(var, "1")
    deepspeed_tpu_torch.initialize(model=model, config=DS, device="cpu")
    port = _free_port()
    rank_var, addr = (("RANK", {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}) if var == "WORLD_SIZE"
                      else ("DSTPU_PROCESS_ID", {"DSTPU_COORDINATOR": f"127.0.0.1:{port}"}))
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "DSTPU_NUM_PROCESSES", "RANK",
                                                                "DSTPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT")}
    env.update({var: "2", rank_var: "1", "PYTHONPATH": os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                **addr})
    ds2 = dict(DS, train_micro_batch_size_per_gpu=4)  # the same global batch over 2 ranks
    partner = subprocess.Popen([sys.executable, "-c", _PARTNER.format(tcfg=TCFG, ds=ds2, tokens=TOKENS.tolist())],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        monkeypatch.setenv(var, "2")
        monkeypatch.setenv(rank_var, "0")
        for k, v in addr.items():
            monkeypatch.setenv(k, v)
        eng = deepspeed_tpu_torch.initialize(model=model, config=ds2, device="cpu")[0]
        assert (eng.dp_world, eng.dp_rank, eng.mesh.shape["data"]) == (2, 0, 2)
        loss = float(eng.train_batch({"tokens": TOKENS})["loss"])
        out = partner.communicate(timeout=120)[0]
    finally:
        comm.destroy_distributed()
        if partner.poll() is None:
            partner.kill()
            partner.wait()
    assert partner.returncode == 0, out[-3000:]
    got = next(line for line in out.splitlines() if line.startswith("LOSS")).split()
    assert float(got[1]) == loss and got[2:] == ["2", "1"]
    with pytest.raises(NotImplementedError, match=f"{var}=2.*tensor-parallel serving"):
        deepspeed_tpu_torch.init_inference(model, config={"dtype": "fp32"}, device="cpu")
