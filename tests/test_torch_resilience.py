"""Port parity: training resilience (the fault injector's training sites,
retry, the NaN guardrail, preemption, checkpoint write faults).

The JAX engines (three, module-scoped) and the port's start from the same
weights (``interop.params_from_jax``) and see the same numpy batches, fp32
on the CPU. A skipped step changes nothing on the device in either package,
so the faulted runs are held against each other to the training tests'
1e-6 and against their own clean runs bitwise.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import single_device_mesh
from deepspeed_tpu.models import transformer as jtfm
from deepspeed_tpu.resilience import errors as jerrors
from deepspeed_tpu.resilience import faults as jfaults
from deepspeed_tpu.resilience import retry as jretry
from deepspeed_tpu_torch import interop
from deepspeed_tpu_torch.models import transformer as ttfm
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.resilience import (PermanentIOError, PreemptionGuard, PreemptionSignal,
                                            TrainingDivergedError, TransientIOError, clear_injector)
from deepspeed_tpu_torch.resilience import faults as tfaults
from deepspeed_tpu_torch.resilience import preemption as tpre
from deepspeed_tpu_torch.resilience import retry as tretry
from deepspeed_tpu_torch.runtime import engine as tengine

MODEL = dict(vocab_size=97, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=32, loss_chunk_size=0)
# SGD with momentum: a skipped step must leave the momentum untouched too, and
# every parameter's update is proportional to its gradient, so the packages
# agree to 1e-6 (Adam turns the key bias's zero-in-exact-arithmetic gradient
# into lr-sized steps of rounding noise; tests/test_torch_training.py)
DS = {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
      "optimizer": {"type": "SGD", "params": {"lr": 0.05, "momentum": 0.9}}, "gradient_clipping": 1.0,
      "steps_per_print": 10**9}


@pytest.fixture(autouse=True)
def _clear_global_injector():
    """An engine with fault injection installs the process-global injector
    the saver consults: never leak it into later tests."""
    yield
    clear_injector()


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 97, size=(4, 33)).astype(np.int32)} for _ in range(n)]


@pytest.fixture(scope="module")
def init_params():
    return jax.tree.map(np.asarray, jtfm.init(jtfm.TransformerConfig(**MODEL, dtype=jnp.float32),
                                              jax.random.PRNGKey(0)))


def _jax_engine(params, resilience=None):
    ds = dict(DS, resilience=resilience) if resilience else DS
    eng, _, _, _ = deepspeed_tpu.initialize(model=jtfm.Model(jtfm.TransformerConfig(**MODEL, dtype=jnp.float32)),
                                            config=ds, mesh=single_device_mesh(),
                                            model_parameters=jax.tree.map(jnp.asarray, params))
    return eng


def _port_engine(params, resilience=None, ckpt=None, **model_kw):
    ds = dict(DS)
    if resilience:
        ds["resilience"] = resilience
    if ckpt:
        ds["checkpoint"] = ckpt
    model = ttfm.Model(ttfm.TransformerConfig(**MODEL, **model_kw))
    return tengine.DeepSpeedEngine(model, ds, params=interop.params_from_jax(params), device="cpu")


def _names(tree, prefix=""):
    """Leaf paths of a nested dict in jax.tree.leaves order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _jparams(eng):
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(eng.state["params"]))]


def _tparams(eng):
    return [t.numpy().copy() for t in tree_leaves(eng.state["params"])]


PARAM_NAMES = _names(ttfm.init(ttfm.TransformerConfig(**MODEL), torch.Generator().manual_seed(0)))


def _counters(eng):
    return eng.telemetry.registry.snapshot()["counters"]


# ---------------------------------------------------------------------------
# The injector and retry: the same decisions and delays as the JAX modules
# ---------------------------------------------------------------------------

INJECTOR_CONFIGS = {
    "lists": {"enabled": True, "nan_grad_steps": [3, 5], "preempt_steps": [2], "io_error_writes": [4],
              "io_flaky_writes": [2, 7]},
    "rate": {"enabled": True, "seed": 11, "rate": 0.3},
    "rate_sites": {"enabled": True, "seed": 5, "rate": 0.5, "sites": ["io_flaky", "preempt"],
                   "nan_grad_steps": [1]},
    "off": {"enabled": False, "nan_grad_steps": [1], "io_error_writes": [1]},
}


def _drive(inj):
    out = []
    for step in range(1, 13):
        out.append(("preempt", step, inj.preempt(step)))
        out.append(("nan", step, inj.nan_grads(step)))
        out.append(("nan_replay", step, inj.nan_grads(step)))  # a rewound step is not re-faulted
        try:
            inj.io_error(f"/w{step}")
            out.append(("io", step, None))
        except OSError as e:
            out.append(("io", step, type(e).__name__))
    return out, inj.stats()


@pytest.mark.parametrize("name", list(INJECTOR_CONFIGS))
def test_injector_training_decisions_match_jax(name):
    cfg = INJECTOR_CONFIGS[name]
    jdec, jstats = _drive(jfaults.FaultInjector(cfg))
    tdec, tstats = _drive(tfaults.FaultInjector(cfg))
    assert tdec == jdec
    assert tstats["injected"] == jstats["injected"] and tstats["opportunities"] == jstats["opportunities"]
    assert tstats["guarded_writes"] == jstats["guarded_writes"]


def test_injector_error_types_and_global_slot():
    inj = tfaults.FaultInjector({"enabled": True, "io_flaky_writes": [2], "io_error_writes": [3]})
    inj.io_error("/w1")
    with pytest.raises(TransientIOError, match="io_flaky"):
        inj.io_error("/w2")
    with pytest.raises(PermanentIOError, match="io_error"):
        inj.io_error("/w3")
    tfaults.install_injector(inj)
    assert tfaults.get_injector() is inj
    tfaults.maybe_io_error("/w4")  # the fourth write is clean
    assert inj.stats()["guarded_writes"] == 4
    tfaults.clear_injector()
    tfaults.maybe_io_error("/w5")
    assert tfaults.get_injector() is None and inj.stats()["guarded_writes"] == 4


RETRY_POLICIES = {
    "default": {},
    "no_jitter": {"jitter": 0.0, "base_delay_s": 0.1},
    "capped": {"max_attempts": 6, "base_delay_s": 1.0, "max_delay_s": 3.0, "jitter": 1.0},
}


@pytest.mark.parametrize("name", list(RETRY_POLICIES))
def test_retry_delays_match_jax(name):
    kw = RETRY_POLICIES[name]
    jp, tp = jretry.RetryPolicy(**kw), tretry.RetryPolicy(**kw)
    for seed in (0, 1, 17):
        assert ([tretry.backoff_delay(a, tp, seed) for a in range(1, 9)]
                == [jretry.backoff_delay(a, jp, seed) for a in range(1, 9)])

    def run(mod, policy):
        slept, calls = [], []

        def flaky():
            calls.append(1)
            raise OSError("transient")

        with pytest.raises(OSError):
            mod.retry_call(flaky, policy=policy, seed=3, sleep=slept.append)
        return slept, len(calls)

    assert run(tretry, tp) == run(jretry, jp)
    # a permanent error is not retried; a success after failures returns
    n = []
    with pytest.raises(PermanentIOError):
        tretry.retry_call(lambda: n.append(1) or (_ for _ in ()).throw(PermanentIOError("x")), policy=tp,
                          no_retry_on=(PermanentIOError,), sleep=lambda d: None)
    assert len(n) == 1
    left = [OSError("a"), OSError("b")]
    got = tretry.retry_call(lambda: (_ for _ in ()).throw(left.pop()) if left else "ok",
                            policy=tretry.RetryPolicy(max_attempts=3), sleep=lambda d: None)
    assert got == "ok"


# ---------------------------------------------------------------------------
# The guardrail against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(init_params, tmp_path_factory):
    """The JAX engine's clean run, its skip-then-diverge run and its rewind
    run (the module's three JAX engines), recorded as numpy."""
    bs = _batches(6)
    out = {}
    clean = _jax_engine(init_params)
    for b in bs[:4]:
        clean.train_batch(b)
    out["clean"] = _jparams(clean)

    faulted = _jax_engine(init_params, {"enabled": True, "max_consecutive_bad_steps": 2,
                                        "fault_injection": {"enabled": True, "nan_grad_steps": [3, 6, 7]}})
    for b in bs[:2] + [bs[5]] + bs[2:4]:  # the skipped step eats a sacrificial batch
        faulted.train_batch(b)
    out["skip"] = _jparams(faulted)
    out["skip_steps"] = (faulted.skipped_steps, faulted.get_global_step(), faulted.global_steps)
    faulted.train_batch(bs[4])  # step 6: bad, streak 1
    with pytest.raises(jerrors.TrainingDivergedError):
        faulted.train_batch(bs[4])  # step 7: streak 2 and no checkpoint to rewind to
    out["skip_counters"] = _counters(faulted)

    d = str(tmp_path_factory.mktemp("jax_rewind"))
    rew = _jax_engine(init_params, {"enabled": True, "max_consecutive_bad_steps": 2,
                                    "fault_injection": {"enabled": True, "nan_grad_steps": [3, 4]}})
    rew.train_batch(bs[0])
    rew.save_checkpoint(d, tag="g1")
    rew.train_batch(bs[1])
    rew.save_checkpoint(d, tag="g2")
    out["g2"] = _jparams(rew)
    rew.train_batch(bs[2])
    rew.train_batch(bs[3])  # streak 2: rewind to g2
    out["rewound"] = _jparams(rew)
    out["rewound_steps"] = (rew.global_steps, rew.get_global_step())
    rew.train_batch(bs[4])
    out["after_rewind"] = _jparams(rew)
    out["rewind_counters"] = _counters(rew)
    out["rewind_writes"] = rew.fault_injector.stats()["guarded_writes"]
    return out


def _close(port, ref):
    """Within 1e-6: fp32, summation order only."""
    assert len(port) == len(ref) == len(PARAM_NAMES)
    for name, a, b in zip(PARAM_NAMES, port, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)


RESILIENCE_COUNTERS = ("resilience/nan_skipped_steps", "resilience/recovered", "resilience/injected_nan_steps",
                       "resilience/rewinds", "resilience/diverged", "resilience/resumes")


def test_nan_skip_and_diverged_match_jax(init_params, jax_runs):
    """An injected non-finite step is skipped on the device: afterwards the
    run equals the clean run bitwise, and the JAX run to 1e-6. Two bad
    steps with no checkpoint raise TrainingDivergedError."""
    bs = _batches(6)
    clean = _port_engine(init_params)
    for b in bs[:4]:
        clean.train_batch(b)
    faulted = _port_engine(init_params, {"enabled": True, "max_consecutive_bad_steps": 2,
                                         "fault_injection": {"enabled": True, "nan_grad_steps": [3, 6, 7]}})
    for b in bs[:2] + [bs[5]] + bs[2:4]:
        faulted.train_batch(b)
    assert faulted.loss_scale == 1.0  # the injected +inf scale was restored
    for a, b in zip(_tparams(faulted), _tparams(clean)):
        np.testing.assert_array_equal(a, b)
    _close(_tparams(faulted), jax_runs["skip"])
    _close(_tparams(clean), jax_runs["clean"])
    assert (faulted.skipped_steps, faulted.get_global_step(), faulted.global_steps) == jax_runs["skip_steps"]
    faulted.train_batch(bs[4])
    with pytest.raises(TrainingDivergedError):
        faulted.train_batch(bs[4])
    port, ref = _counters(faulted), jax_runs["skip_counters"]
    assert {k: port.get(k) for k in RESILIENCE_COUNTERS} == {k: ref.get(k) for k in RESILIENCE_COUNTERS}
    assert port["resilience/nan_skipped_steps"] == 3 and port["resilience/diverged"] == 1


def test_rewind_after_consecutive_bad_steps_matches_jax(init_params, jax_runs, tmp_path):
    """Two bad steps in a row reload the last good checkpoint: the state is
    that checkpoint's bitwise, the host step goes back with it, training
    continues, and keep_last_k never prunes the rewind target."""
    bs = _batches(6)
    d = str(tmp_path)
    e = _port_engine(init_params, {"enabled": True, "max_consecutive_bad_steps": 2,
                                   "fault_injection": {"enabled": True, "nan_grad_steps": [3, 4]}},
                     ckpt={"keep_last_k": 1})
    e.train_batch(bs[0])
    e.save_checkpoint(d, tag="g1")
    e.train_batch(bs[1])
    e.save_checkpoint(d, tag="g2")
    g2 = _tparams(e)
    _close(g2, jax_runs["g2"])
    e.train_batch(bs[2])
    e.train_batch(bs[3])
    for a, b in zip(_tparams(e), g2):
        np.testing.assert_array_equal(a, b)
    assert (e.global_steps, e.get_global_step()) == jax_runs["rewound_steps"] == (2, 2)
    m = e.train_batch(bs[4])
    assert np.isfinite(float(m["loss"])) and e.global_steps == 3
    _close(_tparams(e), jax_runs["after_rewind"])
    port, ref = _counters(e), jax_runs["rewind_counters"]
    assert {k: port.get(k) for k in RESILIENCE_COUNTERS} == {k: ref.get(k) for k in RESILIENCE_COUNTERS}
    assert port["resilience/rewinds"] == 1
    # the same guarded writes: one per state leaf and the manifest, per save
    assert e.fault_injector.stats()["guarded_writes"] == jax_runs["rewind_writes"]
    assert not os.path.exists(os.path.join(d, "g1")) and os.path.exists(os.path.join(d, "g2"))


def test_skip_with_dropout_and_guardrail_equals_clean_run(init_params):
    """With dropout on, the masks follow the device step: after a skip the
    host knows of (injected, the guardrail armed), the faulted run draws the
    clean run's masks and ends bitwise equal to it."""
    bs = _batches(5)
    clean = _port_engine(init_params, {"enabled": True}, hidden_dropout=0.1, attn_dropout=0.1)
    for b in bs[:4]:
        clean.train_batch(b)
    faulted = _port_engine(init_params, {"enabled": True, "fault_injection": {"enabled": True,
                                                                            "nan_grad_steps": [2]}},
                           hidden_dropout=0.1, attn_dropout=0.1)
    for b in bs[:1] + [bs[4]] + bs[1:4]:
        faulted.train_batch(b)
    assert faulted.skipped_steps == 1 and faulted.get_global_step() == clean.get_global_step() == 4
    for a, b in zip(_tparams(faulted), _tparams(clean)):
        np.testing.assert_array_equal(a, b)


def test_unguarded_fp16_overflow_keeps_the_dropout_step(init_params):
    """The masks are keyed on the device step, as JAX folds its device
    step into the key: after an fp16 overflow that no guardrail fetched the
    device step stays at 0, so the next step draws the masks of a fresh
    engine's first step (the same parameters, so the same loss bitwise).
    With the guardrail armed likewise."""
    ds = dict(DS, fp16={"enabled": True, "initial_scale_power": 32})
    tokens, nxt = _batches(2)

    def engine(d):
        return tengine.DeepSpeedEngine(
            ttfm.Model(ttfm.TransformerConfig(**MODEL, hidden_dropout=0.1, dtype=torch.float16)), d,
            params=interop.params_from_jax(init_params_np()), device="cpu")

    fresh = float(engine(ds).train_batch(nxt)["loss"])
    for guarded in (False, True):
        eng = engine(dict(ds, resilience={"enabled": True}) if guarded else ds)
        m = eng.train_batch(tokens)
        assert bool(m["overflow"]) and eng.get_global_step() == 0 and eng.global_steps == 1
        assert not hasattr(eng, "_rng_step")
        assert float(eng.train_batch(nxt)["loss"]) == fresh


def test_resume_after_unguarded_fp16_overflow_is_bitwise(init_params, tmp_path):
    """fp16 with dropout and no guardrail: dynamic loss scaling overflows at
    steps 1 and 2, so the device step lags two steps behind the calls. The
    masks follow the device step, which the checkpoint carries, so train 3
    + save + load + train 2 equals train 5 bitwise."""
    ds = dict(DS, fp16={"enabled": True, "initial_scale_power": 20, "hysteresis": 1})
    bs = _batches(5)

    def engine():
        return tengine.DeepSpeedEngine(
            ttfm.Model(ttfm.TransformerConfig(**MODEL, hidden_dropout=0.1, attn_dropout=0.1, dtype=torch.float16)),
            ds, params=interop.params_from_jax(init_params), device="cpu")

    clean = engine()
    overflows = [bool(clean.train_batch(b)["overflow"]) for b in bs]
    assert overflows == [True, True, False, False, False]
    first = engine()
    for b in bs[:3]:
        first.train_batch(b)
    assert (first.global_steps, first.get_global_step()) == (3, 1)
    first.save_checkpoint(str(tmp_path))
    resumed = engine()
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.get_global_step() == 1
    for b in bs[3:]:
        resumed.train_batch(b)
    assert resumed.get_global_step() == clean.get_global_step() == 3
    for a, b in zip(_tparams(resumed), _tparams(clean)):
        np.testing.assert_array_equal(a, b)


def init_params_np():
    return jax.tree.map(np.asarray, jtfm.init(jtfm.TransformerConfig(**MODEL, dtype=jnp.float32),
                                              jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# Preemption
# ---------------------------------------------------------------------------

def test_injected_preemption_save_and_resume_is_bitwise(init_params, tmp_path):
    """Preempt before step 3 with a JIT checkpoint -> a fresh engine loads
    'latest' and trains on: the clean run's parameters bitwise, dropout on."""
    bs = _batches(4)
    kw = dict(hidden_dropout=0.1, attn_dropout=0.1)
    clean = _port_engine(init_params, **kw)
    for b in bs:
        clean.train_batch(b)
    d = str(tmp_path)
    e = _port_engine(init_params, {"preemption": {"save_dir": d},
                                   "fault_injection": {"enabled": True, "preempt_steps": [3]}}, **kw)
    e.train_batch(bs[0])
    e.train_batch(bs[1])
    with pytest.raises(PreemptionSignal):
        e.train_batch(bs[2])
    assert (tmp_path / "latest").read_text() == "preempt"
    assert _counters(e)["resilience/jit_checkpoints"] == 1 and _counters(e)["resilience/preemptions"] == 1
    restarted = _port_engine(init_params_np(), **kw)
    tag, _ = restarted.load_checkpoint(d)
    assert tag == "preempt" and restarted.global_steps == 2
    for b in bs[2:]:
        restarted.train_batch(b)
    for a, b in zip(_tparams(restarted), _tparams(clean)):
        np.testing.assert_array_equal(a, b)


def test_real_signal_preempts_at_the_next_step(init_params, tmp_path):
    """A real SIGUSR1 to this process sets the guard's flag; the next
    train_batch takes the JIT checkpoint and raises PreemptionSignal before
    it runs anything. A later engine without preemption evicts the guard
    once its owner is gone, restoring the handler."""
    prev = signal.getsignal(signal.SIGUSR1)
    d = str(tmp_path)
    e = _port_engine(init_params, {"preemption": {"enabled": True, "save_dir": d, "signals": ["SIGUSR1"],
                                                  "tag": "jit"}})
    e.train_batch(_batches(1)[0])
    assert e._preemption_guard.installed
    os.kill(os.getpid(), signal.SIGUSR1)
    assert e._preemption_guard.pending()
    with pytest.raises(PreemptionSignal):
        e.train_batch(_batches(1)[0])
    assert e.global_steps == 1 and (tmp_path / "latest").read_text() == "jit"
    assert not e._preemption_guard.pending()
    guard = e._preemption_guard
    del e
    import gc
    gc.collect()
    _port_engine(init_params)  # preemption off: reaps the orphaned guard
    assert not guard.installed and signal.getsignal(signal.SIGUSR1) is prev


def test_preemption_guard_signal_hook_and_handler_restore():
    g = PreemptionGuard(["SIGUSR1"])
    prev = signal.getsignal(signal.SIGUSR1)
    assert not g.pending()
    with g:
        assert g.installed
        os.kill(os.getpid(), signal.SIGUSR1)  # a real delivery, to this process
        assert g.pending() and g.signal_count == 1
        assert g.consume() and not g.pending()
        assert not g.consume()
        g.trigger()  # the test hook sets the same flag
        assert g.consume()
    assert signal.getsignal(signal.SIGUSR1) is prev


def test_process_guard_slot_evicts_predecessor():
    prev = signal.getsignal(signal.SIGUSR1)
    a = PreemptionGuard(["SIGUSR1"])
    assert tpre.activate_guard(a) and a.installed
    b = PreemptionGuard(["SIGUSR1"])
    assert tpre.activate_guard(b)
    assert not a.installed and b.installed
    os.kill(os.getpid(), signal.SIGUSR1)
    assert b.consume() and not a.pending()
    tpre.deactivate_guard()
    assert not b.installed and signal.getsignal(signal.SIGUSR1) is prev

    class _Owner:
        pass

    owner = _Owner()
    c = PreemptionGuard(["SIGUSR1"])
    tpre.activate_guard(c, owner=owner)
    tpre.reap_orphaned_guard()
    assert c.installed  # a live sibling's guard stays armed
    del owner
    tpre.reap_orphaned_guard()
    assert not c.installed and signal.getsignal(signal.SIGUSR1) is prev


def test_guard_off_the_main_thread_degrades_to_trigger():
    import threading

    got = {}

    def run():
        g = PreemptionGuard(["SIGUSR1"])
        got["live"] = g.install()
        g.trigger()
        got["pending"] = g.consume()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert got == {"live": False, "pending": True}


# ---------------------------------------------------------------------------
# Checkpoint write faults
# ---------------------------------------------------------------------------

def _writes_per_save(eng):
    return len(tree_leaves(eng.state)) + 1  # one file a leaf, then the manifest


def test_io_flaky_is_retried_and_io_error_is_permanent(init_params, tmp_path):
    """A transient write failure is retried (resilience.retry, counted in
    resilience/ckpt_retries) and the save lands whole; a permanent one
    raises PermanentIOError with nothing half-visible and 'latest' on the
    intact earlier tag."""
    d = str(tmp_path)
    e = _port_engine(init_params, {"enabled": True, "retry": {"base_delay_s": 0.0},
                                   "fault_injection": {"enabled": True}})
    w = _writes_per_save(e)
    e.fault_injector.io_flaky_writes = {3}
    e.fault_injector.io_error_writes = {w + w + 2}  # the second save's third write
    e.train_batch(_batches(1)[0])
    e.save_checkpoint(d, tag="t1")  # attempt 1 fails at write 3; attempt 2 writes w + 1 .. 2w
    assert _counters(e)["resilience/ckpt_retries"] == 1
    assert (tmp_path / "latest").read_text() == "t1"
    e.load_checkpoint(d, tag="t1")  # verified: every digest matches
    e.train_batch(_batches(2)[1])
    with pytest.raises(PermanentIOError):
        e.save_checkpoint(d, tag="t2")
    assert _counters(e)["resilience/ckpt_retries"] == 1  # a permanent error is not retried
    assert not (tmp_path / "t2").exists() and (tmp_path / "latest").read_text() == "t1"
    tag, _ = _port_engine(init_params_np()).load_checkpoint(d)
    assert tag == "t1"


def test_io_error_in_an_async_save_surfaces_at_commit(init_params, tmp_path):
    """An async save's writer thread fails: the error is raised by the
    commit that finishes the save, once, and 'latest' stays where it was."""
    d = str(tmp_path)
    e = _port_engine(init_params, {"fault_injection": {"enabled": True}}, ckpt={"async_save": True})
    e.save_checkpoint(d, tag="a1")
    e.checkpoint_engine.commit()
    e.fault_injector.io_error_writes = {_writes_per_save(e) + 2}
    e.train_batch(_batches(1)[0])
    e.save_checkpoint(d, tag="a2")  # returns after the snapshot
    with pytest.raises(PermanentIOError):
        e.checkpoint_engine.commit()
    e.checkpoint_engine.commit()  # raised once: the next commit is clean
    assert (tmp_path / "latest").read_text() == "a1" and not (tmp_path / "a2").exists()
    e.save_checkpoint(d, tag="a3")
    e.load_checkpoint(d)  # commits a3 first
    assert (tmp_path / "latest").read_text() == "a3"
