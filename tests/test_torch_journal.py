"""Port parity: the request journal and the Router's recovery from it.

The port's ``RequestJournal`` must write the JAX package's DSJR records
byte for byte (the same record sequence, on a fixed wall clock, gives the
same file), and each package must replay the other's journal to the same
state. Torn tails at every cut point, a mid-file bit flip, bad magic and
rotation replay as they do in JAX. A Router crashed by ``router_crash_at``
and rebuilt over the same journal recovers as the JAX Router does.
"""

import time

import jax
import numpy as np
import pytest

from deepspeed_tpu.inference import InferenceEngine as JaxInferenceEngine
from deepspeed_tpu.inference import Request as JaxRequest
from deepspeed_tpu.inference import Router as JaxRouter
from deepspeed_tpu.inference import ServingEngine as JaxServingEngine
from deepspeed_tpu.inference import journal as jjournal
from deepspeed_tpu.inference.serving import RequestResult as JaxResult
from deepspeed_tpu.resilience import ControlPlaneCrash as JaxCrash
from deepspeed_tpu.resilience import JournalCorruptError as JaxCorrupt
from deepspeed_tpu_torch import init_inference, interop
from deepspeed_tpu_torch.inference import Request, Router, ServingEngine
from deepspeed_tpu_torch.inference import journal as tjournal
from deepspeed_tpu_torch.inference.serving import RequestResult
from deepspeed_tpu_torch.models.transformer import Model, TransformerConfig
from deepspeed_tpu_torch.resilience import ControlPlaneCrash, JournalCorruptError
from simple_model import tiny_transformer

WALL = 1_700_000_000.25  # the epoch record's fixed wall clock
FIELDS = ("epoch_wall", "requests", "req_keys", "terminals", "idem", "records", "truncated_tail_bytes")
SIDES = {"jax": (jjournal, JaxRequest, JaxResult), "torch": (tjournal, Request, RequestResult)}


def _state(s):
    return {f: getattr(s, f) for f in FIELDS}


def _write(side, path, rotate=4096, keep=1024):
    """One record sequence: submits with and without keys, terminals, a
    cancel, a double terminal and an unknown uid's terminal (skipped)."""
    mod, Req, Res = SIDES[side]
    j = mod.RequestJournal(path, rotate_max_records=rotate, keep_terminals=keep)
    rng = np.random.default_rng(0)
    for uid in range(6):
        j.record_submit(Req(uid=uid, prompt=rng.integers(0, 97, size=3 + uid).astype(np.int32),
                            max_new_tokens=4 + uid, temperature=0.5 * (uid % 2), top_k=uid, top_p=0.9,
                            eos_token=7 if uid == 3 else None, arrival_time=0.125 * uid, deadline_s=2.0,
                            priority=uid % 3, tenant="t" if uid == 4 else ""),
                        key=f"key-{uid}" if uid % 2 == 0 else None)
    for uid in (0, 2, 2):
        j.record_terminal(uid, Res(uid=uid, tokens=np.arange(3, dtype=np.int32) + uid, prompt_len=3 + uid,
                                   arrival_time=0.125 * uid, admitted_time=0.5, first_token_time=0.75,
                                   finish_time=1.5, slot=uid % 2, prefix_hit_tokens=0, status="ok"))
    j.record_cancel(1)
    j.record_terminal(5, None, status="failed_replica")
    assert not j.record_terminal(99, None, status="ok")
    j.close()
    return j


@pytest.fixture
def fixed_wall(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL)


@pytest.mark.parametrize("rotate,keep", [(4096, 1024), (3, 2)], ids=["plain", "rotation"])
def test_journal_bytes_equal_jax(tmp_path, fixed_wall, rotate, keep):
    paths = {side: str(tmp_path / f"{side}.journal") for side in SIDES}
    journals = {side: _write(side, path, rotate, keep) for side, path in paths.items()}
    with open(paths["jax"], "rb") as f:
        jbytes = f.read()
    with open(paths["torch"], "rb") as f:
        assert f.read() == jbytes
    assert jbytes[:4] == b"DSJR"
    if rotate == 3:  # compactions ran, and kept the live requests
        assert journals["torch"]._records_since_compact < 11
        assert tjournal.replay(paths["torch"]).requests.keys() == {3, 4}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_journal_replays_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "j")
    j = _write(writer, path)
    mod = SIDES[reader][0]
    assert _state(mod.replay(path)) == _state(SIDES[writer][0].replay(path))
    # the reader's journal recovers over the file and continues it
    k = mod.RequestJournal(path)
    assert k.recovered and k.state.epoch_wall == j.state.epoch_wall
    assert set(k.state.requests) == {3, 4} and k.state.idem["key-4"] == 4
    k.close()


def test_torn_tail_at_every_cut_point_matches_jax(tmp_path):
    path = str(tmp_path / "j")
    _write("torch", path)
    with open(path, "rb") as f:
        data = f.read()
    cut_path = str(tmp_path / "cut")
    for cut in range(len(data) + 1):
        with open(cut_path, "wb") as f:
            f.write(data[:cut])
        t, j = tjournal.replay(cut_path), jjournal.replay(cut_path)
        assert _state(t) == _state(j), cut
    assert t.truncated_tail_bytes == 0 and t.records > 0


@pytest.mark.parametrize("damage", ["bit_flip", "bad_magic"])
def test_mid_file_corruption_is_typed_like_jax(tmp_path, damage):
    path = str(tmp_path / "j")
    _write("torch", path)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    # the second record: its header starts after the first record
    first = 12 + int.from_bytes(data[4:8], "big")
    if damage == "bit_flip":
        data[first + 20] ^= 0x01
    else:
        data[first:first + 4] = b"XXXX"
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(JaxCorrupt) as je:
        jjournal.replay(path)
    with pytest.raises(JournalCorruptError) as te:
        tjournal.replay(path)
    assert (te.value.offset, str(te.value)) == (je.value.offset, str(je.value))
    assert te.value.offset == first


def test_journal_append_fault_fails_closed_like_jax(tmp_path):
    """``io_error_journal_appends``: the armed append raises the typed
    fail-closed error, and so does every later one; the durable prefix
    replays the same in both packages."""
    from deepspeed_tpu.resilience import FaultInjector as JaxInjector
    from deepspeed_tpu.resilience import JournalUnavailableError as JaxUnavailable
    from deepspeed_tpu_torch.resilience import FaultInjector, JournalUnavailableError

    out = {}
    for side, inj, err in (("jax", JaxInjector, JaxUnavailable), ("torch", FaultInjector, JournalUnavailableError)):
        mod, Req, _ = SIDES[side]
        path = str(tmp_path / side)
        j = mod.RequestJournal(path, injector=inj({"enabled": True, "io_error_journal_appends": [2]}))
        j.record_submit(Req(uid=0, prompt=np.arange(3, dtype=np.int32)))
        for uid in (1, 2):
            with pytest.raises(err):
                j.record_submit(Req(uid=uid, prompt=np.arange(3, dtype=np.int32)))
        out[side] = (j.unavailable, sorted(mod.replay(path).requests))
    assert out["torch"] == out["jax"] == (True, [0])


# -- the Router's recovery from a crash, against the JAX Router's

@pytest.fixture(scope="module")
def engines():
    jeng = JaxInferenceEngine(model=tiny_transformer(decode_attn="xla", pos_emb="rotary", loss_chunk_size=0),
                              config={"dtype": "fp32"})
    params = interop.params_from_jax(jax.tree.map(np.asarray, jeng.params))
    cfg = TransformerConfig(vocab_size=128, max_seq_len=64, num_layers=2, num_heads=4, hidden_size=64,
                            decode_attn="xla", pos_emb="rotary")
    teng = init_inference(Model(cfg), config={"dtype": "fp32"}, params=params, device="cpu")
    return {"jax": (jeng, JaxRouter, JaxRequest, JaxServingEngine, JaxCrash),
            "torch": (teng, Router, Request, ServingEngine, ControlPlaneCrash)}


def _recovery(side, engines, path, survivors):
    eng, R, Req, SE, Crash = engines[side]
    extra = {"ledger": {"enabled": False}} if side == "jax" else {}

    def replica():
        return SE(eng, config={"n_slots": 2, "max_seq_len": 64, "watchdog_mode": "raise", **extra})

    def router(reps, crash=()):
        cfg = {"router": {"health": {"timeout": 60.0}, "journal": {"enabled": True, "path": path}}}
        if crash:
            cfg["fault_injection"] = {"enabled": True, "router_crash_at": list(crash)}
        return R(replica_engines=reps, config=cfg)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 97, size=s).astype(np.int32) for s in (5, 11, 23)]
    reps = [replica(), replica()]
    a = router(reps, crash=[7])
    for i, (p, n) in enumerate(zip(prompts, (4, 8, 8))):
        a.submit(Req(uid=i, prompt=p, max_new_tokens=n), idempotency_key="key-0" if i == 0 else None)
    log = []
    with pytest.raises(Crash):
        for _ in range(20):
            log.append(a.step(now=0.0))
    a._journal.close()  # what the OS does for a killed process
    b = router(reps if survivors else [replica(), replica()])
    counters = {k: v for k, v in b.telemetry.registry.snapshot()["counters"].items()
                if k.startswith("router/recovery/")}
    res = b.drain()
    return {"log": log, "counters": counters, "idem": b.idempotency_lookup("key-0"),
            "results": {u: (r.status, [int(t) for t in r.tokens]) for u, r in res.items()},
            "journal": sorted(jjournal.replay(path).terminals)}


@pytest.mark.parametrize("survivors", [True, False], ids=["adopt", "redispatch"])
def test_router_crash_recovery_matches_jax(tmp_path, engines, survivors):
    out = {side: _recovery(side, engines, str(tmp_path / f"{side}.journal"), survivors) for side in SIDES}
    assert out["torch"] == out["jax"]
    t = out["torch"]
    assert t["idem"] == 0 and all(s == "ok" for s, _ in t["results"].values()) and len(t["results"]) == 3
    assert t["journal"] == [0, 1, 2]  # every accepted request: one terminal record
    key = "router/recovery/adopted_requests" if survivors else "router/recovery/redispatched"
    assert t["counters"][key] >= 1 and t["counters"]["router/recovery/replayed_terminals"] >= 1
