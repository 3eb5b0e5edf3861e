"""``chip_smoke.py``'s phase 23 on the CPU at a tiny size: the same control
flow as on the card, with its workers on ``--device cpu --model tiny``.

The runner -> launch -> worker launch with its rendezvous env, SIGTERM to a
second launch ending its tree, the agent's crash and hang drills resuming
bitwise across processes, ``CHAOS_SCHEDULES`` chaos schedules twice over real tiny replicas,
and the fake-fleet search shrunk and replayed. Every check of the phase
raises on failure; on the CPU no kernel launches, so every count is 0.
"""

import importlib.util
import os

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase23_rehearses_on_the_cpu(capsys):
    smoke = _chip_smoke()
    out = smoke.elastic_chaos_phase(torch.device("cpu"), "cpu", model="tiny")
    printed = capsys.readouterr().out
    assert out["flash"] == [0, 0, 0] and out["xent"] == [0] * 5 and out["sparse"] == [0, 0, 0]
    assert out["decode"] == (0, 0) and out["seconds"] > 0
    for line in ("runner -> launch -> worker, 6 steps uninterrupted", "crash drill", "hang drill",
                 "replay_repro reproduces it bit-identically"):
        assert line in printed
    assert printed.count("green twice, one digest") == smoke.CHAOS_SCHEDULES
    assert '{"elastic": ' in printed and '{"chaos": ' in printed
