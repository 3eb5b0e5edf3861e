"""Training guardrails: NaN/overflow streak tracking and rewind decisions
(a copy of ``deepspeed_tpu/resilience/guardrails.py``).

The train step already *skips* non-finite updates on the device (the
``torch.where(finite, ...)`` gate of ``runtime/engine.py`` holds for
bf16/fp32 as for fp16). What the device cannot do is decide that a run has
gone *persistently* bad: one NaN step is a skip; ``max_consecutive_bad_steps``
NaN steps in a row is a poisoned trajectory that skipping will never fix.
That judgement is host-side and lives here.

``TrainingGuardrail.observe(overflow)`` returns an action string the engine
acts on:

  ``ok``        finite step (a previous streak, if any, counts as recovered)
  ``skip``      non-finite step, streak below the threshold — the device
                already skipped the update; keep going
  ``rewind``    streak hit the threshold and a rewind target exists — the
                engine reloads the last good checkpoint
  ``diverged``  streak hit the threshold with nowhere to rewind — the engine
                raises ``TrainingDivergedError`` rather than burn compute

All transitions are counted into the engine's telemetry registry under
``resilience/*``.
"""

from __future__ import annotations

from typing import Optional


class TrainingGuardrail:
    def __init__(self, max_consecutive_bad_steps: int, rewind: bool, telemetry):
        self.max_bad = int(max_consecutive_bad_steps)
        self.rewind_enabled = bool(rewind)
        self.tm = telemetry
        self.bad_streak = 0
        self.last_good: Optional[tuple] = None  # (save_dir, tag)
        # rewinds granted since the last FINITE step: a fault that reproduces
        # right after restore (poisoned checkpoint, deterministic bad shard)
        # would otherwise rewind -> re-fault -> rewind forever; one rewind per
        # stretch of bad steps, then diverge
        self._rewinds_since_good = 0

    def note_checkpoint(self, save_dir: str, tag: str) -> None:
        """Record the newest checkpoint as the rewind target. Saves taken
        mid-streak are not trusted (the state may already be poisoned)."""
        if self.bad_streak == 0:
            self.last_good = (save_dir, tag)

    def observe(self, overflow: bool) -> str:
        if not overflow:
            if self.bad_streak:
                # the skip path contained the fault and training resumed
                self.tm.counter("resilience/recovered").inc()
            self.bad_streak = 0
            self._rewinds_since_good = 0
            return "ok"
        self.bad_streak += 1
        self.tm.counter("resilience/nan_skipped_steps").inc()
        if self.bad_streak < self.max_bad:
            return "skip"
        if (self.rewind_enabled and self.last_good is not None
                and self._rewinds_since_good == 0):
            return "rewind"
        return "diverged"

    # -- checkpointable state (ridden by the engine's client_state) --------
    # A preempted-and-resumed run must re-enter with the live streak, or a
    # fault straddling the preemption would get a fresh skip budget (and a
    # fresh rewind grant) the uninterrupted run never had. ``last_good``
    # rides too: without it, a resumed run whose restored streak then
    # crosses the threshold would find no rewind target and escalate to
    # ``diverged`` where the uninterrupted run (whose guardrail still held
    # its pre-streak good tag) would have rewound.
    def state_dict(self) -> dict:
        return {"bad_streak": self.bad_streak,
                "rewinds_since_good": self._rewinds_since_good,
                "last_good": list(self.last_good) if self.last_good else None}

    def load_state_dict(self, sd: dict) -> None:
        self.bad_streak = int(sd.get("bad_streak", self.bad_streak))
        self._rewinds_since_good = int(
            sd.get("rewinds_since_good", self._rewinds_since_good))
        lg = sd.get("last_good")
        if lg:  # absent/None (older checkpoints) keeps the live value
            self.last_good = (str(lg[0]), str(lg[1]))

    def rewound(self) -> None:
        """The engine completed a rewind: the streak restarts from clean.
        A second rewind is not granted until a finite step lands — if the
        restored state re-faults immediately, the next threshold crossing
        escalates straight to ``diverged``."""
        self.bad_streak = 0
        self._rewinds_since_good += 1
        self.tm.counter("resilience/rewinds").inc()
        self.tm.counter("resilience/recovered").inc()
