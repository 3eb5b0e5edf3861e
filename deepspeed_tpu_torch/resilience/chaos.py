"""Chaos conductor: declarative fault schedules, a seeded fault-space
search and a delta-debugging shrink (the port of
``deepspeed_tpu/resilience/chaos.py``).

A ``FaultSchedule`` is an ordered list of ``(site, key, at)`` entries over
the ``FaultInjector.SITES`` registry, generated from a seed and a workload
descriptor and serialised to canonical JSON, so any failure is a
replayable artifact. A ``ChaosRunner`` drives a fleet through a schedule:
the default in-process ``_FakeEngine`` fleet (host-only, milliseconds a
run), or real ``ServingEngine`` replicas through the ``engines`` factory,
and judges the run with the invariant oracles (``resilience/invariants.py``).
``search()`` runs N seeded schedules and, on a violation,
``shrink_schedule()`` delta-debugs the schedule to a minimal reproducer,
written as a rename-durable ``chaos-repro-NNN.json`` that ``replay_repro``
(``python -m deepspeed_tpu_torch.resilience.chaos --replay FILE``)
re-executes bit-identically.

Determinism is the whole design:

  * schedules are pure functions of ``(seed, workload)``;
  * runs use a synthetic fleet clock (``router.step(now=t)``, ``t``
    advancing 1.0 a step), the fake fleet deterministic tokens
    (``(uid*31 + 7*pos) % 97``), and a temporary journal: no wall-clock
    value reaches a verdict or the outcome digest;
  * the outcome digest is a sha256 over the canonical JSON of
    ``{uid: (status, tokens)}`` and the tripped invariants' names only, so
    two runs of one schedule give identical digests and a repro artifact is
    byte-identical across searches.

Semantics worth knowing:

  * ``router_crash`` entries crash the control plane ONCE: the runner
    rebuilds a Router over the same engines and journal with fault
    injection stripped, so the recovery runs clean and a schedule cannot
    crash-loop;
  * ``io_error`` entries arm the JOURNAL-APPEND clock
    (``io_error_journal_appends``): the Nth journal append fails, the
    journal goes fail-closed (typed ``journal_unavailable`` rejects), and
    the runner restarts the control plane over the same journal, the
    full-disk crash-then-recover path;
  * per-site fired/survived counters land in the telemetry registry
    (``chaos/site/<name>/fired|survived``);
  * the runner owns the engines its factory built for a run: at the run's
    end it ``close()``s those that have the method, so a real replica's
    cache and decode graph do not outlive its schedule.

The fleet's modules are imported where a run needs them: building,
serialising and shrinking schedules is host-only stdlib.

    python -m deepspeed_tpu_torch.resilience.chaos --search 64 --seed 0
    python -m deepspeed_tpu_torch.resilience.chaos --replay chaos-repros/chaos-repro-003.json
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from .faults import FaultInjector
from .invariants import (Violation, bitwise_parity_vs_reference,
                         exactly_once_failover, occupancy_drained,
                         occupancy_view, terminal_uid_conservation)

# sites the default in-process fake fleet can genuinely exercise; the
# rpc_*/gateway_* transport sites need a wire and ride the real-engine /
# process modes (and their own dedicated tests/drills)
FAKE_SITES = ("garbage_logits", "replica_dead", "replica_hang",
              "router_crash", "io_error")

DEFAULT_WORKLOAD = {
    "n_requests": 8,
    "n_replicas": 3,
    "n_slots": 2,
    "max_new_tokens": 6,
    "submit_per_step": 2,
    "arm_window": 10,     # step/append keys are drawn from [1, arm_window]
    "max_steps": 200,     # drain bound; overrun surfaces as zero-loss
    "sites": list(FAKE_SITES),
}


def _canonical(obj) -> bytes:
    """One JSON spelling for every durable chaos artifact: sorted keys,
    no whitespace — byte-identical across runs by construction."""
    return json.dumps(obj, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def derive_seed(seed: int, index: int) -> int:
    """The search's per-schedule seed: a pure, collision-spread function
    of (search seed, schedule index)."""
    return (int(seed) * 1_000_003 + int(index) * 7919 + 1) & 0x7FFFFFFF


@dataclass
class FaultEntry:
    """One scheduled fault: ``site`` names a ``FaultInjector.SITES``
    member; ``at`` is the site's 1-based clock key (router step, journal
    append index, decode step, nth RPC call, nth streamed token —
    whichever clock the site fires on); ``key`` is the site's remaining
    identity (replica id, request uid, RPC method name; 0 where the
    clock alone selects the fault)."""

    site: str
    key: object = 0
    at: int = 1

    def as_dict(self) -> dict:
        return {"site": self.site, "key": self.key, "at": int(self.at)}


@dataclass
class FaultSchedule:
    """An ordered, serializable fault plan plus the workload it was
    generated against. ``to_injector_config()`` lowers the entries onto
    the typed ``fault_injection`` key lists, so the SAME deterministic
    injector machinery every drill and test uses executes the plan."""

    entries: list = field(default_factory=list)
    seed: int = 0
    workload: dict = field(default_factory=lambda: dict(DEFAULT_WORKLOAD))

    # -- serialization ---------------------------------------------------

    def as_dict(self) -> dict:
        return {"version": 1, "seed": int(self.seed),
                "workload": dict(self.workload),
                "entries": [e.as_dict() for e in self.entries]}

    def to_json(self) -> str:
        return _canonical(self.as_dict()).decode()

    @classmethod
    def from_dict(cls, obj: dict) -> "FaultSchedule":
        return cls(entries=[FaultEntry(site=str(e["site"]),
                                       key=e.get("key", 0),
                                       at=int(e.get("at", 1)))
                            for e in obj.get("entries", [])],
                   seed=int(obj.get("seed", 0)),
                   workload=dict(DEFAULT_WORKLOAD,
                                 **obj.get("workload", {})))

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        return cls.from_dict(json.loads(text))

    def subset(self, indices: Iterable[int]) -> "FaultSchedule":
        keep = set(int(i) for i in indices)
        return FaultSchedule(
            entries=[e for i, e in enumerate(self.entries) if i in keep],
            seed=self.seed, workload=dict(self.workload))

    def sites(self) -> set:
        return {e.site for e in self.entries}

    # -- lowering --------------------------------------------------------

    def to_injector_config(self) -> dict:
        """The ``fault_injection`` dict executing this schedule. Raises
        ``ValueError`` for an unknown site or for ``garbage_logits``
        entries that disagree on decode step — the typed config carries
        ONE ``garbage_logits_decode_step``, so a schedule must keep its
        garbage entries on a single step (the generator does)."""
        cfg: dict = {"enabled": True, "seed": int(self.seed)}

        def app(name, value):
            cfg.setdefault(name, []).append(value)

        garbage_step: Optional[int] = None
        for e in self.entries:
            if e.site not in FaultInjector.SITES:
                raise ValueError(f"unknown fault site {e.site!r}")
            if e.site == "nan_grads":
                app("nan_grad_steps", int(e.at))
            elif e.site == "preempt":
                app("preempt_steps", int(e.at))
            elif e.site == "io_error":
                # journal-append clock — the serving-side io_error family
                app("io_error_journal_appends", int(e.at))
            elif e.site == "io_flaky":
                app("io_flaky_writes", int(e.at))
            elif e.site == "garbage_logits":
                if garbage_step is None:
                    garbage_step = int(e.at)
                elif garbage_step != int(e.at):
                    raise ValueError(
                        "garbage_logits entries disagree on decode step "
                        f"({garbage_step} vs {int(e.at)}) — the typed "
                        "config carries one garbage_logits_decode_step")
                app("garbage_logits_uids", int(e.key))
            elif e.site in ("replica_dead", "replica_hang"):
                app(f"{e.site}_at", [int(e.key), int(e.at)])
            elif e.site == "router_crash":
                app("router_crash_at", int(e.at))
            elif e.site in ("rpc_timeout", "rpc_conn_reset"):
                app(f"{e.site}_at", [str(e.key), int(e.at)])
            elif e.site == "rpc_garbled_frame":
                app("rpc_garbled_at", [str(e.key), int(e.at)])
            else:  # gateway_disconnect / gateway_stall
                app(f"{e.site}_at", [int(e.key), int(e.at)])
        if garbage_step is not None:
            cfg["garbage_logits_phase"] = "decode"
            cfg["garbage_logits_decode_step"] = garbage_step
        return cfg

    # -- generation ------------------------------------------------------

    @classmethod
    def generate(cls, seed: int, workload: Optional[dict] = None,
                 max_faults: int = 4) -> "FaultSchedule":
        """A random schedule as a pure function of ``(seed, workload)``:
        1..max_faults entries drawn over ``workload['sites']``, keys
        bounded by the workload (uids, replica ids, step windows). At
        most one ``router_crash`` per schedule (the runner's
        crash-once/recover-clean semantics) and one decode step shared
        by every ``garbage_logits`` entry (typed-config constraint)."""
        import random

        wl = dict(DEFAULT_WORKLOAD, **(workload or {}))
        rng = random.Random(f"dstpu-chaos:{int(seed)}")
        sites = list(wl["sites"])
        n = rng.randint(1, max(1, int(max_faults)))
        garbage_step = rng.randrange(max(1, int(wl["max_new_tokens"])))
        entries: list = []
        seen = set()
        crashed = False
        for _ in range(n):
            site = rng.choice(sites)
            if site == "router_crash":
                if crashed:
                    continue
                crashed = True
                e = FaultEntry(site, 0, rng.randint(2, int(wl["arm_window"])))
            elif site == "garbage_logits":
                e = FaultEntry(site, rng.randint(1, int(wl["n_requests"])),
                               garbage_step)
            elif site in ("replica_dead", "replica_hang"):
                e = FaultEntry(site, rng.randrange(int(wl["n_replicas"])),
                               rng.randint(1, int(wl["arm_window"])))
            elif site == "io_error":
                e = FaultEntry(site, 0, rng.randint(1, int(wl["n_requests"])))
            elif site in ("rpc_timeout", "rpc_conn_reset",
                          "rpc_garbled_frame"):
                e = FaultEntry(site, rng.choice(["step", "submit"]),
                               rng.randint(1, int(wl["arm_window"])))
            elif site in ("gateway_disconnect", "gateway_stall"):
                e = FaultEntry(site, rng.randint(1, int(wl["n_requests"])),
                               rng.randint(1, int(wl["max_new_tokens"])))
            else:  # nan_grads / preempt / io_flaky (training clocks)
                e = FaultEntry(site, 0, rng.randint(1, int(wl["arm_window"])))
            k = (e.site, json.dumps(e.key), e.at)
            if k in seen:
                continue
            seen.add(k)
            entries.append(e)
        return cls(entries=entries, seed=int(seed), workload=wl)


# ---------------------------------------------------------------------------
# outcome + runner


@dataclass
class ChaosOutcome:
    """Everything one schedule execution produced, digest included."""

    accepted: list = field(default_factory=list)
    rejected: list = field(default_factory=list)
    results: dict = field(default_factory=dict)   # uid -> RequestResult
    violations: list = field(default_factory=list)
    fired: Counter = field(default_factory=Counter)   # site -> injections
    crashes: int = 0
    restarts: int = 0
    steps: int = 0
    digest: str = ""

    def summary(self) -> dict:
        from collections import Counter as _C

        return {
            "accepted": len(self.accepted),
            "rejected": len(self.rejected),
            "statuses": dict(_C(getattr(r, "status", "?")
                                for r in self.results.values())),
            "fired": dict(self.fired),
            "crashes": self.crashes,
            "restarts": self.restarts,
            "steps": self.steps,
            "violations": [str(v) for v in self.violations],
            "digest": self.digest,
        }


def _outcome_digest(results: dict, violations: list, rejected: list) -> str:
    payload = {
        "results": {str(int(u)): {
            "status": str(getattr(r, "status", "?")),
            "tokens": [int(t) for t in getattr(r, "tokens", [])]}
            for u, r in results.items()},
        "violations": sorted({v.invariant for v in violations}),
        "rejected": sorted(int(u) for u in rejected),
    }
    return hashlib.sha256(_canonical(payload)).hexdigest()


class _FakeEngine:
    """Deterministic host-only scheduler surface: everything the Router
    touches, no device work. Tokens are a pure function of
    ``(uid, position)`` so bitwise parity against a clean run is
    meaningful; ``garbage_logits`` faults follow the serving engine's
    quarantine-requeue-once semantics (one clean replay, then
    ``failed_nan``)."""

    role = "both"

    def __init__(self, rid: int, injector: Optional[FaultInjector],
                 workload: dict):
        self.replica_id = rid
        self._inj = injector
        self.n_slots = int(workload.get("n_slots", 2))
        self._queue: list = []
        self._active: dict = {}   # uid -> {"req", "pos", "tokens"}
        self._results: dict = {}
        self._requeues: Counter = Counter()
        self.last_step_compiled = False

    # -- scheduler surface ----------------------------------------------

    def submit(self, req):
        if (req.uid in self._active or req.uid in self._results
                or any(r.uid == req.uid for r in self._queue)):
            raise ValueError(f"duplicate uid {req.uid}")
        self._queue.append(req)
        return req.uid

    def requeue(self, req):
        self._results.pop(req.uid, None)
        self._queue.append(req)
        return req.uid

    def withdraw(self, uid):
        for i, r in enumerate(self._queue):
            if r.uid == uid:
                return self._queue.pop(i)
        return None

    def cancel(self, uid):
        from ..inference.serving import RequestResult
        import numpy as np

        req = self.withdraw(uid)
        if req is None:
            st = self._active.pop(uid, None)
            if st is None:
                return False
            req = st["req"]
        self._results[uid] = RequestResult(
            uid=uid, tokens=np.zeros((0,), np.int32),
            prompt_len=int(len(req.prompt)),
            arrival_time=req.arrival_time, finish_time=0.0,
            status="cancelled")
        return True

    def result(self, uid):
        return self._results.get(uid)

    def step(self, now=None, enforce_deadlines=True):
        from ..inference.serving import RequestResult
        import numpy as np

        terminal = []
        while self._queue and len(self._active) < self.n_slots:
            req = self._queue.pop(0)
            self._active[req.uid] = {"req": req, "pos": 0, "tokens": []}
        for uid in sorted(self._active):
            st = self._active[uid]
            if self._inj is not None and self._inj.garbage_logits(
                    uid, "decode", st["pos"]):
                del self._active[uid]
                replays = self._requeues[uid]
                self._requeues[uid] += 1
                if replays >= 1:
                    self._results[uid] = RequestResult(
                        uid=uid, tokens=np.zeros((0,), np.int32),
                        prompt_len=int(len(st["req"].prompt)),
                        arrival_time=st["req"].arrival_time,
                        finish_time=float(now or 0.0), status="failed_nan")
                    terminal.append(uid)
                else:
                    self._queue.append(st["req"])
                continue
            st["tokens"].append((uid * 31 + 7 * st["pos"]) % 97)
            st["pos"] += 1
            if st["pos"] >= st["req"].max_new_tokens:
                del self._active[uid]
                self._results[uid] = RequestResult(
                    uid=uid,
                    tokens=np.asarray(st["tokens"], np.int32),
                    prompt_len=int(len(st["req"].prompt)),
                    arrival_time=st["req"].arrival_time,
                    finish_time=float(now or 0.0), status="ok")
                terminal.append(uid)
        return terminal

    def live_requests(self):
        return list(self._queue) + [st["req"]
                                    for _, st in sorted(self._active.items())]

    def arrived_queue_len(self, now=None):
        return len(self._queue)

    def prefix_match_len(self, prompt):
        return 0

    def pending_arrival_times(self):
        return []

    def set_epoch(self, epoch):
        pass

    def telemetry_snapshot(self):
        return {"replica_id": self.replica_id, "metrics": {"gauges": {}}}

    def compile_counts(self):
        return {"decode": 0, "prefill": 0}

    @property
    def load(self):
        return len(self._queue) + len(self._active)

    @property
    def idle(self):
        return not self._queue and not self._active

    @property
    def queue_len(self):
        return len(self._queue)

    @property
    def n_active(self):
        return len(self._active)

    @property
    def n_free(self):
        return self.n_slots - len(self._active)


class ChaosRunner:
    """Drives a fleet through a ``FaultSchedule`` and judges the run with
    the shared invariant oracles.

    ``engines``: optional factory ``(workload, injector_cfg) -> [engine]``
    — pass one building real ``ServingEngine`` replicas for real-engine
    mode, or RPC ``ReplicaClient`` fleets for process mode; default is the
    host-only ``_FakeEngine`` fleet. ``telemetry``: a shared ``Telemetry`` whose
    registry accumulates the ``chaos/site/<name>/fired|survived``
    coverage counters across runs (one is built when omitted)."""

    def __init__(self, *, engines: Optional[Callable] = None,
                 telemetry=None, health: Optional[dict] = None):
        from ..telemetry import Telemetry

        self._engines = engines or (lambda wl, fi: [
            _FakeEngine(rid, FaultInjector(fi) if fi else None, wl)
            for rid in range(int(wl["n_replicas"]))])
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._health = dict(health or {"timeout": 60.0, "jitter": 0.0})

    # -- fleet plumbing --------------------------------------------------

    def _build_router(self, engines, jpath: str, fi_cfg: Optional[dict]):
        from ..inference.router import Router

        config: dict = {
            "router": {"health": dict(self._health),
                       "journal": {"enabled": True, "path": jpath,
                                   "fsync": False}},
        }
        if fi_cfg:
            config["fault_injection"] = dict(fi_cfg)
        return Router(replica_engines=engines, config=config,
                      telemetry=self.telemetry)

    def reference(self, workload: Optional[dict] = None) -> dict:
        """The unfaulted reference run for a workload: every uid's clean
        terminal result, the parity oracle's right-hand side."""
        wl = dict(DEFAULT_WORKLOAD, **(workload or {}))
        out = self.run(FaultSchedule(entries=[], workload=wl),
                       reference=None)
        return dict(out.results)

    def run(self, schedule: FaultSchedule, *, reference: Optional[dict] = None,
            oracles: Optional[Iterable[Callable]] = None) -> ChaosOutcome:
        """One schedule execution: submit the workload, step the fleet on
        a synthetic clock, recover from injected control-plane crashes
        and journal outages, drain, then judge. ``oracles``: extra
        callables ``(ChaosOutcome) -> [Violation]`` appended to the
        standard suite (the search's extension point)."""
        from ..inference.serving import Request
        import numpy as np

        from .errors import ControlPlaneCrash, RequestRejected

        wl = dict(DEFAULT_WORKLOAD, **(schedule.workload or {}))
        fi_cfg = schedule.to_injector_config() if schedule.entries else None
        out = ChaosOutcome()
        fired: Counter = out.fired
        with tempfile.TemporaryDirectory(prefix="dstpu-chaos-") as td:
            jpath = os.path.join(td, "chaos.dsjr")
            engines = self._engines(wl, fi_cfg)
            router = self._build_router(engines, jpath, fi_cfg)
            pending = deque(
                Request(uid=uid,
                        prompt=(np.arange(3 + uid % 5, dtype=np.int32) + 1),
                        max_new_tokens=int(wl["max_new_tokens"]))
                for uid in range(1, int(wl["n_requests"]) + 1))
            retry: deque = deque()   # journal_unavailable rejects, resubmitted
            terminal_events: list = []
            now = 0.0
            journal_down = False

            def harvest(r):
                if r._inj is not None:
                    fired.update(r._inj.injected)

            def restart(r):
                harvest(r)
                if r._journal is not None:
                    r._journal.close()
                # recovery runs CLEAN: fault injection is stripped, so a
                # crash schedule cannot crash-loop and the journal's
                # append clock restarts un-armed
                return self._build_router(engines, jpath, None)

            while out.steps < int(wl["max_steps"]):
                for _ in range(int(wl["submit_per_step"])):
                    if retry:
                        req = retry.popleft()
                    elif pending:
                        req = pending.popleft()
                    else:
                        break
                    try:
                        router.submit(req)
                        out.accepted.append(req.uid)
                    except RequestRejected as e:
                        if e.reason == "journal_unavailable":
                            journal_down = True
                            retry.append(req)
                        else:
                            out.rejected.append(req.uid)
                try:
                    terminal_events.extend(router.step(now=now))
                except ControlPlaneCrash:
                    out.crashes += 1
                    out.restarts += 1
                    router = restart(router)
                    journal_down = False
                else:
                    if (router._journal is not None
                            and router._journal.unavailable):
                        # terminals may have been PARKED (fail-closed on
                        # promises) even when no submit drew a typed
                        # reject — an operator restart resolves them
                        journal_down = True
                    if journal_down:
                        # the full-disk path: the journal failed closed —
                        # restart the control plane over the same file
                        # (its durable prefix replays) and resubmit the
                        # typed rejects
                        out.restarts += 1
                        router = restart(router)
                        journal_down = False
                out.steps += 1
                now += 1.0
                if (not pending and not retry
                        and all(u in router.results for u in out.accepted)
                        and all(r.engine.idle for r in router._replicas
                                if r.state != "dead")):
                    break

            harvest(router)
            for e in engines:
                inj = getattr(e, "_inj", None)
                if isinstance(inj, FaultInjector):
                    fired.update(inj.injected)
            out.results = {u: router.results[u] for u in out.accepted
                           if u in router.results}
            out.violations = list(terminal_uid_conservation(
                out.accepted, out.results, out.rejected))
            if reference is not None:
                out.violations += bitwise_parity_vs_reference(
                    out.results, reference, statuses=("ok",))
            out.violations += occupancy_drained(
                occupancy_view(r.engine, name=r.rid)
                for r in router._replicas if r.state != "dead")
            out.violations += exactly_once_failover(
                router.router_stats(), terminal_events=terminal_events)
            for oracle in (oracles or ()):
                out.violations += list(oracle(out))
            if router._journal is not None:
                router._journal.close()
            for e in engines:
                if callable(getattr(e, "close", None)):
                    e.close()
        out.digest = _outcome_digest(out.results, out.violations,
                                     out.rejected)
        tm = self.telemetry
        for site, n in fired.items():
            tm.counter(f"chaos/site/{site}/fired").inc(int(n))
            if not out.violations:
                tm.counter(f"chaos/site/{site}/survived").inc(int(n))
        return out


# ---------------------------------------------------------------------------
# shrinking + search


def shrink_schedule(schedule: FaultSchedule,
                    still_fails: Callable[[FaultSchedule], bool]
                    ) -> FaultSchedule:
    """Greedy delta-debugging (ddmin-style) over the entry list: try
    dropping chunks (half, then quarters, ... down to single entries),
    keeping any candidate for which ``still_fails`` holds. Deterministic
    — chunk order is left-to-right and the predicate is a pure replay —
    and sound by construction: every kept candidate RE-TRIPPED the
    original oracle, so the minimum can never have minimized the
    violation away."""
    cur = list(schedule.entries)
    chunk = max(1, len(cur) // 2)
    while chunk >= 1:
        i = 0
        while i < len(cur):
            cand = cur[:i] + cur[i + chunk:]
            if cand != cur and still_fails(FaultSchedule(
                    entries=cand, seed=schedule.seed,
                    workload=dict(schedule.workload))):
                cur = cand
            else:
                i += chunk
        if chunk == 1:
            break
        chunk //= 2
    return FaultSchedule(entries=cur, seed=schedule.seed,
                         workload=dict(schedule.workload))


def write_repro(path: str, schedule: FaultSchedule, outcome: ChaosOutcome,
                *, search_seed: int, index: int) -> None:
    """Rename-durable reproducer artifact: the minimal schedule, the
    tripped invariants, and the outcome digest ``--replay`` verifies
    bit-identically. Canonical JSON, no timestamps — the bytes
    are a pure function of the run."""
    from ..utils.durability import write_durable_bytes

    payload = {
        "kind": "chaos-repro",
        "version": 1,
        "search_seed": int(search_seed),
        "schedule_index": int(index),
        "schedule": schedule.as_dict(),
        "violations": sorted({v.invariant for v in outcome.violations}),
        "violation_messages": sorted(str(v) for v in outcome.violations),
        "digest": outcome.digest,
    }
    write_durable_bytes(path, _canonical(payload) + b"\n")


def search(runner: ChaosRunner, n_schedules: int, seed: int, *,
           workload: Optional[dict] = None, artifact_dir: str = "chaos-repros",
           shrink: bool = True, max_faults: int = 4,
           oracles: Optional[Iterable[Callable]] = None,
           log: Optional[Callable[[str], None]] = None) -> dict:
    """Seeded fault-space search: run ``n_schedules`` generated schedules
    against the invariant suite; each violation is shrunk to a minimal
    reproducer and written to ``artifact_dir/chaos-repro-NNN.json``.
    Returns the summary row the CLI prints."""
    wl = dict(DEFAULT_WORKLOAD, **(workload or {}))
    reference = runner.reference(wl)
    sites_covered: set = set()
    violations: list = []
    for i in range(int(n_schedules)):
        sched = FaultSchedule.generate(derive_seed(seed, i), wl,
                                       max_faults=max_faults)
        out = runner.run(sched, reference=reference, oracles=oracles)
        sites_covered |= {s for s, n in out.fired.items() if n}
        if not out.violations:
            continue
        tripped = {v.invariant for v in out.violations}
        if log is not None:
            log(f"schedule {i}: tripped {sorted(tripped)} — shrinking")
        minimized = sched
        if shrink:
            def still_fails(cand):
                got = runner.run(cand, reference=reference, oracles=oracles)
                return tripped <= {v.invariant for v in got.violations}

            minimized = shrink_schedule(sched, still_fails)
        final = runner.run(minimized, reference=reference, oracles=oracles)
        os.makedirs(artifact_dir, exist_ok=True)
        path = os.path.join(artifact_dir, f"chaos-repro-{i:03d}.json")
        write_repro(path, minimized, final, search_seed=seed, index=i)
        violations.append({
            "schedule_index": i,
            "invariants": sorted(tripped),
            "entries": len(sched.entries),
            "minimal_entries": len(minimized.entries),
            "repro": path,
            "digest": final.digest,
        })
    return {
        "schedules_run": int(n_schedules),
        "sites_covered": sorted(sites_covered),
        "violations": violations,
    }


def replay_repro(runner: ChaosRunner, repro: dict, *,
                 oracles: Optional[Iterable[Callable]] = None) -> dict:
    """Re-execute a ``chaos-repro-NNN.json`` (or bare schedule dict) and
    verify bit-identical reproduction: same outcome digest, same tripped
    invariant set."""
    sched = FaultSchedule.from_dict(repro.get("schedule", repro))
    reference = runner.reference(sched.workload)
    out = runner.run(sched, reference=reference, oracles=oracles)
    tripped = sorted({v.invariant for v in out.violations})
    want_digest = repro.get("digest")
    want_tripped = repro.get("violations")
    return {
        "digest": out.digest,
        "tripped": tripped,
        "digest_match": (want_digest is None or out.digest == want_digest),
        "violations_match": (want_tripped is None
                             or tripped == sorted(want_tripped)),
        "outcome": out,
    }


# ---------------------------------------------------------------------------
# the command line (bench.py --chaos-search / --chaos-replay's counterpart)


def _search_cli(n_schedules: int, seed: int, artifact_dir: str) -> int:
    """Run ``n_schedules`` generated schedules over the fake fleet; print
    one JSON row; exit 0 only when every schedule is green."""
    import sys
    import time

    t0 = time.perf_counter()
    runner = ChaosRunner()
    row = search(runner, n_schedules, seed, artifact_dir=artifact_dir,
                 log=lambda m: print(f"chaos-search: {m}", file=sys.stderr,
                                     flush=True))
    counters = runner.telemetry.registry.snapshot()["counters"]
    site_fired = {s: int(counters.get(f"chaos/site/{s}/fired", 0))
                  for s in row["sites_covered"]}
    print(json.dumps({
        "metric": "chaos fault-space search (green schedules)",
        "value": int(row["schedules_run"]) - len(row["violations"]),
        "unit": "schedules",
        "schedules_run": row["schedules_run"],
        "sites_covered": row["sites_covered"],
        "site_fired": site_fired,
        "violations": row["violations"],
        "seed": seed,
        "elapsed_s": round(time.perf_counter() - t0, 2),
    }), flush=True)
    return 1 if row["violations"] else 0


def _replay_cli(path: str) -> int:
    """Replay one ``chaos-repro-NNN.json`` (or a bare schedule); print one
    JSON row; exit 0 only when the digest and the tripped set match."""
    import time

    t0 = time.perf_counter()
    with open(path) as f:
        repro = json.load(f)
    rep = replay_repro(ChaosRunner(), repro)
    ok = bool(rep["digest_match"] and rep["violations_match"])
    print(json.dumps({
        "metric": "chaos repro replay (bit-identical)",
        "value": int(ok),
        "unit": "bool",
        "repro": os.path.basename(path),
        "digest": rep["digest"],
        "digest_match": rep["digest_match"],
        "tripped": rep["tripped"],
        "violations_match": rep["violations_match"],
        "elapsed_s": round(time.perf_counter() - t0, 2),
    }), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.resilience.chaos",
        description="seeded fault-space search over the host-only fake fleet, or the replay of a reproducer")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--search", type=int, metavar="N", help="run N generated schedules")
    mode.add_argument("--replay", metavar="FILE", help="re-execute a chaos-repro-NNN.json")
    ap.add_argument("--seed", type=int, default=0, help="the search's seed")
    ap.add_argument("--artifact-dir", default=os.path.join(os.getcwd(), "chaos-repros"),
                    help="where the search writes its reproducers")
    args = ap.parse_args(argv)
    if args.replay is not None:
        return _replay_cli(args.replay)
    if args.search < 1:
        ap.error("--search needs N >= 1")
    return _search_cli(args.search, args.seed, args.artifact_dir)


__all__ = [
    "ChaosOutcome",
    "ChaosRunner",
    "DEFAULT_WORKLOAD",
    "FAKE_SITES",
    "FaultEntry",
    "FaultSchedule",
    "derive_seed",
    "replay_repro",
    "search",
    "shrink_schedule",
    "write_repro",
]


if __name__ == "__main__":
    raise SystemExit(main())
