"""Invariant oracles: the resilience contract as a reusable library (a
copy of ``deepspeed_tpu/resilience/invariants.py``, stdlib + numpy).

Seven bench.py drills (--fault-rate/--chaos/--chaos-serving/--surge/
--gateway-chaos/--router-chaos/--tenant-chaos) grew the same assertions
independently: every accepted request reaches a terminal state, recovered
output is bitwise-identical to an unfaulted run, slots drain to zero,
failover happens exactly once per uid, raw secrets never reach durable
artifacts. This module is the single home for those checks — each oracle
is a pure function over run artifacts (results, router stats, engine
occupancy views, journal bytes) returning typed ``Violation`` reports,
so a drill, a tier-1 test, and the chaos-search harness
(``resilience/chaos.py``) all judge a run with the SAME code.

Design rules:

  * oracles never assert — they RETURN violations; ``check()`` converts a
    non-empty list into a raised ``InvariantViolation`` (an
    ``AssertionError`` subclass, so the drills' exit semantics and pytest
    integration are unchanged);
  * oracles are tolerant readers: occupancy views are plain dicts built
    by ``occupancy_view`` via getattr with per-field presence checks, so
    a remote ``ReplicaClient``, an in-process ``ServingEngine`` and a
    host-only fake all work;
  * violation messages NEVER interpolate secret material — the
    secret-hygiene oracle reports the artifact name and the secret's
    index, not its bytes.

Stdlib + numpy only: every oracle runs host-side.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping, Optional

import numpy as np


@dataclass
class Violation:
    """One invariant breach: which oracle, what happened, enough typed
    detail to reproduce the comparison without re-running anything."""

    invariant: str
    message: str
    details: dict = field(default_factory=dict)

    def __str__(self) -> str:  # drill tracebacks read this
        return f"[{self.invariant}] {self.message}"


class InvariantViolation(AssertionError):
    """Raised by ``check()`` — an ``AssertionError`` so drills keep their
    non-zero-exit contract and pytest renders it as a plain failure."""

    def __init__(self, violations: list):
        self.violations = list(violations)
        super().__init__(
            f"{len(self.violations)} invariant violation(s): "
            + "; ".join(str(v) for v in self.violations))


def check(violations: Iterable[Violation]) -> None:
    """Raise ``InvariantViolation`` when any oracle reported a breach —
    the one-line bridge from the report-based API to assert-style
    callers (the bench drills)."""
    violations = list(violations)
    if violations:
        raise InvariantViolation(violations)


def _tokens(res) -> list:
    """Terminal output as a plain int list — tolerant of RequestResult
    objects, numpy arrays and bare lists (SSE event payloads)."""
    toks = getattr(res, "tokens", res)
    return [int(t) for t in np.asarray(toks).reshape(-1)]


def _status(res) -> Optional[str]:
    return getattr(res, "status", None)


# ---------------------------------------------------------------------------
# the six extracted oracles


def zero_accepted_loss(accepted: Iterable[int],
                       results: Mapping[int, object]) -> list:
    """Every ACCEPTED uid must hold a terminal result — the zero-loss
    contract every drill opens with (``submitted - set(results)`` empty).
    Rejected submits are the caller's business: only pass uids the fleet
    actually promised."""
    missing = sorted(set(int(u) for u in accepted) - {int(u) for u in results})
    if not missing:
        return []
    return [Violation(
        "zero_accepted_loss",
        f"accepted requests never reached a terminal status: {missing}",
        {"missing": missing})]


def terminal_uid_conservation(accepted: Iterable[int],
                              results: Mapping[int, object],
                              rejected: Iterable[int] = ()) -> list:
    """The terminal set must be exactly the accepted set: no accepted uid
    unaccounted for (that is ``zero_accepted_loss``), and no terminal
    result for a uid that was never accepted — a rejected or phantom uid
    with a result means double-accounting (the owned-by-nobody
    class of bug)."""
    acc = {int(u) for u in accepted}
    rej = {int(u) for u in rejected}
    out = list(zero_accepted_loss(acc, results))
    phantoms = sorted({int(u) for u in results} - acc)
    if phantoms:
        out.append(Violation(
            "terminal_uid_conservation",
            f"terminal results exist for uids never accepted: {phantoms}"
            + (f" (of which rejected: {sorted(set(phantoms) & rej)})"
               if set(phantoms) & rej else ""),
            {"phantoms": phantoms}))
    return out


def bitwise_parity_vs_reference(results: Mapping[int, object],
                                reference: Mapping[int, object],
                                uids: Optional[Iterable[int]] = None,
                                *, statuses: tuple = ("ok",),
                                min_compared: int = 0) -> list:
    """Recovered output must be BITWISE-identical to the unfaulted
    reference run — greedy decoding makes equality meaningful, and any
    divergence means a replay re-decoded from corrupted state. Compares
    ``uids`` (default: every reference uid present in ``results``) whose
    status is in ``statuses`` (pass ``statuses=None`` to compare
    regardless); ``min_compared`` guards against a vacuously-green pass
    where degradation legitimately failed every candidate."""
    out = []
    if uids is None:
        uids = [u for u in reference if u in results]
    compared = 0
    for u in uids:
        u = int(u)
        if u not in results:
            out.append(Violation(
                "bitwise_parity_vs_reference",
                f"uid {u} has no result to compare", {"uid": u}))
            continue
        res = results[u]
        st = _status(res)
        if statuses is not None and st is not None and st not in statuses:
            continue
        compared += 1
        got, want = _tokens(res), _tokens(reference[u])
        if got != want:
            out.append(Violation(
                "bitwise_parity_vs_reference",
                f"uid {u} diverged from the unfaulted run "
                f"(got {len(got)} tokens, want {len(want)})",
                {"uid": u, "got": got, "want": want}))
    if compared < min_compared:
        out.append(Violation(
            "bitwise_parity_vs_reference",
            f"only {compared} uids were comparable (< {min_compared}) — "
            f"the parity check would be vacuous",
            {"compared": compared, "min_compared": min_compared}))
    return out


def occupancy_view(engine, name=None) -> dict:
    """A tolerant occupancy snapshot of one engine-like object: only the
    fields the object actually exposes are captured, so the oracle works
    over ``ServingEngine``, ``ReplicaClient`` and host-only fakes alike."""
    view: dict = {"name": str(name if name is not None
                              else getattr(engine, "replica_id", "?"))}
    for attr in ("n_active", "n_prefilling", "n_free", "n_slots", "load",
                 "queue_len"):
        val = getattr(engine, attr, None)
        if isinstance(val, (int, float)):
            view[attr] = int(val)
    q = getattr(engine, "quarantined_slots", None)
    if q is not None:
        view["quarantined"] = len(q)
    stats_fn = getattr(engine, "prefix_cache_stats", None)
    if callable(stats_fn):
        try:
            st = stats_fn()
        except (RuntimeError, OSError):  # a dead remote cannot answer
            st = None
        if isinstance(st, dict) and "entries" in st:
            view["prefix_refs"] = [
                {"len": e.get("len"), "refs": e.get("refs", 0)}
                for e in st["entries"] if e.get("refs", 0)]
    return view


def occupancy_drained(views: Iterable) -> list:
    """After a full drain, every reachable replica must be back to zero
    occupancy: no active or prefilling slots, no queued load, every
    non-quarantined slot in the free pool, and no prefix-cache entry
    still pinned by a freed slot (the slot-leak / ref-leak class of bug).
    ``views`` are ``occupancy_view`` dicts (or engine objects, converted
    here)."""
    out = []
    for v in views:
        if not isinstance(v, dict):
            v = occupancy_view(v)
        name = v.get("name", "?")
        for attr in ("n_active", "n_prefilling", "load", "queue_len"):
            if v.get(attr, 0):
                out.append(Violation(
                    "occupancy_drained",
                    f"replica {name}: {attr}={v[attr]} after drain "
                    f"(want 0)", {"replica": name, "field": attr,
                                  "value": v[attr]}))
        if "n_free" in v and "n_slots" in v:
            free, slots = v["n_free"], v["n_slots"]
            quarantined = v.get("quarantined", 0)
            if free + quarantined != slots:
                out.append(Violation(
                    "occupancy_drained",
                    f"replica {name}: slot leak — {free} free + "
                    f"{quarantined} quarantined != {slots} slots",
                    {"replica": name, "n_free": free,
                     "quarantined": quarantined, "n_slots": slots}))
        if v.get("prefix_refs"):
            out.append(Violation(
                "occupancy_drained",
                f"replica {name}: prefix-cache entries still pinned "
                f"after drain: {v['prefix_refs']}",
                {"replica": name, "prefix_refs": v["prefix_refs"]}))
    return out


def exactly_once_failover(router_stats: Mapping, *, min_recovered: int = 0,
                          terminal_events: Optional[Iterable[int]] = None
                          ) -> list:
    """Failover discipline: the fleet recovered at least ``min_recovered``
    failed-over requests (the drill's proof the kill actually exercised
    the path), and — when the per-step terminal batches are provided —
    no uid was reported terminal twice (a double failover or a replayed
    completion would double-notify the gateway)."""
    out = []
    recovered = int(router_stats.get("failovers_recovered", 0))
    if recovered < min_recovered:
        out.append(Violation(
            "exactly_once_failover",
            f"failovers_recovered={recovered} < {min_recovered} — the "
            f"fault never exercised failover, or recovery lost requests",
            {"recovered": recovered, "min_recovered": min_recovered,
             "stats": dict(router_stats)}))
    if terminal_events is not None:
        seen: dict = {}
        for u in terminal_events:
            seen[int(u)] = seen.get(int(u), 0) + 1
        dupes = {u: n for u, n in seen.items() if n > 1}
        if dupes:
            out.append(Violation(
                "exactly_once_failover",
                f"uids reported terminal more than once: {dupes}",
                {"duplicates": dupes}))
    return out


def single_decode_program(compile_counts: Mapping, limit: int = 1) -> list:
    """Faults must not fork compiled programs: each reachable replica's
    decode program count stays at ``limit`` (one compile, reused across
    every requeue/failover replay). ``compile_counts`` maps a replica
    name to its ``compile_counts()['decode']`` value."""
    bad = {str(k): int(v) for k, v in compile_counts.items()
           if int(v) > limit}
    if not bad:
        return []
    return [Violation(
        "single_decode_program",
        f"decode retraced under faults: {bad} (limit {limit})",
        {"counts": bad, "limit": limit})]


def no_raw_secret_in_artifacts(artifacts: Mapping[str, object],
                               secrets: Iterable[str]) -> list:
    """No raw secret byte-sequence may appear in any durable artifact
    (journal bytes, child logs, incident bundles). ``artifacts`` maps a
    human-readable name to bytes/str content. Violations identify the
    secret by INDEX only — this oracle must not itself leak what it
    guards."""
    out = []
    secret_bytes = [s.encode() if isinstance(s, str) else bytes(s)
                    for s in secrets]
    for name, content in artifacts.items():
        blob = content.encode() if isinstance(content, str) else bytes(content)
        for i, raw in enumerate(secret_bytes):
            if raw and raw in blob:
                out.append(Violation(
                    "no_raw_secret_in_artifacts",
                    f"raw secret #{i} appears in artifact {name!r}",
                    {"artifact": str(name), "secret_index": i}))
    return out


__all__ = [
    "InvariantViolation",
    "Violation",
    "bitwise_parity_vs_reference",
    "check",
    "exactly_once_failover",
    "no_raw_secret_in_artifacts",
    "occupancy_drained",
    "occupancy_view",
    "single_decode_program",
    "terminal_uid_conservation",
    "zero_accepted_loss",
]
