"""Incident autopsy bundles: durable crash-correlated flight-recorder dumps
(a copy of ``deepspeed_tpu/telemetry/incident.py``; the port's
``utils/durability`` writes them).

When something operationally notable happens — a replica dead verdict, an
exactly-once failover, brownout engage/lift, a watchdog refusal, a journal
recovery, a NaN quarantine, a rolling-upgrade abort, an SLO fast-burn
breach — the snapshot-at-a-point-in-time surfaces (``telemetry_snapshot``,
``/metrics``) have already moved on by the time an operator looks. The
``IncidentRecorder`` captures the moment instead: a typed ``trigger()``
stages an incident, further triggers inside the capture window COALESCE
onto it (a SIGKILL's dead verdict and its failover storm are ONE incident,
not thirty), and once ``window_after_s`` of fleet time has passed the
owner's next ``tick()`` finalizes a durable JSON bundle:

    {schema: "dstpu-incident/1", source, kind, t_trigger, triggers: [...],
     + owner-provided context: ring window (telemetry/timeseries.py),
       merged request-trace events (Perfetto-able via ``to_perfetto``),
       fleet/replica state, autoscale + upgrade decision rings, journal
       cursor, SLO verdict}

Bundles are written with ``utils/durability.write_durable_bytes`` (tmp +
fsync + rename + dir fsync — a crash mid-write never leaves a torn bundle)
into a bounded directory: oldest bundles are LRU-pruned past
``max_bundles``, so incident storage is O(configured capacity) like every
other flight-recorder structure. ``telemetry/autopsy.py`` loads a bundle back
into a human-readable timeline; the gateway lists the directory on
``GET /debug/incidents``.

Single-threaded by design: ``trigger``/``tick`` run on the owning step or
serve loop only (the same thread discipline as the scheduler state they
capture), so there are no locks to order and no file IO under any lock.
Stdlib-only.
"""

from __future__ import annotations

import json
import os
import re
import time

from ..utils.durability import write_durable_bytes

SCHEMA = "dstpu-incident/1"

# typed trigger kinds (the trigger matrix docs/observability.md documents);
# unknown kinds are accepted but normalized — the recorder must never
# refuse to record because a new subsystem invented a name first
KINDS = (
    "replica_dead", "replica_hung", "failover", "brownout_engaged",
    "brownout_lifted", "watchdog_refusal", "journal_recovery",
    "nan_quarantine", "upgrade_abort", "slo_fast_burn",
)

_NAME_RE = re.compile(r"[^a-z0-9_]+")
_FILE_RE = re.compile(r"^incident-(\d{6})-([a-z0-9_]+)\.json$")


class IncidentRecorder:
    """Stage-and-finalize incident capture with bounded durable storage."""

    def __init__(self, dirpath: str, *, source: str = "router",
                 max_bundles: int = 32, window_before_s: float = 30.0,
                 window_after_s: float = 2.0, registry=None):
        if not dirpath:
            raise ValueError("IncidentRecorder needs a directory path")
        if max_bundles < 1:
            raise ValueError(f"max_bundles must be >= 1, got {max_bundles}")
        self.dir = dirpath
        self.source = str(source)
        self.max_bundles = int(max_bundles)
        self.window_before_s = float(window_before_s)
        self.window_after_s = float(window_after_s)
        self.registry = registry
        os.makedirs(self.dir, exist_ok=True)
        self._next_seq = 1 + max(
            (e[0] for e in self._scan()), default=-1)
        self._staged: dict | None = None

    # -- staging ---------------------------------------------------------

    def trigger(self, kind: str, now: float, **detail) -> bool:
        """Record a typed trigger at fleet time ``now``. Returns True when
        this trigger STAGED a new incident, False when it coalesced onto
        one already in its capture window."""
        kind = _NAME_RE.sub("_", str(kind).lower()) or "unknown"
        ev = {"kind": kind, "t": float(now), **detail}
        if self.registry is not None:
            self.registry.counter("incident/triggers").inc()
        if self._staged is not None:
            self._staged["triggers"].append(ev)
            return False
        self._staged = {"kind": kind, "t": float(now), "triggers": [ev]}
        return True

    @property
    def pending(self) -> bool:
        return self._staged is not None

    # -- finalize --------------------------------------------------------

    def tick(self, now: float, context=None) -> str | None:
        """Finalize the staged incident once its post-trigger window has
        elapsed on the fleet clock. ``context(staged, t0, t1)`` is the
        owner's capture callback (ring window, timelines, fleet state);
        its dict is merged into the bundle. Returns the bundle path when
        one was written this call."""
        st = self._staged
        if st is None or now < st["t"] + self.window_after_s:
            return None
        return self._finalize(st, context)

    def flush(self, context=None) -> str | None:
        """Force-finalize the staged incident NOW (fleet drain/close —
        a bundle must not be lost because the loop stopped ticking)."""
        st = self._staged
        if st is None:
            return None
        return self._finalize(st, context)

    def _finalize(self, st: dict, context) -> str | None:
        self._staged = None
        t0 = st["t"] - self.window_before_s
        t1 = st["t"] + self.window_after_s
        bundle = {
            "schema": SCHEMA,
            "source": self.source,
            "kind": st["kind"],
            "t_trigger": st["t"],
            # dstpu: allow[wall-clock-verdict] -- bundle stamps are cross-run operator correlation (like JSONL "t"), never compared against a deadline
            "wall_time": time.time(),
            "window": {"t0": t0, "t1": t1,
                       "before_s": self.window_before_s,
                       "after_s": self.window_after_s},
            "triggers": st["triggers"],
        }
        if context is not None:
            try:
                bundle.update(context(st, t0, t1) or {})
            # dstpu: allow[broad-except] -- capture is best-effort by contract: a context callback tripping over a half-dead replica must still yield a bundle with the trigger record, not no bundle
            except Exception as e:  # noqa: BLE001
                bundle["context_error"] = f"{type(e).__name__}: {e}"
        path = os.path.join(
            self.dir, f"incident-{self._next_seq:06d}-{st['kind']}.json")
        self._next_seq += 1
        try:
            write_durable_bytes(
                path, json.dumps(bundle, default=str).encode())
        except OSError:
            return None  # a full/readonly disk must not kill the serve loop
        if self.registry is not None:
            self.registry.counter("incident/bundles").inc()
        self._prune()
        return path

    # -- directory management --------------------------------------------

    def _scan(self) -> list[tuple[int, str, str]]:
        """[(seq, kind, filename)] for every bundle in the directory."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in names:
            m = _FILE_RE.match(n)
            if m:
                out.append((int(m.group(1)), m.group(2), n))
        return sorted(out)

    def _prune(self) -> None:
        entries = self._scan()
        for seq, kind, name in entries[:max(0, len(entries)
                                            - self.max_bundles)]:
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass  # prune is best-effort; retried next finalize

    def index(self) -> list[dict]:
        """Newest-first bundle listing (the ``/debug/incidents`` payload):
        filename-derived seq/kind plus file size, no JSON parsing — cheap
        enough for a gateway handler thread."""
        out = []
        for seq, kind, name in reversed(self._scan()):
            path = os.path.join(self.dir, name)
            try:
                size = os.stat(path).st_size
            except OSError:
                continue  # pruned between scan and stat
            out.append({"seq": seq, "kind": kind, "file": name,
                        "path": path, "bytes": size})
        return out

    @staticmethod
    def load(path: str) -> dict:
        """Parse one bundle (raises ValueError on a non-bundle file)."""
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict) or data.get("schema") != SCHEMA:
            raise ValueError(f"{path}: not a {SCHEMA} bundle")
        return data


__all__ = ["IncidentRecorder", "SCHEMA", "KINDS"]
