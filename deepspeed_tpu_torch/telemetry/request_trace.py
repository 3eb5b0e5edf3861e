"""Per-request lifecycle tracing: a bounded ring buffer of timeline events
(a copy of ``deepspeed_tpu/telemetry/request_trace.py``, which imports no jax).

The serving metrics answer "how is the fleet doing"; this module answers
"what happened to request 1347". Every stage transition a request goes
through — arrived -> admitted -> chunk k -> first_token -> decode ->
terminal, plus degradations (quarantine, failover) — is one host-side dict
appended to a ``collections.deque(maxlen=capacity)``: O(1), no device work,
and memory bounded no matter how long the engine serves. Each event carries
the recorder's ``replica_id``, so a Router-level merge of its own events
with every replica's reconstructs a fleet-wide timeline — a failed-over
request's trace shows BOTH replicas plus the router's ``failover`` edge.

Export paths:

  * ``events(uid=...)`` — query the buffer (scheduler-thread use only, like
    the rest of the serving host state).
  * ``telemetry_snapshot()`` embeds the buffer (key ``request_trace``) so
    the JSONL log can be queried offline (``request_timeline``).
  * ``to_perfetto(events)`` — Chrome-trace/Perfetto JSON (``traceEvents``):
    per-uid "X" slices for the queued/prefill/decode phases and "i"
    instants for chunks/faults; load in ui.perfetto.dev or
    chrome://tracing (docs/observability.md walks through it).

Timestamps are engine-epoch-relative seconds (the same clock every other
request timing uses), converted to microseconds in the Perfetto export.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable

# canonical stage order, used to sort same-timestamp events into a sane
# timeline and to pick the phase boundaries for the Perfetto slices.
# Gateway stages (launcher/http_gateway.py, stamped replica_id
# "gateway<id>") interleave at fractional ranks: http_accepted precedes
# the router's dispatch, stream_started follows the first token onto the
# wire, client_disconnected precedes the cancel's terminal event, and
# stream_done is the last thing a request's timeline can record.
_STAGE_ORDER = {
    "http_accepted": -1,
    "arrived": 0, "dispatched": 1, "requeued": 2, "admitted": 3,
    "prefix_hit": 4, "chunk": 5, "first_token": 6, "stream_started": 6.5,
    "stream_resumed": 6.6,
    "quarantine": 7, "failover": 8, "shed": 8.25,
    "client_disconnected": 8.5, "terminal": 9, "stream_done": 10,
}

# uids at/past this base are fleet infrastructure (the rolling upgrade's
# per-wave canary generates, inference/router.py), never user traffic —
# tracers skip them so timelines and Perfetto exports stay user-only.
# Disjoint by construction from gateway uid bands (gid << 32, gid < 2^17).
RESERVED_UID_BASE = 1 << 62


class RequestTracer:
    """Bounded per-request event recorder (one per scheduler/router)."""

    def __init__(self, capacity: int = 2048,
                 replica_id: int | str | None = None, clock=None):
        if capacity < 1:
            raise ValueError(f"request trace capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.replica_id = replica_id
        self._clock = clock  # () -> epoch-relative seconds; None = caller passes t
        self._buf: deque[dict] = deque(maxlen=self.capacity)
        self._seq = 0  # total events ever recorded (ring evicts, seq doesn't)

    def record(self, uid: int, event: str, t: float | None = None, **attrs) -> None:
        if uid >= RESERVED_UID_BASE:
            return  # infrastructure uids (upgrade canaries) are not traffic
        if t is None and self._clock is not None:
            t = self._clock()
        ev = {"uid": int(uid), "event": event, "t": float(t or 0.0)}
        if self.replica_id is not None:
            ev["replica_id"] = self.replica_id
        ev.update(attrs)
        self._buf.append(ev)
        self._seq += 1

    def events(self, uid: int | None = None) -> list[dict]:
        """Buffered events (oldest first), optionally for one uid."""
        if uid is None:
            return [dict(ev) for ev in self._buf]
        return [dict(ev) for ev in self._buf if ev["uid"] == uid]

    @property
    def seq(self) -> int:
        """Monotone count of events ever recorded — the cursor space for
        ``events_since``."""
        return self._seq

    def events_since(self, cursor: int, limit: int = 256) -> tuple[list[dict], int]:
        """Events recorded after ``cursor`` (a previous return's second
        element; 0 = from the start), at most ``limit`` of the OLDEST
        pending ones — the incremental-flush primitive: a serving worker
        piggybacks these on every ``step()`` reply so a replica that is
        later SIGKILL'd has already shipped its timeline to the router.
        Events evicted from the ring before being read are lost (the flush
        is bounded, not guaranteed). Returns ``(events, new_cursor)``."""
        buf = self._buf
        # buffer holds seq range [self._seq - len(buf), self._seq)
        skip = max(0, len(buf) - max(0, self._seq - int(cursor)))
        out = [dict(ev) for i, ev in enumerate(buf)
               if skip <= i < skip + max(0, int(limit))]
        return out, self._seq - max(0, len(buf) - skip - len(out))

    def __len__(self) -> int:
        return len(self._buf)


def sort_timeline(events: Iterable[dict]) -> list[dict]:
    """Chronological order with stage-rank tiebreak — merged multi-recorder
    traces (router + replicas) interleave correctly even when two clocks
    quantize to the same instant."""
    return sorted(events, key=lambda e: (e.get("t", 0.0),
                                         _STAGE_ORDER.get(e.get("event"), 99)))


def request_timeline(snapshot: dict, uid: int | None = None) -> list[dict]:
    """Pull every trace event out of a ``telemetry_snapshot()`` dict — the
    engine's own ``request_trace`` plus, for Router snapshots, the router's
    events and every replica's — merged and sorted. Pure dict walking (the
    no device work)."""
    evs: list[dict] = []
    evs.extend(snapshot.get("request_trace") or [])
    rt = snapshot.get("router")
    if isinstance(rt, dict):
        evs.extend(rt.get("request_trace") or [])
    gw = snapshot.get("gateway")
    if isinstance(gw, dict):
        # HTTP front-door stages (http_accepted/stream_*/client_
        # disconnected) merge onto the same per-uid timeline, stamped
        # with the gateway's id (launcher/http_gateway.py)
        evs.extend(gw.get("request_trace") or [])
    for rid, rep in (snapshot.get("replicas") or {}).items():
        for ev in rep.get("request_trace") or []:
            ev = dict(ev)
            ev.setdefault("replica_id", rid)
            evs.append(ev)
    if uid is not None:
        evs = [e for e in evs if e.get("uid") == uid]
    return sort_timeline(evs)


def _pid(ev: dict) -> int:
    rid = ev.get("replica_id")
    if isinstance(rid, int):
        return rid
    if rid is None:
        return 0
    # router / string ids: stable small ints out of the name
    return (hash(str(rid)) & 0x7FFF) | 0x8000


def to_perfetto(events: Iterable[dict]) -> dict:
    """Chrome-trace JSON (the ``traceEvents`` array format Perfetto and
    chrome://tracing load). Per uid: complete ("X") slices for
    queued (arrived->admitted), prefill (admitted->first_token) and
    decode (first_token->terminal), attributed to the replica (pid) that
    recorded the closing event; instant ("i") marks for chunks, quarantines
    and failovers. Timestamps are microseconds."""
    by_uid: dict[int, list[dict]] = {}
    for ev in events:
        by_uid.setdefault(ev["uid"], []).append(ev)
    trace: list[dict] = []
    for uid, evs in sorted(by_uid.items()):
        evs = sort_timeline(evs)
        marks: dict[str, dict] = {}
        for ev in evs:
            name = ev["event"]
            if name in ("arrived", "dispatched", "admitted", "first_token",
                        "terminal") and name not in marks:
                marks[name] = ev
            if name in ("chunk", "quarantine", "failover", "requeued",
                        "prefix_hit"):
                args = {k: v for k, v in ev.items()
                        if k not in ("uid", "event", "t", "replica_id")}
                trace.append({
                    "name": name, "ph": "i", "s": "t",
                    "ts": round(ev["t"] * 1e6, 3),
                    "pid": _pid(ev), "tid": uid, "args": args,
                })
        start = marks.get("arrived") or marks.get("dispatched")
        phases = (("queued", start, marks.get("admitted")),
                  ("prefill", marks.get("admitted"), marks.get("first_token")),
                  ("decode", marks.get("first_token"), marks.get("terminal")))
        for name, a, b in phases:
            if a is None or b is None:
                continue
            trace.append({
                "name": name, "ph": "X",
                "ts": round(a["t"] * 1e6, 3),
                "dur": round(max(b["t"] - a["t"], 0.0) * 1e6, 3),
                "pid": _pid(b), "tid": uid,
                "args": {"uid": uid,
                         **({"status": marks["terminal"].get("status")}
                            if name == "decode" and "terminal" in marks else {})},
            })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


__all__ = ["RequestTracer", "request_timeline", "sort_timeline", "to_perfetto"]
