"""Durable request journal (the port of
``deepspeed_tpu/inference/journal.py``): the control plane's crash-safe
memory. Every request the Router ACCEPTS is journaled at the accept
boundary, every terminal result and cancel follows it, and a restarted
Router replays the journal to learn what it had promised before it
reconciles with the replicas that survived.

Record format, byte for byte the JAX package's, so a journal written by
either package replays in the other:

  * one record = a 12-byte header (``b"DSJR"``, the payload length, the
    payload's crc32; network byte order) + the UTF-8 JSON payload (compact
    separators). A TORN TAIL (a crash mid-append: a short header, or fewer
    payload bytes than the header promises, at the end of the file) is
    tolerated, counted and truncated by the next compaction; MID-FILE
    corruption (a complete record whose CRC fails, a magic mismatch, a
    payload that is not JSON) raises the typed ``JournalCorruptError``.
  * requests and results ride the RPC codec's wire dicts
    (``rpc.encode_request`` / ``encode_result``, numpy arrays as base64
    envelopes), so the state holds ENCODED payloads and the Router decodes
    only what it re-dispatches.

Record types (``{"t": ...}``): ``epoch`` (the fleet clock's wall-time
anchor, once per file: perf_counter epochs die with their process),
``submit`` (an accepted request and its idempotency key, written after
the dispatch succeeded and before ``submit`` returns), ``terminal`` (the
status and encoded result), ``cancel`` (replayed as a ``cancelled``
terminal when a crash ate the result record), ``idem`` (a compaction
artifact: a retained key -> uid mapping). Keys are opaque strings.

Durability: each append is flushed and fsync'd (``fsync: false`` trades
the last records for latency; replay still handles the torn tail), and a
compaction rewrites the file tmp + fsync + rename + directory fsync
(``utils/durability.py``). A failed append makes the journal FAIL-CLOSED
(``JournalUnavailableError`` on it and every later append): the mirror is
applied only after the frame is durable, so a restart replays exactly what
clients were promised.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

from ..resilience.errors import JournalCorruptError, JournalUnavailableError
from ..utils.durability import fsync_dir
from ..utils.logging import logger
from .rpc import encode_request, encode_result

_MAGIC = b"DSJR"
_HEADER = struct.Struct("!4sII")  # magic, payload length, payload crc32
_MAX_RECORD = 16 * 1024 * 1024  # a length past this is corruption, not data


@dataclass
class JournalState:
    """Everything a replay learns from one journal file. ``requests`` and
    ``terminals`` hold ENCODED payloads (the rpc codec's wire dicts) so
    building this state never imports torch; equality is plain field
    equality — the replay-idempotence contract (`replay(path)` twice
    yields equal states) is asserted directly on instances."""

    epoch_wall: Optional[float] = None
    requests: dict = field(default_factory=dict)     # uid -> encoded Request
    # uid -> idempotency key, live AND retained-terminal uids — the O(1)
    # reverse of ``idem`` (compaction walks terminals by uid)
    req_keys: dict = field(default_factory=dict)
    terminals: OrderedDict = field(default_factory=OrderedDict)
    #                               uid -> {"status", "res": enc|None}
    idem: dict = field(default_factory=dict)         # key -> uid
    records: int = 0                  # well-formed records replayed
    truncated_tail_bytes: int = 0     # torn-tail bytes dropped at replay

    def apply(self, rec: dict) -> None:
        """One record into the state — the same transition appends and
        replay use, so the in-memory mirror can never drift from what a
        replay of the file would produce."""
        t = rec.get("t")
        if t == "epoch":
            self.epoch_wall = float(rec["wall"])
        elif t == "submit":
            uid = int(rec["req"]["uid"])
            self.requests[uid] = rec["req"]
            key = rec.get("key")
            if key:
                self.req_keys[uid] = str(key)
                self.idem[str(key)] = uid
        elif t == "terminal":
            uid = int(rec["uid"])
            self.requests.pop(uid, None)
            # req_keys survives the terminal transition: the retained
            # terminal's key ages out WITH it at compaction
            # double-terminal replay is idempotent: last writer wins
            self.terminals.pop(uid, None)
            self.terminals[uid] = {"status": str(rec["status"]),
                                   "res": rec.get("res")}
        elif t == "cancel":
            uid = int(rec["uid"])
            if uid in self.requests and uid not in self.terminals:
                # the crash window between the cancel and its terminal
                # record: the user cancelled — never re-dispatch it
                self.requests.pop(uid, None)
                self.terminals[uid] = {"status": "cancelled", "res": None}
        elif t == "idem":
            self.idem[str(rec["key"])] = int(rec["uid"])
            self.req_keys[int(rec["uid"])] = str(rec["key"])
        # unknown record types are skipped (forward compatibility): the
        # CRC already proved the bytes are intact


def replay(path: str) -> JournalState:
    """Replay one journal file into a ``JournalState``. Pure function of
    the file bytes — replaying the same journal twice yields equal states
    (the idempotence contract). Torn tails are tolerated and counted;
    mid-file corruption raises ``JournalCorruptError``."""
    state = JournalState()
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return state
    size = len(data)
    off = 0
    while off < size:
        if off + _HEADER.size > size:
            state.truncated_tail_bytes = size - off  # torn mid-header
            break
        magic, length, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC or length > _MAX_RECORD:
            raise JournalCorruptError(
                f"journal {path}: bad record header at offset {off} "
                f"(magic={magic!r}, length={length}) — mid-file corruption, "
                f"not a torn tail", path=path, offset=off)
        end = off + _HEADER.size + length
        if end > size:
            state.truncated_tail_bytes = size - off  # torn mid-payload
            break
        payload = data[off + _HEADER.size:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise JournalCorruptError(
                f"journal {path}: record at offset {off} fails its crc32 "
                f"({length} bytes) — the durable record cannot be trusted",
                path=path, offset=off)
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            # crc passed but the payload is not the JSON we wrote: the
            # writer and reader disagree — corruption, not a torn tail
            raise JournalCorruptError(
                f"journal {path}: record at offset {off} is not valid "
                f"JSON ({e})", path=path, offset=off) from e
        state.apply(rec)
        state.records += 1
        off = end
    return state


class RequestJournal:
    """Append-only, crc32-framed, fsync'd journal of accepted requests.

    Construction replays any existing file (recovering the state a dead
    control plane left behind), then COMPACTS it — the durable rewrite
    truncates a torn tail and drops terminal bloat — and reopens for
    append. ``state`` is the live in-memory mirror (every append goes
    through ``JournalState.apply`` before it goes to disk, so mirror and
    file can never disagree on semantics).

    ``telemetry`` (optional): ``router/journal/appends`` and
    ``router/journal/rotations`` counters.

    Write-failure policy is FAIL-CLOSED: an append that cannot reach disk
    (ENOSPC, a failed fsync, or the injected ``io_error_journal_appends``
    key via ``injector``) marks the journal ``unavailable`` and raises a
    typed ``JournalUnavailableError`` — every later append refuses
    immediately with the same error. The in-memory mirror is applied only
    AFTER the frame is durably written, so on failure mirror == durable
    file exactly and a restart over the same path replays precisely what
    clients were promised. The accept path converts the error into a
    ``journal_unavailable`` rejection (503); un-journalable TERMINAL
    records are counted and incident-triggered but never crash the serve
    loop (the restart re-derives them from the workers).
    """

    def __init__(self, path: str, *, fsync: bool = True,
                 rotate_max_records: int = 4096, keep_terminals: int = 1024,
                 telemetry=None, injector=None):
        self.path = str(path)
        self.fsync = bool(fsync)
        self.rotate_max_records = int(rotate_max_records)
        self.keep_terminals = int(keep_terminals)
        self._tm = telemetry
        self._inj = injector
        self.unavailable = False
        self.state = replay(self.path)
        self.recovered = bool(self.state.requests or self.state.terminals)
        if self.state.truncated_tail_bytes:
            logger.warning(
                "request journal %s: truncated a torn tail of %d bytes "
                "(crash mid-append — expected artifact)",
                self.path, self.state.truncated_tail_bytes)
        if self.state.epoch_wall is None:
            # a FRESH journal anchors the fleet clock now; a recovered one
            # keeps the dead control plane's anchor so in-flight arrival
            # times and deadlines stay meaningful across the restart
            # dstpu: allow[wall-clock-verdict] -- the epoch anchor must survive a process restart, which perf_counter cannot; wall time is the only cross-process clock and nothing judges liveness on it
            self.state.epoch_wall = time.time()
        self._records_since_compact = 0
        self._f = None
        self.compact()  # durable rewrite: torn tail gone, epoch persisted

    # -- appends ---------------------------------------------------------

    def _append(self, rec: dict) -> None:
        if self.unavailable:
            raise JournalUnavailableError(
                f"request journal {self.path} is fail-closed after a write "
                f"failure; restart to replay the durable prefix",
                path=self.path)
        payload = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        frame = _MAGIC + struct.pack(
            "!II", len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
        try:
            if self._inj is not None:
                self._inj.journal_append(self.path)
            self._f.write(frame)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
        except OSError as e:
            # ENOSPC / injected permanent I/O error: fail closed. The
            # mirror was NOT applied, so mirror == durable file and a
            # restart over this path replays exactly what was promised.
            self.unavailable = True
            self.close()
            raise JournalUnavailableError(
                f"request journal {self.path}: append failed ({e}); "
                f"journal is fail-closed until restart",
                path=self.path) from e
        # apply only after the frame is durable — the one ordering under
        # which a failed append leaves no phantom state in the mirror
        self.state.apply(rec)
        if self._tm is not None:
            self._tm.counter("router/journal/appends").inc()
        self._records_since_compact += 1
        if self._records_since_compact > self.rotate_max_records:
            try:
                self.compact()
            except OSError as e:
                # the record above IS durable; only the rewrite failed —
                # but a full disk will fail the next append too, so the
                # same fail-closed verdict applies
                self.unavailable = True
                self.close()
                raise JournalUnavailableError(
                    f"request journal {self.path}: rotation failed ({e}); "
                    f"journal is fail-closed until restart",
                    path=self.path) from e
            if self._tm is not None:
                self._tm.counter("router/journal/rotations").inc()

    def record_submit(self, request, key: Optional[str] = None) -> None:
        """One ACCEPTED request — called after successful dispatch, before
        ``Router.submit`` returns the uid to its caller."""
        self._append({"t": "submit", "req": encode_request(request),
                      **({"key": str(key)} if key else {})})

    def record_terminal(self, uid: int, result=None,
                        status: Optional[str] = None) -> bool:
        """The uid's terminal record. Skips uids this journal never
        accepted (e.g. a shed submit's synthesized result) — there is
        nothing to recover for them. Returns whether a record landed."""
        uid = int(uid)
        if uid not in self.state.requests and uid not in self.state.terminals:
            return False
        self._append({
            "t": "terminal", "uid": uid,
            "status": str(status if status is not None else result.status),
            "res": None if result is None else encode_result(result)})
        return True

    def record_cancel(self, uid: int) -> None:
        uid = int(uid)
        if uid in self.state.requests:
            self._append({"t": "cancel", "uid": uid})

    # -- rotation / lifecycle -------------------------------------------

    def _iter_compact_records(self):
        yield {"t": "epoch", "wall": self.state.epoch_wall}
        for uid, enc in self.state.requests.items():
            key = self.state.req_keys.get(uid)
            yield {"t": "submit", "req": enc,
                   **({"key": key} if key else {})}
        for uid, t in self.state.terminals.items():
            yield {"t": "terminal", "uid": uid, "status": t["status"],
                   "res": t.get("res")}
            key = self.state.req_keys.get(uid)
            if key is not None:
                yield {"t": "idem", "key": key, "uid": uid}

    def compact(self) -> None:
        """Durable rewrite: live requests + the last ``keep_terminals``
        terminal records (+ their idempotency keys), tmp + fsync + rename +
        directory fsync — the checkpoint saver's rename discipline, so a
        crash mid-rotation reads either the old journal or the new one,
        never a torn hybrid."""
        if self._f is not None:
            self._f.close()
            self._f = None
        while len(self.state.terminals) > self.keep_terminals:
            uid, _ = self.state.terminals.popitem(last=False)
            # an evicted terminal's idempotency key ages out with it — a
            # retry past the window re-submits as a fresh request
            key = self.state.req_keys.pop(uid, None)
            if key is not None and self.state.idem.get(key) == uid:
                del self.state.idem[key]
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for rec in self._iter_compact_records():
                payload = json.dumps(rec, separators=(",", ":")).encode()
                f.write(_MAGIC + struct.pack(
                    "!II", len(payload),
                    zlib.crc32(payload) & 0xFFFFFFFF) + payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        fsync_dir(self.path)
        self._records_since_compact = 0
        self._f = open(self.path, "ab")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


__all__ = ["JournalState", "RequestJournal", "replay"]
