"""Serving RPC (the port of ``deepspeed_tpu/inference/rpc.py``): the
Router's scheduler contract over a process boundary, so that a replica
may be a worker process (``launcher/serving_worker.py``) whose crash is a
vanished address space and whose hang gives the caller nothing at all.

Address families, one frame layer: ``AF_UNIX`` (a socket path, same-host
workers) and ``AF_INET`` (``tcp://host:port``). TCP sockets run
``TCP_NODELAY`` (a step call is one small frame each way), and the
injected ``rpc_conn_reset`` site closes with ``SO_LINGER(0)`` so the peer
sees a genuine RST.

Wire format, byte for byte the JAX package's, so either package's client
talks to either's server:

  * one frame = a 12-byte header (``b"DSRP"``, the payload length, the
    payload's crc32; network byte order) + the UTF-8 JSON payload (compact
    separators). Magic and CRC make corruption and desynchronisation a
    typed ``RpcGarbledFrame``.
  * numpy arrays (prompts, tokens) ride as ``{"__nd__": base64, "dtype",
    "shape"}``.
  * requests are ``{"id", "method", "kwargs"}``; replies ``{"id", "ok":
    true, "result"}`` or ``{"id", "ok": false, "error": <type name>,
    "message", ...}``. ``RequestRejected`` and ``ValueError`` are re-raised
    natively on the client; anything else is ``RpcRemoteError``.

Failure semantics (what the Router's verdicts key on): ``RpcTimeout`` (no
complete reply inside the per-call deadline; the call MAY have executed:
a HUNG verdict, never retried), ``RpcConnectionLost`` (refused, reset or
closed: a SIGKILL'd worker; DEAD; reconnects pay the bounded backoff of
``resilience/retry.py``), ``RpcGarbledFrame`` (the socket is closed).

``ReplicaClient`` is the full scheduler surface the Router drives, so a
Router cannot tell a worker from an in-process engine. ``step`` and
``withdraw`` are retried once through a reconnect on a lost connection or
a garbled frame, because the worker makes them replay-safe (terminal uids
stay unacked until the next step acknowledges them; withdrawn requests are
cached per uid); ``submit`` is never retried (a maybe-landed request would
fork one uid across two replicas). Deadlines, backoff and heartbeats use
``time.monotonic()``.

The disaggregated handoff's KV windows (``encode_kv_window``: raw, or
``int8`` with one absmax scale per tensor) ride the same codec. A bf16
window is a ``torch.bfloat16`` tensor on the host and travels as its raw
2-byte payload labelled ``"dtype": "bfloat16"``, byte for byte the JAX
package's frame of an ``ml_dtypes`` array, and decodes back to a
``torch.bfloat16`` tensor: no path needs ``ml_dtypes``. The int8
arithmetic is the JAX package's: the scale ``max|a| / 127`` in double,
the division in float32, round half to even.

Stdlib + numpy at import; ``torch`` is imported lazily for bf16 windows,
``Request``/``RequestResult`` lazily by the codec.
"""

from __future__ import annotations

import base64
import json
import socket
import struct
import sys
import time
import zlib
from collections import Counter, deque
from typing import Any, Optional

import numpy as np

from ..resilience.errors import (RequestRejected, RpcConnectionLost, RpcError,
                                 RpcGarbledFrame, RpcRemoteError, RpcTimeout)
from ..resilience.faults import FaultInjector
from ..resilience.retry import RetryPolicy, backoff_delay
from ..runtime.config import RouterTransportConfig

_MAGIC = b"DSRP"
_HEADER = struct.Struct("!4sII")  # magic, payload length, payload crc32
_MAX_FRAME = 64 * 1024 * 1024  # a length past this is desync, not data


def parse_address(addr) -> tuple[str, object]:
    """``(family, target)`` for an RPC endpoint: a ``tcp://host:port``
    string (or ``(host, port)`` pair) is the TCP family; any other string
    is an AF_UNIX socket path."""
    if isinstance(addr, (tuple, list)):
        return "tcp", (str(addr[0]), int(addr[1]))
    s = str(addr)
    if s.startswith("tcp://"):
        host, _, port = s[len("tcp://"):].rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"malformed tcp address {s!r} "
                             "(want tcp://host:port)")
        return "tcp", (host, int(port))
    return "unix", s


def format_address(family: str, target) -> str:
    if family == "tcp":
        return f"tcp://{target[0]}:{target[1]}"
    return str(target)


# -- value codec ------------------------------------------------------------

def _is_tensor(x) -> bool:
    # without importing torch: no tensor exists before torch is imported
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _dtype_name(x) -> str:
    """numpy's name of an array's dtype; a torch tensor's spelled the same
    way (``torch.bfloat16`` -> ``"bfloat16"``, as ``ml_dtypes`` names it)."""
    if _is_tensor(x):
        return str(x.dtype).rsplit(".", 1)[-1]
    return str(np.asarray(x).dtype)


def _tensor_bytes(t) -> bytes:
    """A host tensor's raw payload; a bf16 one through its int16 view
    (numpy has no bf16 without ``ml_dtypes``)."""
    import torch

    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_bf16_bytes(raw: bytes, shape):
    import torch

    if not raw:
        return torch.empty(tuple(shape), dtype=torch.bfloat16)
    return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(tuple(shape))


def _enc_value(x):
    if isinstance(x, np.ndarray):
        a = np.ascontiguousarray(x)
        return {"__nd__": base64.b64encode(a.tobytes()).decode("ascii"),
                "dtype": str(a.dtype), "shape": list(a.shape)}
    if _is_tensor(x):
        return {"__nd__": base64.b64encode(_tensor_bytes(x)).decode("ascii"),
                "dtype": _dtype_name(x), "shape": list(x.shape)}
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (list, tuple)):
        return [_enc_value(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _enc_value(v) for k, v in x.items()}
    return x


def _dec_value(x):
    if isinstance(x, dict):
        if "__nd__" in x:
            raw = base64.b64decode(x["__nd__"])
            if x["dtype"] == "bfloat16":
                return _from_bf16_bytes(raw, x["shape"])
            return np.frombuffer(raw, dtype=np.dtype(x["dtype"])).reshape(
                x["shape"]).copy()
        return {k: _dec_value(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_dec_value(v) for v in x]
    return x


def encode_request(req) -> dict:
    """``serving.Request`` -> wire dict (duck-typed: any object with the
    Request fields encodes)."""
    return {
        "uid": int(req.uid),
        "prompt": _enc_value(np.asarray(req.prompt, np.int32)),
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": float(req.temperature),
        "top_k": int(req.top_k),
        "top_p": float(req.top_p),
        "eos_token": None if req.eos_token is None else int(req.eos_token),
        "arrival_time": float(req.arrival_time),
        "deadline_s": float(req.deadline_s),
        "priority": int(getattr(req, "priority", 0)),
        "tenant": str(getattr(req, "tenant", "")),
    }


def decode_request(d: dict):
    from .serving import Request  # lazy: serving pulls torch

    d = dict(d)
    d["prompt"] = _dec_value(d["prompt"])
    return Request(**d)


def encode_result(res) -> dict:
    """``serving.RequestResult`` -> wire dict."""
    return {
        "uid": int(res.uid),
        "tokens": _enc_value(np.asarray(res.tokens, np.int32)),
        "prompt_len": int(res.prompt_len),
        "arrival_time": float(res.arrival_time),
        "admitted_time": float(res.admitted_time),
        "first_token_time": float(res.first_token_time),
        "finish_time": float(res.finish_time),
        "slot": int(res.slot),
        "prefix_hit_tokens": int(res.prefix_hit_tokens),
        "status": str(res.status),
        "requeues": int(res.requeues),
    }


def decode_result(d: dict):
    from .serving import RequestResult  # lazy: serving pulls torch

    d = dict(d)
    d["tokens"] = _dec_value(d["tokens"])
    return RequestResult(**d)


# -- KV wire codec (disaggregated handoff) ----------------------------------
#
# The handoff streams slot-KV windows (``ServingEngine.kv_export_window``:
# host ``[L, 1, width, H, Dh]`` k and v) from a prefill replica into a
# decode replica. ``kv_compression="int8"`` (serving.router.disagg) applies
# the JAX package's absmax discipline: one scale per tensor, symmetric
# round to nearest even, a quarter of fp32's bytes and half of bf16's.
# Greedy parity holds only with compression off.

def _as_f32(a) -> np.ndarray:
    """A window as float32 numpy (exact for bf16 and fp16)."""
    if _is_tensor(a):
        return a.detach().to("cpu").float().numpy()
    return np.asarray(a, np.float32)


def quantize_int8(a) -> tuple[np.ndarray, float]:
    """fp array or host tensor -> (int8 array, scale) with symmetric absmax
    scaling: the scale ``max|a| / 127`` in double, ``a / scale`` in float32
    (what numpy computes for an ``ml_dtypes`` bf16 array divided by a
    Python float), then round half to even."""
    a = _as_f32(a)
    scale = float(np.max(np.abs(a))) / 127.0 if a.size else 0.0
    if scale == 0.0:
        return np.zeros(a.shape, np.int8), 0.0
    return np.clip(np.rint(a / scale), -127, 127).astype(np.int8), scale


def dequantize_int8(q: np.ndarray, scale: float, dtype="float32"):
    """int8 array -> ``q * scale`` in float32, then rounded to ``dtype``
    (a name or numpy dtype); ``"bfloat16"`` gives a ``torch.bfloat16``
    tensor."""
    out = np.asarray(q, np.float32) * float(scale)
    if str(dtype) == "bfloat16":
        import torch

        return torch.from_numpy(out).to(torch.bfloat16)
    return out.astype(np.dtype(dtype))


def encode_kv_window(k, v, compression: str = "none") -> dict:
    if compression == "int8":
        qk, sk = quantize_int8(k)
        qv, sv = quantize_int8(v)
        return {"codec": "int8", "dtype": _dtype_name(k),
                "k": _enc_value(qk), "v": _enc_value(qv),
                "k_scale": sk, "v_scale": sv}
    return {"codec": "raw", "k": _enc_value(k if _is_tensor(k) else np.asarray(k)),
            "v": _enc_value(v if _is_tensor(v) else np.asarray(v))}


def decode_kv_window(d: dict):
    """An encoded window (or one that crossed the wire) -> host ``(k, v)``:
    numpy arrays, or ``torch.bfloat16`` tensors for a bf16 window."""
    if d.get("codec") == "int8":
        dt = d.get("dtype", "float32")
        return (dequantize_int8(_dec_value(d["k"]), d["k_scale"], dt),
                dequantize_int8(_dec_value(d["v"]), d["v_scale"], dt))
    return _dec_value(d["k"]), _dec_value(d["v"])


def _itemsize(name: str) -> int:
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def kv_window_nbytes(d: dict) -> tuple[int, int]:
    """(wire_bytes, raw_bytes) of an encoded KV window: wire is the array
    payload, raw is the uncompressed fp equivalent; their difference feeds
    the bytes-saved counter. A freshly encoded window carries ``{"__nd__":
    b64}`` markers, one that crossed the wire decoded arrays (or bf16
    tensors)."""
    def _nbytes(x):
        if isinstance(x, np.ndarray):
            return x.nbytes
        if _is_tensor(x):
            return x.numel() * x.element_size()
        return (len(x["__nd__"]) * 3) // 4
    wire = sum(_nbytes(d[key]) for key in ("k", "v"))
    if d.get("codec") == "int8":
        return wire, wire * _itemsize(d.get("dtype", "float32"))
    return wire, wire

# -- frame layer ------------------------------------------------------------

def send_frame(sock: socket.socket, obj: Any) -> None:
    payload = json.dumps(_enc_value(obj), separators=(",", ":"),
                         default=str).encode("utf-8")
    sock.sendall(_MAGIC + struct.pack(
        "!II", len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload)


def _recv_exact(sock: socket.socket, n: int, deadline: Optional[float]) -> bytes:
    chunks = []
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RpcTimeout(f"deadline elapsed with {n - got} bytes pending")
            sock.settimeout(remaining)
        try:
            chunk = sock.recv(min(1 << 16, n - got))
        except socket.timeout as e:  # noqa: PERF203 — typed surface
            raise RpcTimeout(f"recv timed out with {n - got} bytes pending") from e
        if not chunk:
            raise RpcConnectionLost("peer closed the connection mid-frame"
                                    if got else "peer closed the connection")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket, timeout: Optional[float] = None) -> Any:
    """One frame, decoded. ``timeout`` is a PER-FRAME budget on a monotonic
    deadline (header and payload together); None blocks forever."""
    deadline = None if timeout is None else time.monotonic() + timeout
    head = _recv_exact(sock, _HEADER.size, deadline)
    magic, length, crc = _HEADER.unpack(head)
    if magic != _MAGIC or length > _MAX_FRAME:
        raise RpcGarbledFrame(
            f"bad frame header (magic={magic!r}, length={length})")
    payload = _recv_exact(sock, length, deadline)
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise RpcGarbledFrame(f"payload crc mismatch ({length} bytes)")
    # symmetric with send_frame: ndarray envelopes come back as arrays
    return _dec_value(json.loads(payload.decode("utf-8")))


# -- server -----------------------------------------------------------------

class RpcServer:
    """Single-threaded RPC server (the worker side) over a unix socket
    path or a ``tcp://host:port`` address (port 0 = OS-assigned; the
    resolved address is ``self.address``, printed in the worker's ready
    line so a supervisor can discover ephemeral ports).

    ``handlers`` maps method name -> callable(**kwargs). One frame is one
    dispatch; handler exceptions become error replies (the worker process
    survives a bad call — only the OS can kill it). ``serve_forever`` polls
    ``should_stop`` between frames so a SIGTERM flag (PreemptionGuard) is
    honored at a frame boundary, and calls ``on_tick`` each loop (the
    worker touches its heartbeat file there)."""

    def __init__(self, address, handlers: dict):
        self.family, target = parse_address(address)
        self.handlers = dict(handlers)
        if self.family == "tcp":
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind(target)
            host, port = self._listener.getsockname()[:2]
            self.address = format_address("tcp", (host, port))
        else:
            import os

            try:
                os.unlink(target)
            except OSError:
                pass
            self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._listener.bind(target)
            self.address = target
        # the historical attribute name; tcp servers expose the resolved
        # tcp://host:port here too (callers build clients from it)
        self.path = self.address
        self._listener.listen(8)
        self._clients: list[socket.socket] = []
        self.frames_served = 0

    def _reply_error(self, sock, req_id, exc: BaseException) -> None:
        err = {"id": req_id, "ok": False,
               "error": type(exc).__name__, "message": str(exc)}
        if isinstance(exc, RequestRejected):
            err["uid"] = exc.uid
            err["reason"] = exc.reason
        send_frame(sock, err)

    def _dispatch(self, sock) -> bool:
        """Serve one frame from ``sock``; False when the client is gone."""
        try:
            req = recv_frame(sock, timeout=30.0)
        except (RpcError, OSError):
            return False
        req_id = req.get("id") if isinstance(req, dict) else None
        try:
            fn = self.handlers[req["method"]]
            result = fn(**(req.get("kwargs") or {}))
        except BaseException as e:  # noqa: BLE001 — worker must survive bad calls
            try:
                self._reply_error(sock, req_id, e)
            except OSError:
                return False
            if not isinstance(e, Exception):
                raise  # KeyboardInterrupt/SystemExit propagate after reply
            return True
        try:
            send_frame(sock, {"id": req_id, "ok": True, "result": result})
        except OSError:
            return False
        self.frames_served += 1
        return True

    def serve_forever(self, should_stop=None, on_tick=None,
                      poll_s: float = 0.05) -> None:
        import select

        while True:
            if on_tick is not None:
                on_tick()
            if should_stop is not None and should_stop():
                return
            ready, _, _ = select.select(
                [self._listener] + self._clients, [], [], poll_s)
            for sock in ready:
                if sock is self._listener:
                    conn, _ = self._listener.accept()
                    if self.family == "tcp":
                        # one small frame each way per call: Nagle's ACK
                        # delay would serialize every router step on it
                        conn.setsockopt(socket.IPPROTO_TCP,
                                        socket.TCP_NODELAY, 1)
                    self._clients.append(conn)
                    continue
                if not self._dispatch(sock):
                    self._clients.remove(sock)
                    try:
                        sock.close()
                    except OSError:
                        pass

    def close(self) -> None:
        for s in self._clients:
            try:
                s.close()
            except OSError:
                pass
        self._clients.clear()
        try:
            self._listener.close()
        except OSError:
            pass


# -- client -----------------------------------------------------------------

class RpcClient:
    """RPC client (unix path or ``tcp://host:port``) with per-call
    deadlines, bounded-backoff reconnect, per-method call clocks (the
    transport fault sites key on them), and host-side transport stats."""

    def __init__(self, path, *,
                 transport: RouterTransportConfig | None = None,
                 fault_injection=None, seed: int = 0, telemetry=None):
        self._family, self._target = parse_address(path)
        self.path = format_address(self._family, self._target)
        self.transport = transport or RouterTransportConfig()
        self._reconnect_policy = RetryPolicy(
            max_attempts=int(self.transport.connect_attempts),
            base_delay_s=float(self.transport.base_delay_s),
            max_delay_s=float(self.transport.max_delay_s),
            jitter=float(self.transport.jitter))
        self._seed = int(seed)
        if fault_injection is not None and not isinstance(
                fault_injection, FaultInjector):
            fault_injection = FaultInjector(fault_injection)
        self._inj: Optional[FaultInjector] = (
            fault_injection if (fault_injection is not None
                                and fault_injection.enabled) else None)
        self._tm = telemetry
        self._sock: Optional[socket.socket] = None
        self._ever_connected = False
        self._next_id = 0
        self._calls: Counter = Counter()  # per-method call clock (1-based)
        self.stats: Counter = Counter()
        self._lat_sum = 0.0
        self._lat_max = 0.0

    # -- connection management ------------------------------------------

    def bind_telemetry(self, telemetry) -> None:
        """Mirror transport counters/latency into a ``Telemetry`` bundle
        (the Router binds its own at fleet assembly, so ``rpc/*`` metrics
        land in the fleet registry)."""
        self._tm = telemetry

    def _count(self, name: str, n: int = 1) -> None:
        self.stats[name] += n
        if self._tm is not None:
            self._tm.counter(f"rpc/{name}").inc(n)

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def connect(self) -> None:
        """Connect (or reconnect) with the bounded-backoff schedule; raises
        ``RpcConnectionLost`` once attempts are exhausted."""
        if self._sock is not None:
            return
        p = self._reconnect_policy
        last: Optional[Exception] = None
        for attempt in range(1, max(1, p.max_attempts) + 1):
            if attempt > 1:
                time.sleep(backoff_delay(attempt - 1, p, seed=self._seed))
            family = (socket.AF_INET if self._family == "tcp"
                      else socket.AF_UNIX)
            s = socket.socket(family, socket.SOCK_STREAM)
            s.settimeout(max(0.05, float(self.transport.call_timeout_s)))
            try:
                s.connect(self._target)
            except OSError as e:
                last = e
                s.close()
                continue
            if self._family == "tcp":
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            if self._ever_connected:
                self._count("reconnects")
            self._ever_connected = True
            return
        raise RpcConnectionLost(
            f"connect to {self.path} failed after {p.max_attempts} "
            f"attempts: {last}")

    def _drop(self, rst: bool = False) -> None:
        if self._sock is not None:
            if rst and self._family == "tcp":
                # the TCP flavor of the injected conn-reset site: linger-0
                # close sends a genuine RST, so the remote sees the abortive
                # reset a yanked cable / kill -9 host produces — not a
                # graceful FIN half-close
                try:
                    self._sock.setsockopt(
                        socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
                except OSError:
                    pass
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        """Permanently close — every later call fails fast with
        ``RpcConnectionLost`` (the Router closes a DEAD replica's client so
        snapshots and cancels cannot hang on reconnect backoff)."""
        self._drop()
        self._closed = True

    # -- calls -----------------------------------------------------------

    def _call_once(self, method: str, kwargs: dict,
                   timeout: Optional[float]) -> Any:
        if getattr(self, "_closed", False):
            raise RpcConnectionLost(f"client for {self.path} is closed")
        self.connect()
        n = self._calls[method] + 1
        self._calls[method] = n
        self._next_id += 1
        frame = {"id": self._next_id, "method": method, "kwargs": kwargs}
        t0 = time.monotonic()
        budget = (float(self.transport.call_timeout_s)
                  if timeout is None else float(timeout))
        try:
            send_frame(self._sock, frame)
            reply = recv_frame(self._sock, timeout=budget)
        except RpcTimeout:
            # the stream may hold a late (or partially read) reply — it is
            # DESYNCED: keeping the socket would hand the next call this
            # call's reply. Drop it; the next call pays a clean reconnect.
            self._count("timeouts")
            self._drop()
            raise
        except RpcGarbledFrame:
            # the stream is desynced — a later frame would be misparsed
            self._count("garbled_frames")
            self._drop()
            raise
        except (RpcConnectionLost, OSError) as e:
            self._count("conn_resets")
            self._drop()
            if isinstance(e, RpcConnectionLost):
                raise
            raise RpcConnectionLost(f"{method}: {e}") from e
        if not isinstance(reply, dict) or reply.get("id") != frame["id"]:
            # a reply for a DIFFERENT call means the stream desynced at
            # some earlier point (e.g. a stale reply survived somewhere) —
            # never return it as this call's result
            self._count("garbled_frames")
            self._drop()
            raise RpcGarbledFrame(
                f"{method}: reply id {reply.get('id') if isinstance(reply, dict) else reply!r} "
                f"!= request id {frame['id']} (desynced stream)")
        # injected transport faults — applied AFTER the reply so the remote
        # side HAS executed the call: the lost-reply ambiguity is the case
        # the exactly-once failover contract must survive
        if self._inj is not None:
            if self._inj.rpc_conn_reset(method, n):
                self._count("conn_resets")
                self._count("injected_faults")
                self._drop(rst=True)  # tcp: abortive RST, not graceful FIN
                raise RpcConnectionLost(
                    f"fault injection: rpc_conn_reset on {method} #{n}")
            if self._inj.rpc_timeout(method, n):
                self._count("timeouts")
                self._count("injected_faults")
                raise RpcTimeout(
                    f"fault injection: rpc_timeout on {method} #{n}")
            if self._inj.rpc_garbled_frame(method, n):
                self._count("garbled_frames")
                self._count("injected_faults")
                self._drop()
                raise RpcGarbledFrame(
                    f"fault injection: rpc_garbled_frame on {method} #{n}")
        dt = time.monotonic() - t0
        self._count("calls")
        self._lat_sum += dt
        self._lat_max = max(self._lat_max, dt)
        if self._tm is not None:
            self._tm.histogram("rpc/call_sec").observe(dt)
        if not reply.get("ok"):
            err, msg = reply.get("error", "Exception"), reply.get("message", "")
            if err == "RequestRejected":
                raise RequestRejected(int(reply.get("uid", -1)),
                                      str(reply.get("reason", "unknown")), msg)
            if err == "ValueError":
                raise ValueError(msg)
            raise RpcRemoteError(err, msg)
        return reply.get("result")

    def call(self, method: str, *, timeout: Optional[float] = None,
             retry_safe: bool = False, **kwargs) -> Any:
        """One RPC. ``retry_safe=True`` retries ONCE through a reconnect on
        connection loss or a garbled frame — only for methods the worker
        makes replay-safe (step/withdraw/queries). Timeouts are never
        retried: the deadline is the Router's hung-verdict budget."""
        try:
            return self._call_once(method, kwargs, timeout)
        except (RpcConnectionLost, RpcGarbledFrame):
            if not retry_safe or getattr(self, "_closed", False):
                raise
            self._count("retries")
            return self._call_once(method, kwargs, timeout)

    def rpc_stats(self) -> dict:
        """Transport counters + latency aggregates for fleet snapshots."""
        out = dict(self.stats)
        calls = max(1, out.get("calls", 0))
        out["call_sec_mean"] = round(self._lat_sum / calls, 6)
        out["call_sec_max"] = round(self._lat_max, 6)
        return out


# -- the Router-facing replica adapter --------------------------------------

class ReplicaClient:
    """The scheduler surface of one remote ``ServingEngine`` (hosted by
    ``launcher/serving_worker.py``), over ``RpcClient``.

    Mirrors everything ``inference/router.py`` reads from an in-process
    replica. State the Router polls between steps (``load``, ``idle``,
    ``queue_len``, ``last_step_compiled``, ``pending_arrival_times``) is
    served from a cache refreshed by every submit/step reply — a health
    poll must never block on (or be failed by) the transport. Queries that
    gate dispatch decisions (``arrived_queue_len``, ``prefix_match_len``,
    ``live_requests``) go to the wire and degrade to their cached/neutral
    values on transport failure: the STEP is where verdicts are earned.

    ``step()`` piggybacks, in one round trip: terminal uids (cumulative
    until acked — a reply lost to a reset is recovered by the retry, and
    the Router's ``_collect`` dedups), their full encoded results, the
    replica's request-trace flush (the killed-worker timeline satellite),
    and the load/idle/queue state refresh."""

    def __init__(self, path: str, *, replica_id: int | str | None = None,
                 transport: RouterTransportConfig | None = None,
                 fault_injection=None, seed: int = 0, telemetry=None):
        self.rpc = RpcClient(path, transport=transport,
                             fault_injection=fault_injection, seed=seed,
                             telemetry=telemetry)
        self.replica_id = replica_id
        # serving role of the remote engine ("prefill"/"decode"/"both");
        # refreshed from ping() — the Router's role-aware dispatch reads it
        self.role = "both"
        self._load = 0
        self._idle = True
        self._queue_len = 0
        self._arrived = 0
        self._occupancy = 0.0
        self._pending: list[float] = []
        self._compiled = False
        self._results: dict[int, object] = {}  # uid -> decoded RequestResult
        self._trace_flush: deque = deque(maxlen=4096)
        self._ring_flush: deque = deque(maxlen=4096)
        self._ack: list[int] = []  # terminal uids to acknowledge next step
        # per-uid tokens-so-far, replaced whole by every step reply: the
        # gateway's SSE streams read this cache (partial_tokens), so
        # streaming costs no extra round trip. Opt-in (``stream_progress``,
        # set by Router.enable_stream_progress): other fleets skip the wire
        # cost of re-sending each stream's tokens every step
        self.stream_progress = False
        self._progress: dict[int, list[int]] = {}
        # last piggybacked speculative-decoding stats block ("spec" on the
        # step reply; None until the worker reports one / feature off).
        # Kept across a replica death so the fleet aggregate still counts
        # the dead worker's accepted tokens.
        self._spec: Optional[dict] = None
        # prefill-role workers piggyback their parked prefill-complete
        # requests ("handoff" on the step reply), so the Router's handoff
        # pump needs no polling round trip
        self._handoff_ready: list[dict] = []

    # -- connection / identity ------------------------------------------

    def bind_telemetry(self, telemetry) -> None:
        self.rpc.bind_telemetry(telemetry)

    def connect(self) -> None:
        self.rpc.connect()

    def close(self) -> None:
        self.rpc.close()

    def ping(self) -> dict:
        reply = self.rpc.call("ping", retry_safe=True)
        if isinstance(reply, dict) and "role" in reply:
            self.role = str(reply["role"])
        return reply

    def rpc_stats(self) -> dict:
        return self.rpc.rpc_stats()

    def _refresh(self, state: dict) -> None:
        if "load" in state:
            self._load = int(state["load"])
        if "idle" in state:
            self._idle = bool(state["idle"])
        if "queue_len" in state:
            self._queue_len = int(state["queue_len"])
        if "arrived" in state:
            self._arrived = int(state["arrived"])
        if "occupancy" in state:
            self._occupancy = float(state["occupancy"])
        if "pending" in state:
            self._pending = [float(t) for t in state["pending"]]

    # -- scheduler surface ----------------------------------------------

    def submit(self, request) -> int:
        reply = self.rpc.call("submit", request=encode_request(request))
        self._refresh(reply)
        return int(reply["uid"])

    def requeue(self, request) -> int:
        # replay-safe: the worker treats a re-delivered live uid as success
        reply = self.rpc.call("requeue", request=encode_request(request),
                              retry_safe=True)
        self._refresh(reply)
        return int(reply["uid"])

    def withdraw(self, uid: int):
        # replay-safe: the worker caches the withdrawn request per uid, so
        # a retried call returns the SAME request instead of None (a lost
        # reply must not strand a drain migration)
        reply = self.rpc.call("withdraw", uid=int(uid), retry_safe=True)
        self._refresh(reply)
        req = reply.get("request")
        return None if req is None else decode_request(req)

    def cancel(self, uid: int) -> bool:
        try:
            # short deadline: the Router's hung-verdict path cancels every
            # live request on a replica that may be wedged — n cancels must
            # not serialize n full call timeouts
            reply = self.rpc.call(
                "cancel", uid=int(uid),
                timeout=min(5.0, float(self.rpc.transport.call_timeout_s)))
        except RpcError:
            return False  # best-effort, like the Router's hung-path cancels
        self._refresh(reply)
        if reply.get("result") is not None:
            self._results[int(uid)] = decode_result(reply["result"])
        return bool(reply["cancelled"])

    def result(self, uid: int):
        uid = int(uid)
        if uid in self._results:
            return self._results[uid]
        try:
            enc = self.rpc.call("result", uid=uid, retry_safe=True)
        except RpcError:
            return None
        if enc is None:
            return None
        res = decode_result(enc)
        self._results[uid] = res
        return res

    def step(self, now: float | None = None, *,
             enforce_deadlines: bool = True) -> list[int]:
        reply = self.rpc.call(
            "step", now=now, enforce_deadlines=bool(enforce_deadlines),
            ack=self._ack, progress=bool(self.stream_progress),
            retry_safe=True)
        self._ack = []
        self._refresh(reply)
        self._compiled = bool(reply.get("compiled"))
        for k, enc in (reply.get("results") or {}).items():
            self._results[int(k)] = decode_result(enc)
        self._trace_flush.extend(reply.get("trace") or [])
        self._ring_flush.extend(reply.get("rings") or [])
        self._progress = {int(k): [int(t) for t in v]
                          for k, v in (reply.get("progress") or {}).items()}
        self._spec = reply.get("spec") or self._spec
        if "handoff" in reply:
            self._handoff_ready = list(reply.get("handoff") or [])
        uids = [int(u) for u in reply.get("uids") or []]
        self._ack = list(uids)
        return uids

    def live_requests(self) -> list:
        try:
            reply = self.rpc.call("live_requests", retry_safe=True)
        except RpcError:
            return []
        return [decode_request(d) for d in reply]

    def reconcile(self, uids: list) -> dict:
        """The restart-recovery round trip (``Router._recover``): which of
        the journaled ``uids`` this worker still holds live, plus every
        terminal result it has for them (the replay-safe unacked buffer's
        contents survive a router crash). Raises on transport failure —
        the Router treats an unreconcilable worker as dead-between-crash-
        and-restart and fails its requests over."""
        reply = self.rpc.call("reconcile", uids=[int(u) for u in uids],
                              retry_safe=True)
        self._refresh(reply)
        results = {int(u): decode_result(enc)
                   for u, enc in (reply.get("results") or {}).items()}
        self._results.update(results)
        return {"live": [int(u) for u in reply.get("live") or []],
                "results": results}

    def arrived_queue_len(self, now: float | None = None) -> int:
        try:
            self._arrived = int(self.rpc.call(
                "arrived_queue_len", now=now, retry_safe=True))
        except RpcError:
            pass  # stale cache beats failing a fleet-wide submit
        return self._arrived

    def prefix_match_len(self, prompt) -> int:
        try:
            return int(self.rpc.call(
                "prefix_match_len",
                prompt=_enc_value(np.asarray(prompt, np.int32)),
                retry_safe=True))
        except RpcError:
            return 0  # affinity is an optimization, never a dispatch blocker

    def pending_arrival_times(self) -> list[float]:
        return list(self._pending)

    def set_epoch(self, epoch: float) -> None:
        """Cross-process epoch alignment: perf_counter references are
        per-process, so the wire carries the caller's ELAPSED time since
        its epoch and the worker re-anchors its own clock to match (skew =
        one RPC latency; docs/serving.md)."""
        elapsed = time.perf_counter() - float(epoch)
        reply = self.rpc.call("set_epoch", elapsed=elapsed)
        self._refresh(reply)

    @property
    def load(self) -> int:
        return self._load

    @property
    def idle(self) -> bool:
        return self._idle

    @property
    def queue_len(self) -> int:
        return self._queue_len

    @property
    def occupancy(self) -> float:
        """Cached decode-slot occupancy from the last state piggyback —
        the disagg autoscaler's decode-pool saturation signal."""
        return self._occupancy

    @property
    def last_step_compiled(self) -> bool:
        return self._compiled

    def take_trace_flush(self, limit: int = 256) -> list[dict]:
        """Drain the piggybacked request-trace events the step replies
        delivered (no extra round trip) — the Router mirrors these so a
        SIGKILL'd worker's timeline survives in merged snapshots."""
        out = []
        while self._trace_flush and len(out) < limit:
            out.append(self._trace_flush.popleft())
        return out

    def take_ring_flush(self, limit: int = 256) -> list[dict]:
        """Drain the piggybacked flight-recorder ring cells the step
        replies delivered (no extra round trip): the Router ingests them
        into its per-replica mirror stores, so a SIGKILL'd worker's recent
        history survives for SLO windows and incident bundles."""
        out = []
        while self._ring_flush and len(out) < limit:
            out.append(self._ring_flush.popleft())
        return out

    def partial_tokens(self, uid: int):
        """Tokens so far for ``uid`` from the step-piggybacked progress
        cache (and terminal results), NEVER the wire: a gateway polls this
        per stream per step. None when the worker has not reported the uid
        (it may still be queued there)."""
        uid = int(uid)
        res = self._results.get(uid)
        if res is not None:
            return np.asarray(res.tokens, np.int32)
        toks = self._progress.get(uid)
        if toks is None:
            return None
        return np.asarray(toks, np.int32)

    # -- disaggregated handoff surface -----------------------------------

    def handoff_ready(self) -> list[dict]:
        """Parked prefill-complete requests on this (prefill-role) worker,
        from the step-piggybacked cache — NEVER the wire: the Router's
        handoff pump polls this every step."""
        return list(self._handoff_ready)

    def kv_export_window(self, uid: int, start: int, width: int,
                         compression: str = "none") -> dict:
        """One chunk-granular slot-KV window, ENCODED (encode_kv_window):
        the Router relays the dict straight into ``kv_import_window`` on a
        decode worker with no host decode/re-encode in between. Replay-
        safe: a pure read on the worker."""
        return self.rpc.call(
            "kv_export_window", uid=int(uid), start=int(start),
            width=int(width), compression=str(compression), retry_safe=True)

    def kv_import_window(self, uid: int, start: int, width: int,
                         window: dict) -> None:
        # replay-safe: re-importing the same window is an idempotent
        # overwrite of the same cache region
        reply = self.rpc.call(
            "kv_import_window", uid=int(uid), start=int(start),
            width=int(width), window=window, retry_safe=True)
        self._refresh(reply)

    def kv_import_begin(self, request, pos: int, first: int, *,
                        prefix_hit_tokens: int = 0, t_admit: float = 0.0,
                        t_first: float = 0.0) -> int:
        # replay-safe: the worker treats a re-delivered staged uid as
        # success (keyed staging, unlike submit's queue append). Raises
        # RequestRejected(reason="no_slot") natively when the decode pool
        # is full — the Router leaves the handoff parked.
        reply = self.rpc.call(
            "kv_import_begin", request=encode_request(request),
            pos=int(pos), first=int(first),
            prefix_hit_tokens=int(prefix_hit_tokens),
            t_admit=float(t_admit), t_first=float(t_first), retry_safe=True)
        self._refresh(reply)
        return int(reply["slot"])

    def kv_import_commit(self, uid: int) -> bool:
        reply = self.rpc.call("kv_import_commit", uid=int(uid),
                              retry_safe=True)
        self._refresh(reply)
        return bool(reply["committed"])

    def kv_import_abort(self, uid: int) -> bool:
        reply = self.rpc.call("kv_import_abort", uid=int(uid),
                              retry_safe=True)
        self._refresh(reply)
        return bool(reply["aborted"])

    def handoff_release(self, uid: int) -> bool:
        reply = self.rpc.call("handoff_release", uid=int(uid),
                              retry_safe=True)
        self._refresh(reply)
        self._handoff_ready = [h for h in self._handoff_ready
                               if int(h.get("uid", -1)) != int(uid)]
        return bool(reply["released"])

    # -- observability ---------------------------------------------------

    def spec_stats(self) -> Optional[dict]:
        """The last step-piggybacked speculative-decoding block (drafted /
        accepted / acceptance_rate ...), mirroring ``ServingEngine.
        spec_stats`` — served from cache, NEVER the wire (the Router reads
        it per stats call). None until a step reply carried one."""
        return self._spec

    def telemetry_snapshot(self) -> dict:
        snap = self.rpc.call("telemetry_snapshot", retry_safe=True)
        if isinstance(snap, dict):
            snap.setdefault("replica_id", self.replica_id)
            snap["transport"] = self.rpc_stats()
        return snap

    def compile_counts(self) -> dict:
        return self.rpc.call("compile_counts", retry_safe=True)

    def prefix_cache_stats(self):
        return self.rpc.call("prefix_cache_stats", retry_safe=True)


__all__ = [
    "ReplicaClient", "RpcClient", "RpcServer",
    "RpcError", "RpcTimeout", "RpcConnectionLost", "RpcGarbledFrame",
    "RpcRemoteError",
    "encode_request", "decode_request", "encode_result", "decode_result",
    "encode_kv_window", "decode_kv_window", "kv_window_nbytes",
    "quantize_int8", "dequantize_int8",
    "parse_address", "format_address",
    "recv_frame", "send_frame",
]
