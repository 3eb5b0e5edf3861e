"""Serving worker process (the port of
``deepspeed_tpu/launcher/serving_worker.py``): one ``ServingEngine`` behind
the serving RPC.

``python -m deepspeed_tpu_torch.launcher.serving_worker --socket S --spec F``
builds one engine from a plain-JSON spec (the weights come from
``torch.Generator().manual_seed(0)`` in ``InferenceEngine``, so every
worker of one spec, and a Router's reference engine, hold bitwise-equal
weights) and serves the scheduler surface over ``inference/rpc.RpcServer``;
a Router drives it through ``rpc.ReplicaClient`` as it drives an
in-process replica. ``--socket`` is a unix socket path or
``tcp://host:port`` (port 0: an ephemeral port, printed in the ``ready``
line). ``--device`` is ``cuda`` (the default: the worker raises without a
card, it never falls back) or ``cpu``. On the card the worker builds the
decode kernel and captures and replays its decode graph once before it
opens its socket: a worker that cannot build or launch the kernel fails
its boot. That warm-up counts as no decode step. The port's own handler
``profile_decode_steps(steps)`` traces the next steps that begin with a
decoding slot under torch.profiler; ``telemetry_snapshot`` then reports
the decode kernels' device records beside the graph replays of that
window (``decode_kernel_records``).

Process lifecycle:

  * heartbeat: with ``--heartbeat FILE`` a daemon thread touches it (~5 Hz
    at most), so a long step (a first capture, a drain) does not look like
    a hang; the supervisor judges staleness on a monotonic clock
    (``resilience/heartbeat.py``).
  * SIGTERM: drain, then exit 0. The handler only sets a flag
    (``resilience/preemption.py``); the serve loop sees it at a frame
    boundary, stops serving, runs ``engine.drain()`` and prints
    ``{"event": "drained", ...}`` with the decode kernel's launches.
  * SIGKILL: nothing runs; the Router sees ``RpcConnectionLost`` on its
    next call (DEAD, failover from its own request copies) and the
    ``WorkerSupervisor`` respawns a fresh process after its backoff, on a
    new socket path and a recreated heartbeat file.

Replay-safe step: terminal uids (and their encoded results) stay UNACKED
across step replies until the client acknowledges them on its next step,
so a reply lost to a reset is re-delivered; ``withdraw`` results are
cached per uid. Each step reply also carries the engine's request-trace
flush, so a later SIGKILL cannot take the timeline with it.

``WorkerSupervisor`` owns spawn and respawn: one process per replica
slot, socket, heartbeat and pidfile under a short work directory, SIGKILL
on a stale heartbeat, bounded-backoff respawns, adoption of workers a dead
supervisor left behind (``adopt``), and ``set_spec``, the rolling
upgrade's new generation: later spawns boot it, while running workers and
their respawns keep the spec they booted from.

Not ported yet: the disaggregated ``--role`` flag and the KV-handoff
handlers.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from typing import Optional

from ..inference.rpc import (ReplicaClient, RpcServer, _dec_value,
                             decode_request, encode_request, encode_result)
from ..resilience.errors import RpcConnectionLost, RpcError
from ..resilience.heartbeat import HeartbeatJudge
from ..resilience.preemption import PreemptionGuard
from ..resilience.retry import RetryPolicy, backoff_delay
from ..runtime.config import RouterTransportConfig
from ..utils.durability import write_durable_bytes
from ..utils.logging import logger

_DTYPES = ("float32", "bfloat16", "float16")


def build_serving_engine(spec: dict, replica_id: int | str = 0,
                         device: str | None = None):
    """Deterministic engine construction from a plain-JSON spec (the JAX
    worker's format): ``{"model": {TransformerConfig kwargs, "dtype":
    "float32"}, "engine_dtype": "fp32", "serving": {ServingEngine
    config}}``. The weights come from ``torch.Generator().manual_seed(0)``
    inside ``InferenceEngine``, so every process building the same spec
    holds identical weights. ``device`` as ``init_inference`` takes it."""
    import torch

    from ..inference import InferenceEngine
    from ..inference.serving import ServingEngine
    from ..models.transformer import Model, TransformerConfig

    model_spec = dict(spec.get("model", {}))
    name = str(model_spec.pop("dtype", "float32"))
    if name not in _DTYPES:
        raise ValueError(f"spec model dtype must be one of {_DTYPES}, got {name!r}")
    cfg = TransformerConfig(dtype=getattr(torch, name), **model_spec)
    engine = InferenceEngine(model=Model(cfg), config={"dtype": spec.get("engine_dtype", "fp32")},
                             device=device)
    return ServingEngine(engine, config=dict(spec.get("serving", {})), replica_id=replica_id)


class WorkerHost:
    """RPC handler table around one ``ServingEngine`` (see module
    docstring for the replay-safety rules)."""

    def __init__(self, engine, heartbeat: Optional[str] = None):
        self.engine = engine
        self.heartbeat = heartbeat
        self._hb_last = 0.0
        self._unacked: list[int] = []  # terminal uids awaiting client ack
        self._withdrawn: dict[int, dict] = {}  # uid -> encoded request
        # the profiler window ``profile_decode_steps`` arms
        self._profile_left = 0
        self._prof = None
        self._replays0 = 0
        self.decode_kernel_records: Optional[dict] = None
        if heartbeat:
            # beat from a daemon thread, not only between frames: a long
            # handler (a first graph capture, a big drain) blocks the serve
            # loop for longer than any sane heartbeat timeout, and the
            # supervisor must not SIGKILL a healthy worker for it. Device
            # work and nvcc release the GIL, so the thread keeps beating
            # through them; a wedged interpreter stops it, which is the
            # hang signal.
            threading.Thread(target=self._beat_forever, daemon=True).start()

    # -- liveness --------------------------------------------------------

    def tick(self) -> None:
        if self.heartbeat and time.monotonic() - self._hb_last > 0.2:
            # dstpu: allow[thread-race] -- advisory throttle shared by the serve loop's on_tick and the daemon beat thread: the worst interleaving is two near-simultaneous beats double-touching the heartbeat file (one extra utime); no liveness verdict reads _hb_last — the supervisor judges the FILE's mtime on its own monotonic clock
            self._hb_last = time.monotonic()
            try:
                os.utime(self.heartbeat, None)
            except OSError:
                try:
                    with open(self.heartbeat, "w"):
                        pass
                except OSError:
                    pass  # heartbeat is advisory; serving goes on

    def _beat_forever(self) -> None:
        while True:
            self.tick()
            time.sleep(0.5)

    def ping(self) -> dict:
        return {"pid": os.getpid(), "mono": time.monotonic(),
                "replica_id": self.engine.replica_id,
                "role": self.engine.role}

    # -- scheduler surface ----------------------------------------------

    def _state(self, now=None) -> dict:
        e = self.engine
        return {
            "load": e.load, "idle": e.idle, "queue_len": e.queue_len,
            "arrived": e.arrived_queue_len(now),
            "pending": e.pending_arrival_times(),
            "occupancy": e.occupancy,
        }

    def submit(self, request: dict) -> dict:
        uid = self.engine.submit(decode_request(request))
        return {"uid": uid, **self._state()}

    def requeue(self, request: dict) -> dict:
        req = decode_request(request)
        self._withdrawn.pop(req.uid, None)  # a re-queued uid may be re-drained
        try:
            uid = self.engine.requeue(req)
        except ValueError as e:
            if ("already in flight" in str(e)
                    and self.engine.result(req.uid) is None):
                uid = req.uid  # replay-safe: a retried requeue re-delivered
            else:
                raise
        return {"uid": uid, **self._state()}

    def withdraw(self, uid: int) -> dict:
        uid = int(uid)
        if uid in self._withdrawn:  # replay-safe: reply lost, not the request
            return {"request": self._withdrawn[uid], **self._state()}
        req = self.engine.withdraw(uid)
        enc = None if req is None else encode_request(req)
        if enc is not None:
            self._withdrawn[uid] = enc
        return {"request": enc, **self._state()}

    def cancel(self, uid: int) -> dict:
        ok = self.engine.cancel(int(uid))
        res = self.engine.result(int(uid))
        return {"cancelled": ok,
                "result": None if res is None else encode_result(res),
                **self._state()}

    def result(self, uid: int):
        res = self.engine.result(int(uid))
        return None if res is None else encode_result(res)

    def step(self, now=None, enforce_deadlines: bool = True,
             ack=None, progress: bool = False) -> dict:
        for uid in ack or []:
            try:
                self._unacked.remove(int(uid))
            except ValueError:
                pass
        self._profile_open()
        uids = self.engine.step(
            now=None if now is None else float(now),
            enforce_deadlines=bool(enforce_deadlines))
        self._profile_count()
        known = set(self._unacked)
        self._unacked.extend(u for u in uids if u not in known)
        results = {}
        for u in self._unacked:
            res = self.engine.result(u)
            if res is not None:
                results[str(u)] = encode_result(res)
        reply = {
            "uids": list(self._unacked),
            "results": results,
            "trace": self.engine.take_trace_flush(256),
            "compiled": self.engine.last_step_compiled,
            **self._state(now),
        }
        spec = self.engine.spec_stats()
        if spec is not None:
            # speculative acceptance counts ride the step reply exactly
            # like progress/trace — the Router's fleet aggregation costs
            # zero extra RPCs (a handful of ints; always-on when enabled)
            reply["spec"] = spec
        if progress:
            # tokens-so-far per decoding slot: the gateway's SSE streams
            # advance from this piggyback — zero extra round trips.
            # OPT-IN (the gateway flips it via Router.
            # enable_stream_progress): re-sending each stream's full
            # token list per step is O(tokens^2) wire over a generation,
            # and a fleet with no streaming front door must not pay it
            reply["progress"] = {
                str(u): t for u, t in self.engine.live_progress().items()}
        return reply

    def profile_decode_steps(self, steps: int) -> dict:
        """Arm a torch.profiler window over the next ``steps`` steps that
        begin with a decoding slot (the port's own handler). When it closes,
        ``telemetry_snapshot`` reports the decode kernels' device records
        beside the graph replays in the window: the launch count is the
        per-replay launches times the replays, and the records measure it."""
        self._profile_left, self.decode_kernel_records = int(steps), None
        return {"armed": self._profile_left}

    def _profile_open(self) -> None:
        if self._profile_left <= 0 or self._prof is not None or not self.engine.n_active:
            return
        from torch.profiler import ProfilerActivity, profile

        cuda = self.engine.worker.device.type == "cuda"
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        self._prof.start()
        self._replays0 = self.engine.worker.graph_replays

    def _profile_count(self) -> None:
        if self._prof is None:
            return
        self._profile_left -= 1
        if self._profile_left:
            return
        import torch

        if self.engine.worker.device.type == "cuda":
            torch.cuda.synchronize()
        self._prof.stop()
        names = [e.name for e in self._prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        self._prof = None
        self.decode_kernel_records = {
            "split": sum("decode_split_kernel" in n for n in names),
            "combine": sum("decode_combine_kernel" in n for n in names),
            "replays": self.engine.worker.graph_replays - self._replays0}

    def live_requests(self) -> list:
        return [encode_request(r) for r in self.engine.live_requests()]

    def reconcile(self, uids) -> dict:
        """One recovery round trip (``Router._recover``): for the
        journaled non-terminal ``uids`` a restarted control plane asks
        about, report which this worker still holds LIVE and every
        terminal result it has for them — the unacked-result buffer and
        the engine's result map both survive a ROUTER crash, since only
        the router process died. Read-only and replay-safe."""
        results = {}
        for u in uids or []:
            res = self.engine.result(int(u))
            if res is not None:
                results[str(int(u))] = encode_result(res)
        live = [int(r.uid) for r in self.engine.live_requests()]
        return {"live": live, "results": results, **self._state()}

    def arrived_queue_len(self, now=None) -> int:
        return self.engine.arrived_queue_len(
            None if now is None else float(now))

    def prefix_match_len(self, prompt) -> int:
        return self.engine.prefix_match_len(_dec_value(prompt))

    def set_epoch(self, elapsed: float) -> dict:
        # cross-process epoch alignment: perf_counter references are
        # per-process, so the wire carries the caller's elapsed-since-epoch
        # and we re-anchor the local clock to match (skew = rpc latency)
        self.engine.set_epoch(time.perf_counter() - float(elapsed))
        return self._state()

    def drain(self) -> dict:
        return {str(u): encode_result(r)
                for u, r in self.engine.drain().items()}

    # -- observability ---------------------------------------------------

    def telemetry_snapshot(self) -> dict:
        snap = self.engine.telemetry_snapshot()
        # the decode kernel's (split, combine) launches by this process's
        # graph replays: the fleet's launch count, read from the worker
        snap["decode_kernel_launches"] = list(self.engine.worker.decode_kernel_launches())
        snap["decode_kernel_records"] = self.decode_kernel_records
        return snap

    def compile_counts(self) -> dict:
        return self.engine.compile_counts()

    def prefix_cache_stats(self):
        return self.engine.prefix_cache_stats()

    def handlers(self) -> dict:
        return {name: getattr(self, name) for name in (
            "ping", "submit", "requeue", "withdraw", "cancel", "result",
            "step", "live_requests", "reconcile", "arrived_queue_len",
            "prefix_match_len", "set_epoch", "drain", "telemetry_snapshot",
            "compile_counts", "prefix_cache_stats", "profile_decode_steps")}


def _pid_alive(pid: int) -> bool:
    """Liveness probe (signal 0). EPERM means alive-but-not-ours — still
    alive for the purposes of never SIGKILLing a recycled pid."""
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class _AdoptedProc:
    """Popen-shaped handle for a worker ADOPTED from a dead predecessor
    supervisor's pidfile: the process is not our child, so there is no
    real returncode — ``poll`` degrades to the pid-liveness probe and a
    vanished process reports the conventional ``-SIGKILL``. ``wait`` is a
    bounded poll loop (retire/shutdown paths); ``kill`` delivers the
    signal directly."""

    def __init__(self, pid: int):
        self.pid = int(pid)
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is None and not _pid_alive(self.pid):
            self.returncode = -signal.SIGKILL  # true rc unknowable: not our child
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(
                    f"adopted worker pid {self.pid}", timeout)
            time.sleep(0.05)
        return self.returncode

    def kill(self) -> None:
        try:
            os.kill(self.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.launcher.serving_worker",
        description="Host one ServingEngine replica behind the serving RPC.")
    ap.add_argument("--socket", required=True,
                    help="address to bind: a unix socket path, or "
                         "tcp://host:port (port 0 = OS-assigned; the "
                         "resolved address is printed in the ready line)")
    ap.add_argument("--spec", required=True,
                    help="JSON spec file: {model, engine_dtype, serving}")
    ap.add_argument("--replica-id", default="0",
                    help="identity stamped into telemetry snapshots")
    ap.add_argument("--heartbeat", default="",
                    help="heartbeat file touched each serve-loop tick")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine runs (default cuda: the worker "
                         "raises without a card and never falls back)")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serving worker: no CUDA device is available; pass --device cpu to serve "
                           "on the CPU")
    with open(args.spec) as f:
        spec = json.load(f)
    rid = int(args.replica_id) if str(args.replica_id).isdigit() else args.replica_id

    # SIGTERM/SIGINT -> flag only (resilience/preemption.py); consumed at a
    # frame boundary below for the drain-then-exit path
    guard = PreemptionGuard(["SIGTERM", "SIGINT"])
    guard.install()

    # engine BEFORE socket: a connectable socket means a servable worker
    engine = build_serving_engine(spec, replica_id=rid, device=args.device)
    if args.device == "cuda":
        # build the decode kernel, capture the decode graph and replay it
        # once with every slot idle: a worker that cannot launch its
        # kernel fails here, before it serves anything
        engine.warm_decode()
    host = WorkerHost(engine, heartbeat=args.heartbeat or None)
    server = RpcServer(args.socket, host.handlers())
    # the RESOLVED address (a tcp://host:0 bind reports its real port):
    # the supervisor reads this line to learn where to connect
    print(json.dumps({"event": "ready", "pid": os.getpid(),
                      "replica_id": rid, "socket": server.address,
                      "device": str(engine.worker.device)}),
          flush=True)
    try:
        server.serve_forever(should_stop=guard.pending, on_tick=host.tick)
    finally:
        server.close()
    if guard.pending():
        # graceful retirement: finish every accepted request in-process so
        # nothing is stranded mid-decode, then report and exit 0
        in_flight = engine.load
        results = engine.drain()
        print(json.dumps({"event": "drained", "signal": guard.last_signal,
                          "in_flight_at_signal": in_flight,
                          "results": len(results),
                          "decode_steps": engine.compile_counts()["decode_steps"],
                          "decode_kernel_launches": list(engine.worker.decode_kernel_launches())}),
              flush=True)
    return 0


# -- supervision -------------------------------------------------------------

class WorkerSupervisor:
    """Spawn and respawn serving worker processes: one replica SLOT per
    worker, each (re)spawn a new generation with a fresh address (a unix
    socket path per generation, or ``transport.host:port_base+slot`` / an
    ephemeral port under TCP). ``poll()`` reports exited workers and
    SIGKILLs hung ones (heartbeat stale on a monotonic clock);
    ``respawn()`` pays the bounded-backoff delay and boots a replacement,
    which the caller attaches to its Router with ``attach_replica``: a
    NEW replica, never the dead rid resurrected.

    ``_respawn_count[slot]`` decays by one for every ``respawn_heal_s`` of
    healthy uptime, so occasional deaths over a long life never exhaust
    ``max_respawns``, while a crash loop still does. ``device`` is each
    worker's ``--device``; ``env`` adds environment for every worker,
    ``worker_env`` maps slot -> environment for that worker alone (e.g.
    ``CUDA_VISIBLE_DEVICES``)."""

    def __init__(self, spec: dict, n_workers: int, *,
                 workdir: Optional[str] = None,
                 transport: RouterTransportConfig | dict | None = None,
                 respawn_backoff: RetryPolicy | dict | None = None,
                 max_respawns: int = 3,
                 respawn_heal_s: float = 300.0,
                 seed: int = 0,
                 device: str = "cuda",
                 env: Optional[dict] = None,
                 worker_env: Optional[dict] = None,
                 clock=None):
        if isinstance(transport, dict):
            transport = RouterTransportConfig(**transport)
        self.transport = transport or RouterTransportConfig()
        if isinstance(respawn_backoff, dict):
            respawn_backoff = RetryPolicy(**respawn_backoff)
        self.respawn_backoff = respawn_backoff or RetryPolicy(
            max_attempts=1 << 30, base_delay_s=0.5, max_delay_s=8.0,
            jitter=0.25)
        self.max_respawns = int(max_respawns)
        self.respawn_heal_s = float(respawn_heal_s)
        self.seed = int(seed)
        self.n_workers = int(n_workers)
        self.device = str(device)
        # verdict and heal clock: monotonic (injectable for fake-clock
        # tests; never wall time, which an NTP step moves)
        self._now = clock if clock is not None else time.monotonic
        # sockets live here: a caller-supplied deep path can overflow the
        # AF_UNIX sun_path limit (~108 chars), so default to a short tmpdir
        self.workdir = workdir or tempfile.mkdtemp(prefix="dstt_srv_")
        os.makedirs(self.workdir, exist_ok=True)
        # the spec fresh spawns boot; each slot remembers the one its
        # generation booted (a respawn boots that one again)
        self.spec_path = os.path.join(self.workdir, "spec.json")
        write_durable_bytes(self.spec_path, json.dumps(spec).encode("utf-8"))
        self._spec_gen = 0
        self._slot_spec: dict[int, str] = {}
        self.extra_env = dict(env or {})
        self.worker_env = {int(k): dict(v)
                           for k, v in (worker_env or {}).items()}
        self._procs: dict[int, subprocess.Popen] = {}
        self._clients: dict[int, ReplicaClient] = {}
        self._logs: dict[int, str] = {}
        self._gen: Counter = Counter()
        self._respawn_count: Counter = Counter()
        self._heal_anchor: dict[int, float] = {}
        # heartbeat staleness is judged by resilience/heartbeat.
        # HeartbeatJudge: mtime-change observations on a monotonic clock,
        # with a 10x startup grace until the worker's first touch
        self._hb_path: dict[int, str] = {}
        self._hb_judge: dict[int, HeartbeatJudge] = {}
        self.respawns = 0

    # -- spawn -----------------------------------------------------------

    def set_spec(self, spec: dict) -> None:
        """Install a NEW engine spec for later spawns, the rolling
        upgrade's generation replacement (``Router.rolling_upgrade``). It
        is written under a name of its own, tmp + fsync + rename + directory
        fsync, so a crash mid-upgrade never leaves a torn spec to boot
        from. Running workers keep serving the old generation's spec, and
        a crash-respawn of such a slot boots that spec again: only a fresh
        slot (an upgrade wave's newcomer, a scale-up) boots the new one."""
        self._spec_gen += 1
        path = os.path.join(self.workdir, f"spec.g{self._spec_gen}.json")
        write_durable_bytes(path, json.dumps(spec).encode("utf-8"))
        self.spec_path = path

    def _pidfile(self, slot: int) -> str:
        return os.path.join(self.workdir, f"w{slot}.pid")

    def _write_pidfile(self, slot: int, info: dict) -> None:
        """Per-slot pidfile, written tmp + fsync + rename (+ dir fsync):
        the adoption record a RESTARTED supervisor reads to find workers
        that survived the control plane's death. A torn pidfile would be
        adopted as garbage or reaped as stale."""
        write_durable_bytes(self._pidfile(slot),
                            json.dumps(info).encode("utf-8"))

    def _remove_pidfile(self, slot: int) -> None:
        try:
            os.unlink(self._pidfile(slot))
        except OSError:
            pass

    def _listen_address(self, slot: int) -> str:
        """The address the slot's NEXT generation binds: a per-generation
        unix socket path, or ``tcp://host:{port_base+slot}`` (port 0 under
        an unset ``port_base`` — the worker binds an ephemeral port and
        the supervisor learns it from the ready line)."""
        t = self.transport
        if t.family == "tcp":
            port = t.port_base + slot if t.port_base else 0
            return f"tcp://{t.host}:{port}"
        return os.path.join(self.workdir, f"w{slot}g{self._gen[slot]}.sock")

    def _ready_address(self, slot: int) -> Optional[str]:
        """The resolved address from the worker's ``ready`` log line (how
        an ephemeral TCP port is discovered); None until printed."""
        try:
            with open(self._logs[slot]) as f:
                for line in f:
                    line = line.strip()
                    if not line.startswith("{"):
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue
                    if ev.get("event") == "ready":
                        return ev.get("socket")
        except OSError:
            pass
        return None

    def spawn(self, slot: int, spec_path: Optional[str] = None) -> ReplicaClient:
        """Boot the worker for ``slot`` from ``spec_path`` (default: the
        current spec, ``set_spec``'s latest) and block until its socket
        serves a ping (bounded by ``transport.boot_timeout_s``)."""
        spec_path = spec_path or self.spec_path
        self._slot_spec[slot] = spec_path
        addr = self._listen_address(slot)
        hb = os.path.join(self.workdir, f"hb{slot}")
        with open(hb, "w"):
            pass
        self._hb_path[slot] = hb
        judge = HeartbeatJudge(hb, float(self.transport.heartbeat_timeout_s))
        judge.reset()
        self._hb_judge[slot] = judge
        self._heal_anchor[slot] = self._now()
        log_path = os.path.join(self.workdir,
                                f"w{slot}g{self._gen[slot]}.log")
        self._logs[slot] = log_path
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update(self.worker_env.get(slot, {}))
        cmd = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.serving_worker",
               "--socket", addr, "--spec", spec_path,
               "--replica-id", str(slot), "--heartbeat", hb,
               "--device", self.device]
        with open(log_path, "w") as log_f:
            proc = subprocess.Popen(cmd, env=env, stdout=log_f,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        self._procs[slot] = proc
        # adoption record FIRST (pid + declared address): a control-plane
        # crash during boot must not leave an untracked orphan; the
        # resolved address is rewritten below once the worker is up
        self._write_pidfile(slot, {
            "pid": proc.pid, "slot": slot, "gen": self._gen[slot],
            "addr": addr, "heartbeat": hb, "log": log_path, "spec": spec_path})
        # an ephemeral-port worker resolves its address at bind time; poll
        # the ready line for it before the first connect
        ephemeral = addr.startswith("tcp://") and addr.endswith(":0")
        client: Optional[ReplicaClient] = None
        deadline = time.monotonic() + float(self.transport.boot_timeout_s)
        while True:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"serving worker slot {slot} exited rc={proc.returncode} "
                    f"during boot (log: {log_path}): {self.log_tail(slot)}")
            if time.monotonic() > deadline:
                proc.kill()
                raise RuntimeError(
                    f"serving worker slot {slot} did not serve within "
                    f"boot_timeout_s={self.transport.boot_timeout_s} "
                    f"(log: {log_path})")
            if client is None:
                target = self._ready_address(slot) if ephemeral else addr
                if target is None:
                    time.sleep(0.1)
                    continue
                client = ReplicaClient(target, replica_id=slot,
                                       transport=self.transport,
                                       seed=self.seed * 1009 + slot)
            try:
                client.connect()
                client.ping()
                break
            except RpcConnectionLost:
                time.sleep(0.1)
        self._clients[slot] = client
        if client.rpc.path != addr:
            # ephemeral TCP port resolved at bind time: the adoption
            # record must carry the address a successor can connect to
            self._write_pidfile(slot, {
                "pid": proc.pid, "slot": slot, "gen": self._gen[slot],
                "addr": client.rpc.path, "heartbeat": hb, "log": log_path, "spec": spec_path})
        logger.info("serving supervisor: slot %d generation %d up (pid %d, "
                    "%s)", slot, self._gen[slot], proc.pid, client.rpc.path)
        return client

    # -- orphan adoption (docs/serving.md "Crash-safe control plane") ----

    def adopt(self) -> dict[int, ReplicaClient]:
        """Adopt still-running workers a DEAD predecessor supervisor left
        behind, from the fsync'd per-slot pidfiles in ``workdir`` — a
        restarted control plane re-attaches surviving workers instead of
        double-spawning onto their ports/sockets.

        Hygiene rules (the recycled-pid hazard): a pidfile whose pid is
        dead is STALE and reaped (unlinked); a pid that is alive must ALSO
        prove identity — the recorded RPC address answers ``ping`` with
        the recorded pid — before adoption. A recycled pid that merely
        exists (or an unrelated process squatting the address) fails the
        identity check and only the FILE is reaped: this supervisor never
        signals a pid it cannot prove is its worker. Returns
        ``{slot: ReplicaClient}`` for every adopted worker; missing slots
        are the caller's to ``spawn()``."""
        adopted: dict[int, ReplicaClient] = {}
        try:
            names = sorted(os.listdir(self.workdir))
        except OSError:
            return adopted
        for name in names:
            if not (name.startswith("w") and name.endswith(".pid")):
                continue
            path = os.path.join(self.workdir, name)
            try:
                with open(path) as f:
                    info = json.load(f)
                slot = int(info["slot"])
                pid = int(info["pid"])
                addr = str(info["addr"])
            except (OSError, ValueError, KeyError, TypeError):
                logger.warning("serving supervisor: unreadable pidfile %s "
                               "— reaping", path)
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            if slot in self._procs:
                continue  # this supervisor already owns the slot
            if not _pid_alive(pid):
                logger.info("serving supervisor: stale pidfile %s (pid %d "
                            "dead) — reaped", path, pid)
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            # liveness is not identity: prove over the RPC socket that
            # the live pid IS our worker before supervising (or ever
            # signalling) it
            client = ReplicaClient(addr, replica_id=slot,
                                   transport=self.transport,
                                   seed=self.seed * 1009 + slot)
            try:
                reply = client.ping()
                verified = int(reply.get("pid", -1)) == pid
            except (RpcError, OSError):
                verified = False
            if not verified:
                client.close()
                logger.warning(
                    "serving supervisor: pidfile %s names live pid %d but "
                    "%s does not answer as it — recycled pid or squatted "
                    "address; reaping the FILE, never the pid", path, pid,
                    addr)
                try:
                    os.unlink(path)
                except OSError:
                    pass
                continue
            self._procs[slot] = _AdoptedProc(pid)
            self._clients[slot] = client
            self._gen[slot] = int(info.get("gen", 0))
            self._slot_spec[slot] = str(info.get("spec", "")) or self.spec_path
            self._logs[slot] = str(info.get("log", "")) or os.path.join(
                self.workdir, f"w{slot}g{self._gen[slot]}.log")
            hb = str(info.get("heartbeat", "")) or os.path.join(
                self.workdir, f"hb{slot}")
            self._hb_path[slot] = hb
            judge = HeartbeatJudge(
                hb, float(self.transport.heartbeat_timeout_s))
            judge.reset()
            self._hb_judge[slot] = judge
            self._heal_anchor[slot] = self._now()
            adopted[slot] = client
            logger.info("serving supervisor: ADOPTED slot %d (pid %d, %s, "
                        "generation %d) from a previous supervisor",
                        slot, pid, addr, self._gen[slot])
        return adopted

    def start(self) -> list[ReplicaClient]:
        return [self.spawn(slot) for slot in range(self.n_workers)]

    def client(self, slot: int) -> ReplicaClient:
        return self._clients[slot]

    def proc(self, slot: int) -> subprocess.Popen:
        return self._procs[slot]

    def log_tail(self, slot: int, lines: int = 5) -> str:
        try:
            with open(self._logs[slot]) as f:
                return " | ".join(f.read().strip().splitlines()[-lines:])
        except (KeyError, OSError):  # never-spawned slot / unreadable log
            return "<no log>"

    # -- liveness --------------------------------------------------------

    def _heartbeat_stale(self, slot: int) -> bool:
        judge = self._hb_judge.get(slot)
        return judge is not None and judge.stale()

    def poll(self) -> list[int]:
        """One supervision pass: slots whose worker exited, plus slots
        whose heartbeat went stale (those are SIGKILL'd first — a wedged
        worker already ignored its chance to exit). Returns the slots that
        now need ``respawn()``.

        Healthy uptime also HEALS the respawn budget here: every
        ``respawn_heal_s`` of alive-and-heartbeating time decays the
        slot's ``_respawn_count`` by one, so occasional preemptions over a
        long fleet lifetime never accumulate into ``max_respawns``
        exhaustion. A crash-looping worker never lives that long — its
        budget still runs out."""
        bad = []
        for slot, proc in list(self._procs.items()):
            if proc.poll() is not None:
                bad.append(slot)
            elif self._heartbeat_stale(slot):
                logger.warning(
                    "serving supervisor: slot %d heartbeat stale >%.1fs — "
                    "SIGKILL", slot, self.transport.heartbeat_timeout_s)
                proc.kill()
                proc.wait()
                bad.append(slot)
            elif self.respawn_heal_s > 0 and self._respawn_count[slot] > 0:
                anchor = self._heal_anchor.get(slot, self._now())
                while (self._respawn_count[slot] > 0
                       and self._now() - anchor >= self.respawn_heal_s):
                    self._respawn_count[slot] -= 1
                    anchor += self.respawn_heal_s
                    logger.info(
                        "serving supervisor: slot %d respawn budget healed "
                        "to %d after sustained health", slot,
                        self._respawn_count[slot])
                self._heal_anchor[slot] = anchor
        return bad

    def respawn(self, slot: int) -> ReplicaClient:
        """Replace a dead/hung worker: pay the bounded-backoff delay for
        this slot's respawn count, then spawn a fresh generation. Raises
        once ``max_respawns`` for the slot is exhausted (a crash-looping
        spec must surface, not spin)."""
        self._respawn_count[slot] += 1
        if self._respawn_count[slot] > self.max_respawns:
            raise RuntimeError(
                f"serving worker slot {slot} exhausted its respawn budget "
                f"({self.max_respawns}); last log: {self.log_tail(slot)}")
        proc = self._procs.get(slot)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        old = self._clients.pop(slot, None)
        if old is not None:
            old.close()
        delay = backoff_delay(self._respawn_count[slot], self.respawn_backoff,
                              seed=self.seed * 7919 + slot)
        if delay > 0:
            time.sleep(delay)
        # the dead generation's socket file goes: the next one binds a
        # fresh path, and nothing stale is left for it to trip over
        if self.transport.family == "unix":
            try:
                os.unlink(self._listen_address(slot))
            except OSError:
                pass
        self._gen[slot] += 1
        self.respawns += 1
        # the slot's own generation: an upgrade's set_spec does not reach a
        # worker before its wave replaces it
        return self.spawn(slot, self._slot_spec.get(slot))

    def kill(self, slot: int, sig: int = signal.SIGKILL) -> None:
        """Deliver ``sig`` to the slot's worker (the chaos drill's kill -9)."""
        os.kill(self._procs[slot].pid, sig)

    def retire(self, slot: int, timeout: float = 30.0) -> None:
        """Permanently remove ``slot`` from supervision — the autoscaler's
        scale-down path (its replica has drained; nothing is in flight).
        SIGTERM gives a live worker its drain-then-exit-0 path; a corpse
        is simply reaped. The slot never appears in later ``poll()``s and
        is never respawned (``spawn(slot)`` would start a fresh
        generation if the fleet grows again)."""
        proc = self._procs.pop(slot, None)
        client = self._clients.pop(slot, None)
        self._slot_spec.pop(slot, None)
        self._hb_judge.pop(slot, None)
        self._hb_path.pop(slot, None)
        self._heal_anchor.pop(slot, None)
        self._remove_pidfile(slot)
        if client is not None:
            client.close()
        if proc is None:
            return
        if proc.poll() is None:
            try:
                os.kill(proc.pid, signal.SIGTERM)
            except OSError:
                pass
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        logger.info("serving supervisor: slot %d retired (rc=%s)",
                    slot, proc.returncode)

    def shutdown(self, sig: int = signal.SIGTERM, timeout: float = 10.0) -> None:
        # snapshot: a background retire (rolling upgrade) may pop slots
        # concurrently, and dict iteration must not race it
        for slot, proc in list(self._procs.items()):
            if proc.poll() is None:
                try:
                    os.kill(proc.pid, sig)
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for proc in list(self._procs.values()):
            remaining = max(0.1, deadline - time.monotonic())
            try:
                proc.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for client in self._clients.values():
            client.close()
        self._clients.clear()
        for slot in list(self._procs):
            # the workers are down: their adoption records are stale now
            self._remove_pidfile(slot)


if __name__ == "__main__":
    sys.exit(main())
