"""Elastic agent: supervise a training worker across failures, hangs and
membership changes (the port of ``deepspeed_tpu/elasticity/elastic_agent.py``;
DeepSpeed's ``DSElasticAgent``, ``elasticity/elastic_agent.py:23``).

Membership is the reservation (a hostfile, or a static world), and the
agent is a small supervisor:

1. read membership (the hostfile, reread every ``monitor_interval``);
2. validate the world size against the elastic config
   (``compute_elastic_config``) and pick the micro-batch for that world;
3. launch the worker command with the ``DSTPU_ELASTIC_*`` env, in a session
   of its own (``launcher/launch.py``'s contract);
4. on the worker's death, a membership change or a *stale heartbeat* (a
   wedged worker that neither exits nor progresses): terminate the tree,
   recompute, back off (bounded exponential with deterministic jitter, so a
   crash-looping worker cannot hot-spin the supervisor) and relaunch, at
   most ``max_restarts`` times. The training state carries across through
   checkpoint-resume (``save_checkpoint`` / ``load_checkpoint`` and the
   preemption guard's just-in-time checkpoints).

Heartbeats: with ``heartbeat_file`` set, the worker finds its path in
``DSTPU_ELASTIC_HEARTBEAT`` and touches it at every step boundary
(``os.utime(path)`` or ``pathlib.Path(path).touch()``). The agent
re-creates the file at each launch and declares the worker hung once its
mtime has not changed for ``heartbeat_timeout`` seconds, and SIGKILLs it
straight away (a wedged worker already ignored its chance to exit). A
worker that has not touched the file yet is judged against
``heartbeat_grace`` (default 10x the timeout) instead: its first step
includes the interpreter's boot, the CUDA context and loading the kernels.

Exit codes (``run()``'s return value; ``python -m
deepspeed_tpu_torch.elasticity`` shares the contract): ``0`` the worker
finished cleanly (perhaps after restarts; ``restart_count`` says how
many); the worker's last nonzero rc when failures exhausted
``max_restarts``; ``1`` when membership churn or hangs exhausted them;
``ElasticityIncompatibleWorldSize`` raised when the elastic config rejects
the current world size (the CLI maps it to exit ``3``, usage errors to
``2``).
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..launcher.launch import terminate_process_tree
from ..resilience.heartbeat import HeartbeatJudge
from ..resilience.retry import RetryPolicy, backoff_delay
from ..utils.logging import logger
from .elasticity import compute_elastic_config

HEARTBEAT_ENV = "DSTPU_ELASTIC_HEARTBEAT"


@dataclass
class WorkerSpec:
    """What to run for one elastic generation.

    ``command`` is either a ready argv list or a callable
    ``(world_size, micro_batch, final_batch) -> argv`` so the training script
    can receive the recomputed batch settings."""

    command: Sequence[str] | Callable[[int, int, int], Sequence[str]]
    extra_env: dict = field(default_factory=dict)

    def argv(self, world_size: int, micro_batch: int, final_batch: int) -> list[str]:
        if callable(self.command):
            return list(self.command(world_size, micro_batch, final_batch))
        return list(self.command)


class DSElasticAgent:
    def __init__(
        self,
        ds_config: dict,
        spec: WorkerSpec,
        hostfile: Optional[str] = None,
        static_world_size: Optional[int] = None,
        monitor_interval: float = 1.0,
        max_restarts: int = 3,
        heartbeat_file: Optional[str] = None,
        heartbeat_timeout: float = 0.0,
        heartbeat_grace: Optional[float] = None,
        restart_backoff: Optional[RetryPolicy | dict] = None,
        backoff_seed: int = 0,
    ):
        if hostfile is None and static_world_size is None:
            raise ValueError("need a hostfile to watch or a static_world_size")
        self.ds_config = ds_config
        self.spec = spec
        self.hostfile = hostfile
        self.static_world_size = static_world_size
        self.monitor_interval = monitor_interval
        self.max_restarts = max_restarts
        self.heartbeat_file = heartbeat_file
        self.heartbeat_timeout = float(heartbeat_timeout)
        # until the worker's FIRST touch, the staleness clock is the startup
        # grace, not the step timeout: time to the first step includes the
        # boot, the CUDA context and the kernels' load, and a timeout sized
        # from step cadence would SIGKILL a healthy booting worker in a
        # relaunch loop that re-pays the boot every generation
        self.heartbeat_grace = (
            float(heartbeat_grace) if heartbeat_grace is not None
            else 10.0 * self.heartbeat_timeout)
        # shared monotonic staleness judge (resilience/heartbeat.py): the
        # verdict clock is monotonic time between this agent's observations
        # of the mtime CHANGING, never wall-clock-vs-mtime arithmetic, which
        # an NTP step could turn into a false hung-worker verdict (or hide a
        # real one). Re-armed per generation in _launch.
        self._hb_judge: Optional[HeartbeatJudge] = None
        if isinstance(restart_backoff, dict):
            restart_backoff = RetryPolicy(**restart_backoff)
        # default: 1s doubling to 30s, +/-25% deterministic jitter — tight
        # enough that a transient failure resumes fast, bounded so a
        # crash-looping worker costs O(seconds) per generation, not a spin
        self.restart_backoff = (
            restart_backoff if restart_backoff is not None
            else RetryPolicy(max_attempts=1 << 30, base_delay_s=1.0,
                             max_delay_s=30.0, jitter=0.25))
        self.backoff_seed = backoff_seed
        self.restart_count = 0
        self._proc: Optional[subprocess.Popen] = None
        # one record a generation: its world, when it was launched and, for a
        # hung worker, when its tree was SIGKILLed. The stamps are
        # time.monotonic(), one clock for every process of the host, so a
        # worker's own monotonic stamps compare with them; no verdict reads them
        self.generations: list[dict] = []

    # -- membership ----------------------------------------------------
    def current_world_size(self) -> int:
        if self.hostfile is None:
            return int(self.static_world_size)
        from ..launcher.runner import fetch_hostfile

        try:
            hosts = fetch_hostfile(self.hostfile)
        except (OSError, ValueError):
            # a poll can race a non-atomic hostfile rewrite: a missing file
            # or a torn line ("host1 slots=") is an unreadable SNAPSHOT, not
            # a membership verdict — report 0 and let callers keep the last
            # good world (the same contract as the 0-hosts case below)
            return 0
        return sum(hosts.values())

    # -- one generation ------------------------------------------------
    def _resolve(self, world_size: int) -> tuple[int, int]:
        final_batch, _valid, micro = compute_elastic_config(
            self.ds_config, world_size=world_size)
        return final_batch, micro

    def _launch(self, world_size: int) -> subprocess.Popen:
        final_batch, micro = self._resolve(world_size)
        argv = self.spec.argv(world_size, micro, final_batch)
        env = dict(os.environ)
        env.update(
            DSTPU_ELASTIC_WORLD_SIZE=str(world_size),
            DSTPU_ELASTIC_MICRO_BATCH=str(micro),
            DSTPU_ELASTIC_BATCH=str(final_batch),
            DSTPU_ELASTIC_GENERATION=str(self.restart_count),
            **self.spec.extra_env,
        )
        if self.heartbeat_file:
            env[HEARTBEAT_ENV] = self.heartbeat_file
            # fresh file per generation: the hung-worker clock starts at
            # launch, not at the previous generation's last touch
            with open(self.heartbeat_file, "w"):
                pass
            self._hb_judge = HeartbeatJudge(
                self.heartbeat_file, self.heartbeat_timeout,
                self.heartbeat_grace)
            self._hb_judge.reset()
        logger.info(
            "elastic agent: launching generation %d at world=%d "
            "(batch=%d, micro=%d): %s",
            self.restart_count, world_size, final_batch, micro, argv)
        self.generations.append({"generation": self.restart_count, "world": world_size,
                                 "launched_at": time.monotonic(), "killed_at": None})
        return subprocess.Popen(argv, env=env, start_new_session=True)

    def _heartbeat_stale(self) -> bool:
        """True when heartbeat monitoring is armed and the worker has not
        touched the file within ``heartbeat_timeout`` seconds. A worker
        that has never touched the file is still starting up (booting,
        loading the kernels) and gets ``heartbeat_grace`` instead — only after its
        first touch does the step-cadence timeout apply.

        The verdict clock (``resilience/heartbeat.HeartbeatJudge``, shared
        with the serving WorkerSupervisor) is ``time.monotonic()`` between
        this agent's own observations of the mtime CHANGING — never
        ``time.time() - mtime``: mtime is a wall-clock stamp, so an NTP
        step (or a worker on a skewed filesystem clock) could otherwise
        mint a false hung verdict and SIGKILL a healthy worker, or stretch
        a real hang's detection."""
        if (not self.heartbeat_file or self.heartbeat_timeout <= 0
                or self._hb_judge is None):
            return False
        return self._hb_judge.stale()

    def _backoff(self) -> None:
        """Sleep the bounded-exponential delay for the upcoming restart
        (generation number keys the deterministic jitter draw)."""
        d = backoff_delay(max(1, self.restart_count), self.restart_backoff,
                          seed=self.backoff_seed)
        if d > 0:
            logger.info("elastic agent: backing off %.2fs before restart %d",
                        d, self.restart_count)
            time.sleep(d)

    def _kill_hung(self):
        """SIGKILL a worker whose heartbeat went stale, noting when."""
        if self.generations:
            self.generations[-1]["killed_at"] = time.monotonic()
        self._stop(signal.SIGKILL)

    def _stop(self, sig=signal.SIGTERM):
        if self._proc is not None and self._proc.poll() is None:
            terminate_process_tree(self._proc.pid, sig)
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                terminate_process_tree(self._proc.pid, signal.SIGKILL)
                self._proc.wait()

    # -- supervision loop ----------------------------------------------
    def run(self, max_generations: Optional[int] = None) -> int:
        """Supervise until the worker exits cleanly (returns 0), restarts are
        exhausted (returns the last rc), or the world becomes infeasible
        (raises ElasticityIncompatibleWorldSize)."""
        world = self.current_world_size()
        for _ in range(10):
            if world > 0:
                break
            # startup can race the same non-atomic hostfile rewrite the
            # poll loop tolerates: give the writer a grace window before
            # declaring the hostfile genuinely unusable
            logger.warning(
                "elastic agent: hostfile %s unreadable/empty at startup; "
                "retrying in %.1fs", self.hostfile, self.monitor_interval)
            time.sleep(self.monitor_interval)
            world = self.current_world_size()
        if world <= 0:
            raise ValueError(
                f"elastic agent: no readable hosts in {self.hostfile}")
        self._proc = self._launch(world)
        generations = 1
        try:
            while True:
                rc = self._proc.poll()
                if rc is not None:
                    if rc == 0:
                        logger.info("elastic agent: worker finished cleanly")
                        return 0
                    if self.restart_count >= self.max_restarts:
                        logger.error(
                            "elastic agent: worker failed (rc=%d), restarts "
                            "exhausted (%d)", rc, self.max_restarts)
                        return rc
                    self.restart_count += 1
                    logger.warning(
                        "elastic agent: worker failed (rc=%d), restart %d/%d",
                        rc, self.restart_count, self.max_restarts)
                    self._backoff()
                    world = self.current_world_size() or world
                    self._proc = self._launch(world)
                    generations += 1
                elif self._heartbeat_stale():
                    # alive but wedged: the process neither exits nor
                    # progresses (deadlocked collective, hung storage). It
                    # already failed to die on its own — SIGKILL the tree.
                    if self.restart_count >= self.max_restarts:
                        logger.error(
                            "elastic agent: worker heartbeat stale >%.1fs but "
                            "restarts exhausted (%d); stopping",
                            self.heartbeat_timeout, self.max_restarts)
                        self._kill_hung()
                        return 1
                    self.restart_count += 1
                    logger.warning(
                        "elastic agent: worker heartbeat stale >%.1fs — "
                        "killing hung worker, restart %d/%d",
                        self.heartbeat_timeout, self.restart_count,
                        self.max_restarts)
                    self._kill_hung()
                    self._backoff()
                    world = self.current_world_size() or world
                    self._proc = self._launch(world)
                    generations += 1
                else:
                    new_world = self.current_world_size()
                    # a membership poll can race a hostfile rewrite
                    # (truncate-then-write is not atomic): 0 hosts is an
                    # unreadable snapshot, not an eviction — skip this poll
                    if new_world > 0 and new_world != world:
                        if self.restart_count >= self.max_restarts:
                            logger.error(
                                "elastic agent: membership %d -> %d but restarts "
                                "exhausted (%d); stopping",
                                world, new_world, self.max_restarts)
                            self._stop()
                            return 1
                        logger.warning(
                            "elastic agent: membership %d -> %d; restarting",
                            world, new_world)
                        self._stop()
                        self.restart_count += 1
                        self._backoff()
                        world = new_world
                        self._proc = self._launch(world)
                        generations += 1
                if max_generations is not None and generations >= max_generations:
                    rc = self._proc.wait()
                    return rc
                time.sleep(self.monitor_interval)
        finally:
            self._stop()
