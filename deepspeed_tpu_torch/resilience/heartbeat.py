"""Monotonic heartbeat staleness (a copy of
``deepspeed_tpu/resilience/heartbeat.py``): the verdict clock the serving
``WorkerSupervisor`` judges its workers by.

A worker touches a heartbeat FILE; the judge encodes two rules:

  * staleness is ``time.monotonic()`` elapsed between the judge's own
    observations of the file's mtime CHANGING, never ``time.time() -
    mtime``: mtime is a wall-clock stamp, and an NTP step could otherwise
    mint a false hung verdict (and a SIGKILL of a healthy worker) or
    stretch a real hang's detection;
  * until the worker's FIRST touch the clock is a startup ``grace``
    (default 10x the timeout): time to first touch includes interpreter
    boot, the CUDA context and the kernel builds.
"""

from __future__ import annotations

import os
import time


class HeartbeatJudge:
    """Staleness verdict over one heartbeat file. ``reset()`` right after
    (re)creating the file at worker launch; ``stale()`` on every
    supervision poll. ``timeout <= 0`` disarms the judge."""

    def __init__(self, path: str, timeout: float, grace: float | None = None):
        self.path = str(path)
        self.timeout = float(timeout)
        self.grace = float(grace) if grace is not None else 10.0 * self.timeout
        self._created_mtime = 0.0
        self._launch = 0.0
        self._obs = (0.0, 0.0)  # (mtime, monotonic time of the observation)

    def reset(self) -> None:
        """Start a fresh generation's clock (the file was just created)."""
        self._created_mtime = os.path.getmtime(self.path)
        self._launch = time.monotonic()
        self._obs = (self._created_mtime, self._launch)

    def stale(self) -> bool:
        if self.timeout <= 0:
            return False
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:  # deleted from under us: stale
            return True
        last_mtime, last_mono = self._obs
        if mtime != last_mtime:
            self._obs = (mtime, time.monotonic())
            return False
        if mtime == self._created_mtime:
            # never touched: still booting, on the grace clock
            return time.monotonic() - self._launch > self.grace
        return time.monotonic() - last_mono > self.timeout


__all__ = ["HeartbeatJudge"]
