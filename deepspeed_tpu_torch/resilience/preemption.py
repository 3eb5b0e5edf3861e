"""Signal-driven preemption: turn SIGTERM into a just-in-time checkpoint (a
copy of ``deepspeed_tpu/resilience/preemption.py``).

A rented GPU's eviction warning arrives as a POSIX signal (SIGTERM, with a
grace window). A handler cannot touch the device from signal context — the
interpreter may be anywhere, including inside a launch — so the guard does
the only async-signal-safe thing: it sets a flag. The engine polls the flag
at the next step *boundary* (``runtime/engine.py _resilience_pre_step``),
where ``engine.state`` is the consistent post-previous-step state, takes a
just-in-time atomic checkpoint (``preempt`` tag + durable 'latest'
repoint), and raises ``PreemptionSignal`` — the code path the fault
injector's ``preempt`` site drives, so the injected drill and a real
eviction converge on one recovery path.

``trigger()`` is the test hook: it sets the same flag without involving the
OS, for threads where installing handlers is impossible. ``install()`` is
main-thread only by POSIX rules; off the main thread it degrades to
trigger()-only with a warning instead of failing the engine.
"""

from __future__ import annotations

import signal
import threading
import weakref
from typing import Iterable, Optional

from ..utils.logging import logger

_DEFAULT_SIGNALS = ("SIGTERM", "SIGINT")


class PreemptionGuard:
    """Installable preemption flag. One guard per process is the intended
    use (the engine owns it); ``install()``/``uninstall()`` save and restore
    the previous handlers so a guard can wrap a scoped region (tests)."""

    def __init__(self, signals: Iterable[str] = _DEFAULT_SIGNALS):
        self.signal_names = [str(s) for s in signals]
        self._event = threading.Event()
        self._prev: dict[int, object] = {}
        self._installed = False
        self.signal_count = 0  # raw deliveries (a second SIGTERM just counts)
        self.last_signal: Optional[int] = None

    # -- flag ------------------------------------------------------------
    def _handler(self, signum, frame):  # async-signal context: flag only
        self.signal_count += 1
        self.last_signal = signum
        self._event.set()

    def trigger(self) -> None:
        """Test hook / programmatic preemption: set the flag without a
        signal (same consumption path as a real delivery)."""
        self._event.set()

    def pending(self) -> bool:
        """True once a preemption has been requested and not yet consumed."""
        return self._event.is_set()

    def consume(self) -> bool:
        """Atomically read-and-clear the flag. The engine calls this at the
        step boundary; clearing lets a relaunched-in-process engine reuse
        the guard without instantly re-preempting."""
        if not self._event.is_set():
            return False
        self._event.clear()
        return True

    # -- OS handlers -----------------------------------------------------
    def install(self) -> bool:
        """Install handlers for the configured signals. Returns True when
        OS handlers are live; False when only the ``trigger()`` path is
        available (non-main thread, or a name this platform lacks)."""
        if self._installed:
            return True
        installed_any = False
        for name in self.signal_names:
            signum = getattr(signal, name, None)
            if signum is None:
                logger.warning("preemption: no signal %s on this platform; skipped", name)
                continue
            try:
                self._prev[signum] = signal.signal(signum, self._handler)
                installed_any = True
            except ValueError:
                # signal.signal outside the main thread raises ValueError
                logger.warning(
                    "preemption: cannot install %s handler off the main "
                    "thread; real signals will not be caught (the trigger() "
                    "test hook and the fault injector still work)", name)
                break
            except OSError:
                # uncatchable signal (SIGKILL/SIGSTOP — config validation
                # rejects these, but a hand-built guard can reach here)
                logger.warning(
                    "preemption: %s cannot be caught; skipped", name)
        self._installed = installed_any
        return installed_any

    def uninstall(self) -> None:
        """Restore the pre-install handlers (no-op if never installed)."""
        for signum, prev in self._prev.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
        self._installed = False

    @property
    def installed(self) -> bool:
        return self._installed

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.uninstall()
        return False


# -- process-global slot (mirrors faults.py's injector slot) ----------------
# POSIX handlers are process state, so the guard must be too: engines always
# (re)claim the slot at init — a preemption-DISABLED engine evicts a dead
# predecessor's guard, whose otherwise-orphaned handler would swallow
# SIGTERM/SIGINT forever (flag set on a guard nothing consumes: no JIT
# checkpoint, no KeyboardInterrupt, until the reservation escalates to
# SIGKILL).
_active_guard: Optional[PreemptionGuard] = None
_active_owner: Optional["weakref.ref"] = None


def activate_guard(guard: PreemptionGuard, owner=None) -> bool:
    """Make ``guard`` THE process guard (uninstalling any predecessor's
    handlers first — the standard relaunch loop discards the old engine and
    the new one claims the slot). ``owner`` (weakly referenced) lets
    ``reap_orphaned_guard`` distinguish a dead owner from a live sibling.
    Returns ``guard.install()``'s verdict."""
    global _active_guard, _active_owner
    if _active_guard is not None and _active_guard is not guard:
        _active_guard.uninstall()
    _active_guard = guard
    _active_owner = weakref.ref(owner) if owner is not None else None
    return guard.install()


def deactivate_guard(guard: Optional[PreemptionGuard] = None) -> None:
    """Uninstall the active process guard (or only ``guard``, if given and
    it is the active one). Safe to call when no guard is active."""
    global _active_guard, _active_owner
    if _active_guard is not None and (guard is None or guard is _active_guard):
        _active_guard.uninstall()
        _active_guard = None
        _active_owner = None


def reap_orphaned_guard() -> None:
    """Uninstall the active guard only if its owning engine has been
    collected. A preemption-DISABLED engine calls this at init: a discarded
    predecessor's orphaned handlers are evicted (they would swallow
    SIGTERM/SIGINT into a flag nothing consumes), but a LIVE sibling's
    guard — a training engine next to an eval engine in one process — is
    left armed."""
    global _active_guard, _active_owner
    if (_active_guard is not None and _active_owner is not None
            and _active_owner() is None):
        _active_guard.uninstall()
        _active_guard = None
        _active_owner = None
