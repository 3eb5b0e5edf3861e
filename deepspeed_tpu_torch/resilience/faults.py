"""Deterministic, config-selected fault injection (the serving part of
``deepspeed_tpu/resilience/faults.py``, which imports no jax).

A seeded injector whose every decision is a pure function of
``(seed, site, key)``: two runs with the same config inject the same faults
at the same sites, so a recovery test is reproducible and a greedy-parity
comparison against an unfaulted run is meaningful. The port has the
``garbage_logits`` site: NaN logits for a chosen request. The serving engine
poisons the request's slot KV, so the next program attending to it
genuinely computes non-finite logits, and the per-slot sentinel computed on
the device must catch it. The JAX package's other sites (training,
checkpoint writes, the fleet's RPC, router and gateway) wait for the port
of those paths.

Two selection modes compose:

  * **deterministic lists** (``garbage_logits_uids`` + phase/step) fire
    exactly once per listed key: a requeued request is NOT re-faulted,
    modelling a transient fault rather than a permanent one;
  * **rate mode** (``rate`` in (0, 1], optionally restricted by ``sites``)
    draws per opportunity from a crc32 hash of ``(seed, site,
    #opportunity)`` — deterministic across runs, independent across
    opportunities.
"""

from __future__ import annotations

import threading
import zlib
from collections import Counter
from typing import Any


def _get(cfg: Any, name: str, default):
    if isinstance(cfg, dict):
        return cfg.get(name, default)
    return getattr(cfg, name, default)


class FaultInjector:
    """Seeded deterministic fault source. ``cfg`` is a
    ``runtime.config.FaultInjectionConfig``, a plain dict with the same
    keys, or None (disabled)."""

    def __init__(self, cfg: Any = None):
        self.enabled = bool(_get(cfg, "enabled", False)) if cfg is not None else False
        self.seed = int(_get(cfg, "seed", 0))
        self.rate = float(_get(cfg, "rate", 0.0))
        self.sites = set(_get(cfg, "sites", []) or [])
        self.garbage_logits_uids = set(_get(cfg, "garbage_logits_uids", []) or [])
        self.garbage_logits_phase = str(_get(cfg, "garbage_logits_phase", "decode"))
        self.garbage_logits_decode_step = int(_get(cfg, "garbage_logits_decode_step", 0))
        self._fired: set = set()  # list-mode keys fire exactly once
        self._lock = threading.Lock()
        self.injected: Counter = Counter()
        self.opportunities: Counter = Counter()

    def _rate_fire(self, site: str) -> bool:
        if self.rate <= 0.0 or (self.sites and site not in self.sites):
            return False
        # one independent deterministic draw per opportunity: a replayed
        # request gets a FRESH draw (its site's counter has advanced)
        n = self.opportunities[site]
        h = zlib.crc32(f"{self.seed}:{site}:{n}".encode()) & 0xFFFFFFFF
        return h / float(0x100000000) < self.rate

    def _fire(self, site: str, listed: bool, key) -> bool:
        """One fault decision. List-mode keys fire once, ever."""
        with self._lock:
            self.opportunities[site] += 1
            hit = False
            if listed:
                k = (site, key)
                if k not in self._fired:
                    self._fired.add(k)
                    hit = True
            if not hit:
                hit = self._rate_fire(site)
            if hit:
                self.injected[site] += 1
            return hit

    def garbage_logits(self, uid: int, phase: str, decode_step: int = 0) -> bool:
        """True if request ``uid`` should produce NaN logits now. ``phase``
        is ``prefill`` (at admission completion) or ``decode`` with the
        request's 0-based decode-step index."""
        if not self.enabled:
            return False
        listed = (
            uid in self.garbage_logits_uids
            and phase == self.garbage_logits_phase
            and (phase == "prefill" or decode_step == self.garbage_logits_decode_step)
        )
        return self._fire("garbage_logits", listed, (uid, phase, decode_step))

    def stats(self) -> dict:
        return {"injected": dict(self.injected), "opportunities": dict(self.opportunities)}
