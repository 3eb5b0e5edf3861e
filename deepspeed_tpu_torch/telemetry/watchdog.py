"""Recompile watchdog (the port of ``deepspeed_tpu/telemetry/watchdog.py``):
every "compilation" of a watched program becomes a telemetry event.

The serving engine's contract is a compilation contract: ONE decode program
per engine lifetime, one prefill program per bucket, one chunk program per
width. PyTorch runs eagerly and has no jit cache to count, so the port
calls a program's first call at a new abstract signature its compilation:
the shape, dtype and device of each tensor operand (numpy arrays by shape
and dtype, other operands by type). On the card that first call is also
where the serving decode program captures its CUDA graph, so a second
signature on the decode path means a second graph.

``RecompileWatchdog.watch(fn, name, stable=...)`` wraps a callable. Each
compilation is recorded with

  * the abstract signature of the call's arguments (``float32[8,128]@cpu``
    style, long argument lists elided),
  * the compiling call's wall time (which includes its first execution, and
    for the decode program the graph capture),
  * registry counters ``compile/<name>`` and histogram ``compile/wall_s``,
  * a JSONL event ``{"type": "compile", "name", "signature", "compile_s",
    "n_for_name"}``.

A path declared ``stable=True`` may compile ONCE; the second compilation
triggers the watchdog's ``mode``: ``"warn"`` logs loudly, ``"raise"``
throws ``RecompileError``, ``"off"`` only records. In raise mode a second
signature is refused BEFORE the call runs, so nothing the call would write
(the serving KV cache) is touched. Unlike the JAX version nothing escapes
the signature: there is no sharding or committedness to drift.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..utils.logging import logger
from .registry import MetricsRegistry, get_registry

_MAX_SIG_LEAVES = 8


class RecompileError(RuntimeError):
    """A compile-stable path compiled more than once."""


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _leaf_key(leaf) -> tuple:
    if torch.is_tensor(leaf):
        return (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""), str(leaf.device))
    if isinstance(leaf, np.ndarray):
        return (tuple(leaf.shape), leaf.dtype.name)
    return (type(leaf).__name__,)


def abstract_signature(args, kwargs=None, limit: int | None = _MAX_SIG_LEAVES) -> str:
    """dtype[shape]@device summary of a call's arguments; ``limit`` elides
    long argument lists for display."""
    leaves = list(_leaves((args, kwargs or {})))
    shown = leaves if limit is None else leaves[:limit]
    parts = []
    for leaf in shown:
        key = _leaf_key(leaf)
        if len(key) == 1:
            parts.append(key[0])
        else:
            sig = f"{key[1]}[{','.join(map(str, key[0]))}]"
            parts.append(sig + (f"@{key[2]}" if len(key) == 3 else ""))
    if len(leaves) > len(shown):
        parts.append(f"...+{len(leaves) - len(shown)} leaves")
    return "(" + ", ".join(parts) + ")"


def abstract_key(args, kwargs=None) -> tuple:
    """Full-fidelity hashable key over every leaf's (shape, dtype, device):
    the membership key of the signature check."""
    return tuple(_leaf_key(leaf) for leaf in _leaves((args, kwargs or {})))


class RecompileWatchdog:
    def __init__(self, registry: Optional[MetricsRegistry] = None, sink=None,
                 mode: str = "warn"):
        if mode not in ("off", "warn", "raise"):
            raise ValueError(f"watchdog mode must be off|warn|raise, got {mode!r}")
        self.registry = registry if registry is not None else get_registry()
        self.sink = sink
        self.mode = mode
        self.events: list[dict] = []  # chronological compile/refusal events
        self._watched: dict[str, dict] = {}  # name -> {stable, compiles, ...}

    # -- bookkeeping ----------------------------------------------------

    def _record(self, name: str, signature: str, compile_s: float) -> dict:
        entry = self._watched[name]
        entry["compiles"] += 1
        ev = {
            "type": "compile",
            "name": name,
            "signature": signature,
            "compile_s": compile_s,
            "n_for_name": entry["compiles"],
        }
        self.events.append(ev)
        self.registry.counter(f"compile/{name}").inc()
        self.registry.histogram("compile/wall_s").observe(compile_s)
        if self.sink is not None:
            self.sink.emit(ev)
        return ev

    def _record_refusal(self, name: str, signature: str, first: bool) -> None:
        """A refusal is not a compilation: it has its own event type and
        counter, so the compile table reports only what ran."""
        entry = self._watched[name]
        entry["refusals"] += 1
        self.registry.counter(f"refusal/{name}").inc()
        if first:  # a retried refusal raises again but logs once
            ev = {
                "type": "refusal",
                "name": name,
                "signature": signature,
                "n_refused": entry["refusals"],
            }
            self.events.append(ev)
            if self.sink is not None:
                self.sink.emit(ev)

    def _violation(self, name: str, ev: dict) -> None:
        msg = (
            f"recompile watchdog: compile-stable path {name!r} compiled "
            f"{ev['n_for_name']} times (latest signature {ev['signature']}, "
            f"{ev['compile_s']:.2f}s) — an operand's shape/dtype/device "
            "drifted on a path whose contract is ONE program")
        if self.mode == "raise":
            raise RecompileError(msg)
        if self.mode == "warn":
            logger.warning(msg)

    # -- wrapping -------------------------------------------------------

    def unique_name(self, base: str) -> str:
        """First caller gets ``base``; later callers get ``base#2``, ... —
        for engines sharing one watchdog."""
        if base not in self._watched:
            return base
        i = 2
        while f"{base}#{i}" in self._watched:
            i += 1
        return f"{base}#{i}"

    def watch(self, fn, name: str, stable: bool = False):
        """Wrap ``fn``; returns a call-transparent proxy that records every
        compilation (first call at a new signature) under ``name``.
        ``stable=True`` arms the one-compile contract. The proxy's
        ``_cache_size()`` is the number of signatures it has run, and its
        ``last_call_compiled`` says whether the latest call was a first."""
        if name in self._watched:
            raise ValueError(f"watchdog already watches a path named {name!r}")
        entry = self._watched[name] = {"stable": stable, "compiles": 0,
                                       "refusals": 0, "refused": set()}
        seen: set[tuple] = set()

        def wrapped(*args, **kwargs):
            key = abstract_key(args, kwargs)
            compiled = key not in seen
            if compiled and stable and self.mode == "raise" and entry["compiles"] >= 1:
                first = key not in entry["refused"]
                entry["refused"].add(key)
                sig = abstract_signature(args, kwargs)
                self._record_refusal(name, sig, first)
                raise RecompileError(
                    f"recompile watchdog: compile-stable path {name!r} "
                    f"refused before execution — signature {sig} would "
                    f"be compilation #{entry['compiles'] + 1} on a path "
                    "whose contract is ONE program"
                    + ("" if first else " (already-refused signature)"))
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            wrapped.last_call_compiled = compiled
            if compiled:
                seen.add(key)
                ev = self._record(name, abstract_signature(args, kwargs), dt)
                if stable and ev["n_for_name"] > 1:
                    self._violation(name, ev)
            return out

        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped._watchdog_name = name
        wrapped._wrapped = fn
        wrapped._cache_size = lambda: len(seen)
        wrapped.last_call_compiled = False
        return wrapped

    # -- reporting ------------------------------------------------------

    def compile_table(self) -> list[dict]:
        """Per-path summary: [{name, stable, compiles, refusals,
        total_compile_s, signatures}] sorted by total compile time."""
        rows = {}
        for name, entry in self._watched.items():
            rows[name] = {
                "name": name,
                "stable": entry["stable"],
                "compiles": entry["compiles"],
                "refusals": entry["refusals"],
                "total_compile_s": 0.0,
                "signatures": [],
            }
        for ev in self.events:
            if ev["type"] != "compile":
                continue
            row = rows[ev["name"]]
            row["total_compile_s"] += ev["compile_s"]
            row["signatures"].append(ev["signature"])
        return sorted(rows.values(), key=lambda r: -r["total_compile_s"])
