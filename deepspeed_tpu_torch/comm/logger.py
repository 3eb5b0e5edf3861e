"""Collective logging: the port of ``deepspeed_tpu/comm/logger.py``
(reference ``utils/comms_logging.py:56``, hooked by ``comm/comm.py:111``).

The JAX package records (op, axis, message size) when a collective is
traced; the port's collectives run eagerly, so ``record`` runs once per
CALL. A summary here therefore counts every step's collectives, where
JAX's counts each compiled program's once. ``staged`` counts the bytes a
collective moved through a pinned host buffer because its backend cannot
take the tensor's device (gloo on CUDA tensors, ``collectives.py``).
"""

from __future__ import annotations

import warnings
from collections import defaultdict

import numpy as np

from ..ops.optimizers import tree_leaves
from ..utils.logging import logger


def _nbytes(tensor) -> int:
    """Bytes of a tensor (or of a dict/list nesting of them, summed)."""
    if hasattr(tensor, "shape") and hasattr(tensor, "dtype"):
        itemsize = getattr(tensor, "itemsize", None)
        if itemsize is None:
            itemsize = np.dtype(tensor.dtype).itemsize
        return int(np.prod(tuple(tensor.shape))) * int(itemsize)
    if isinstance(tensor, (list, tuple)):
        return sum(_nbytes(t) for t in tensor)
    if isinstance(tensor, dict):
        return sum(_nbytes(t) for t in tree_leaves(tensor))
    return 0


def _axis_label(axis) -> str:
    """One canonical spelling for an axis spec: ``"data"`` stays itself, a
    tuple/list like ``("data", "fsdp")`` becomes ``"data+fsdp"``: the SAME
    label the collective ledger uses, so the two accountings reconcile
    key-for-key."""
    if isinstance(axis, (tuple, list)):
        return "+".join(str(a) for a in axis)
    return str(axis)


class CommsLogger:
    def __init__(self):
        self.enabled = False
        self.verbose = False
        self._ops: dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0})
        self.staged_bytes = 0

    def configure(self, enabled: bool = False, verbose: bool = False, **_):
        self.enabled = enabled
        self.verbose = verbose

    def record(self, op: str, axis, tensor, staged: bool = False) -> None:
        if not self.enabled:
            return
        key = f"{op}@{_axis_label(axis)}"
        nbytes = _nbytes(tensor)
        entry = self._ops[key]
        entry["count"] += 1
        entry["bytes"] += nbytes
        # volumes also land in the process-global metrics registry so one
        # telemetry snapshot reports collectives next to step/latency metrics
        from ..telemetry.registry import get_registry

        reg = get_registry()
        reg.counter(f"comm/{key}/count").inc()
        reg.counter(f"comm/{key}/bytes").inc(nbytes)
        if staged:
            self.staged_bytes += nbytes
            reg.counter("comm/staged_bytes").inc(nbytes)
        if self.verbose:
            logger.info(f"comm: {key} msg={nbytes}B" + (" (host-staged)" if staged else ""))

    @property
    def prof_ops(self) -> dict[str, dict]:
        """DEPRECATED: poke ``summary()`` (or a telemetry snapshot) instead
        of this mutable internal store."""
        warnings.warn(
            "CommsLogger.prof_ops is deprecated; use CommsLogger.summary() "
            "or the telemetry registry snapshot (comm/<op>@<axis>/{count,bytes})",
            DeprecationWarning, stacklevel=2)
        return self._ops

    def summary(self) -> dict[str, dict]:
        """Per-op totals, ``{"op@axis": {"count": n, "bytes": b}}``, plus a
        ``"by_axis"`` roll-up (``{axis: {count, bytes}}``, told apart from
        the op entries by the absent ``@``)."""
        out = {k: dict(v) for k, v in sorted(self._ops.items())}
        if out:  # an empty logger stays {} (the documented reset contract)
            out["by_axis"] = self.axis_totals()
        return out

    def axis_totals(self) -> dict[str, dict]:
        """Per-AXIS byte/count totals across every op family."""
        out: dict[str, dict] = {}
        for key, ent in self._ops.items():
            axis = key.split("@", 1)[1] if "@" in key else key
            agg = out.setdefault(axis, {"count": 0, "bytes": 0})
            agg["count"] += ent["count"]
            agg["bytes"] += ent["bytes"]
        return {k: out[k] for k in sorted(out)}

    def reconcile(self, hlo_by_axis: dict[str, dict],
                  mesh_shape: dict | None = None) -> list[dict]:
        """Cross-check this logger's per-axis totals against the collective
        ledger's (``telemetry/collective_ledger.CollectiveLedger
        .bytes_by_axis``). Each row: {axis, host_count, host_bytes,
        hlo_count, hlo_bytes, verdict} with verdict ``ok`` |
        ``unlogged-in-host`` | ``unseen-in-hlo``; counts and bytes are
        reported, not required to match (the ledger holds one watched
        call's collectives, the logger every call's). ``mesh_shape`` (axis
        -> size) canonicalizes host labels first: size-1 axes leave tuple
        labels, the rest are put in mesh order, and an entry whose axes are
        all size 1 is skipped."""
        host = self.axis_totals()
        if mesh_shape:
            norm: dict[str, dict] = {}
            for axis, ent in host.items():
                parts = set(axis.split("+"))
                if parts <= set(mesh_shape):
                    kept = [n for n in mesh_shape if n in parts and int(mesh_shape[n]) > 1]
                    if not kept:
                        continue  # fully trivial axis: no wire traffic
                    axis = "+".join(kept)
                agg = norm.setdefault(axis, {"count": 0, "bytes": 0})
                agg["count"] += ent["count"]
                agg["bytes"] += ent["bytes"]
            host = norm
        rows = []
        for axis in sorted(set(host) | set(hlo_by_axis)):
            h = host.get(axis)
            x = hlo_by_axis.get(axis)
            if h is None:
                verdict = "unlogged-in-host"
            elif x is None:
                verdict = "unseen-in-hlo"
            else:
                verdict = "ok"
            rows.append({
                "axis": axis,
                "host_count": h["count"] if h else 0,
                "host_bytes": h["bytes"] if h else 0,
                "hlo_count": x["count"] if x else 0,
                "hlo_bytes": x["bytes"] if x else 0,
                "verdict": verdict,
            })
        return rows

    def log_all(self) -> None:
        logger.info("collective summary (per-call counts):")
        for key, entry in self.summary().items():
            if key == "by_axis":  # the roll-up, not an op entry
                continue
            logger.info(f"  {key}: count={entry['count']} volume={entry['bytes'] / 1e6:.2f} MB")

    def reset(self) -> None:
        # the mirrored registry counters reset too, or the two views one
        # snapshot reports (summary() vs comm/* counters) silently diverge
        from ..telemetry.registry import get_registry

        reg = get_registry()
        for key in self._ops:
            reg.counter(f"comm/{key}/count").value = 0.0
            reg.counter(f"comm/{key}/bytes").value = 0.0
        self._ops.clear()
        self.staged_bytes = 0


comms_logger = CommsLogger()


def get_bw(comm_op: str, size_bytes: int, duration_s: float, n_ranks: int) -> tuple[float, float]:
    """Algorithmic and bus bandwidth in GB/s (reference: utils/comms_logging.py:23)."""
    if duration_s <= 0:
        return 0.0, 0.0
    algbw = size_bytes / duration_s / 1e9
    if comm_op in ("all_reduce",):
        busbw = algbw * (2 * (n_ranks - 1) / n_ranks)
    elif comm_op in ("all_gather", "reduce_scatter", "all_to_all"):
        busbw = algbw * ((n_ranks - 1) / n_ranks)
    else:
        busbw = algbw
    return algbw, busbw
